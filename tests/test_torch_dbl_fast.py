"""The redesigned doubling chains (zecale_tpu_torch/csrc/fast_kernels.cu:
K3 proj_dbl_chain and K5 jac_dbl_chain on the fast field core, one warp a
point with the products of each step side by side in groups of TPI lanes)
and the wrappers' TPI table.

Here, without a card: the CPU build of the kernels' device code
(csrc/host_check.cpp zt_cpu_fast_dbl; the 32 lanes of a warp run as
coroutines that exchange words in the order a warp's shuffles would) against the plain PyTorch
chains (k times ec/curve_torch.py proj_dbl / jac_dbl), in every form and
built TPI, and at Fq 12 and Fq 24 against the JAX package's jnp curves
(ec/curve_jax.py ProjCurve / JacCurve dbl_chain over the 8-bit fields).
Inputs, made from seeded generators: the identity (0:1:0) and (0:z:0),
Jacobian points at infinity with nonzero X and Y, random subgroup points
with Z != 1 and Z = 1; b3 = -3 (BW6-761 G1), 3 (BLS12-377 G1), 12 (BW6-761
G2) and the Fq2 twist constant.  k = 1, 6, 11 for K3 and 1, 3, 8 for K5, on
one point and on 35.  On a card (`cuda` marker): every built TPI of both
kernels against the plain versions.  Tolerance: exact -- limbs must be
equal.

The JAX references are imported inside the test that uses them, so that
the file collects on the card's machine, which has no JAX."""

import random

import numpy as np
import pytest
import torch

from zecale_tpu.ec import host_curve as hc
from zecale_tpu_torch.ec import curve_torch as ct
from zecale_tpu_torch.ec import jac_curve as jc
from zecale_tpu_torch.ec import proj_curve as pc
from zecale_tpu_torch.ff import fp_torch as ft
from zecale_tpu_torch.ff import params as P
from zecale_tpu_torch.utils import build

# One intra-op thread: the suite runs in several worker processes at
# once, and torch's OpenMP threads spinning in each of them slow every
# worker many times over (a 13 s test took 695 s with four workers).
torch.set_num_threads(1)

#: one group per kernel form: fq12, fq24, fq2
FORMS = {"fq12": ("bls12-377", False), "fq24": ("bw6-761", False),
         "fq2": ("bls12-377", True)}
CODE = {"fq12": 12, "fq24": 24, "fq2": 2}
CASES = [(form, t) for form in FORMS for t in build.ADD_TPIS[form]]
#: the chain lengths of the paths: msm8's window c = 11 and its G = 6
#: scan, the jac engine's c = 8 and the bit-serial doublings
K3_KS, K5_KS = (1, 6, 11), (1, 3, 8)
N_POINTS = 35


def _host(curve, g2):
    return hc.g2_curve(curve) if g2 else hc.g1_curve(curve)


def _subgroup_points(curve, g2, n, seed):
    """n points of the group: random multiples of the generator and a run
    of 2P + G steps from it."""
    crv = _host(curve, g2)
    gen = hc.generators(curve)[1 if g2 else 0]
    rng = random.Random(seed)
    r = P.CURVES[curve].r
    pts = [crv.mul(rng.randrange(1, r), gen) for _ in range(4)]
    p = gen
    while len(pts) < n:
        pts.append(p)
        p = crv.add(crv.dbl(p), gen)
    return pts


def _proj_inputs(curve, g2, n, seed):
    """(0:1:0), (0:z:0), then subgroup points with random Z (one with
    Z = 1): projective triples for K3."""
    H = _host(curve, g2).F
    rng = random.Random(seed)
    pts = _subgroup_points(curve, g2, n - 2, seed)

    def proj(pt, z):
        return (H.mul(pt[0], z), H.mul(pt[1], z), z)

    out = [(H.zero(), H.one(), H.zero()), (H.zero(), H.rand(rng), H.zero())]
    out.append(proj(pts[0], H.one()))
    out += [proj(pt, H.rand(rng)) for pt in pts[1:]]
    return out


def _jac_inputs(curve, g2, n, seed):
    """(0, 0, 0), two points at infinity with nonzero X and Y, then
    subgroup points with random Jacobian scale (one with Z = 1): triples
    for K5."""
    H = _host(curve, g2).F
    rng = random.Random(seed)
    pts = _subgroup_points(curve, g2, n - 3, seed)

    def jac(pt, z):
        z2 = H.sqr(z)
        return (H.mul(pt[0], z2), H.mul(pt[1], H.mul(z2, z)), z)

    out = [(H.zero(), H.zero(), H.zero())]
    out += [(H.rand(rng), H.rand(rng), H.zero()) for _ in range(2)]
    out.append(jac(pts[0], H.one()))
    out += [jac(pt, H.rand(rng)) for pt in pts[1:]]
    return out


def _to_torch(F, triples):
    flat = [c for t in triples for c in t]
    return F.pack_mont(flat).reshape(len(triples), 3, *F.shape)


def _fast_dbl(form, tpi, kind, F, a, k, b3=None):
    """The CPU build of K3 (kind 0, with b3) or K5 (kind 1) on a."""
    out = torch.empty_like(a)
    b3_buf = ct.kernel_consts(F, b3)[3] if kind == 0 else None
    rc = build.host_check_lib().zt_cpu_fast_dbl(
        CODE[form], tpi, kind, a.data_ptr(), out.data_ptr(), a.shape[0], k,
        None if b3_buf is None else b3_buf.ctypes.data)
    assert rc == 0
    return out


def _plain_chain(dbl, a, k):
    for _ in range(k):
        a = dbl(a)
    return a


@pytest.mark.parametrize("form,tpi", CASES)
def test_fast_dbl_chains_cpu_build_match_plain(form, tpi):
    """K3 and K5 built by g++ in the form and TPI of a kernel variant give
    the plain chains' limbs on one point and on 35."""
    curve, g2 = FORMS[form]
    F = ct.coord_field(curve, g2)
    b3 = ct.b3_of(curve, g2)
    a = _to_torch(F, _proj_inputs(curve, g2, N_POINTS, 11))
    for k in K3_KS:
        want = _plain_chain(lambda p: ct.proj_dbl(F, p, b3), a, k)
        assert torch.equal(_fast_dbl(form, tpi, 0, F, a, k, b3), want)
        assert torch.equal(_fast_dbl(form, tpi, 0, F, a[-1:], k, b3),
                           want[-1:])
    a = _to_torch(F, _jac_inputs(curve, g2, N_POINTS, 13))
    for k in K5_KS:
        want = _plain_chain(lambda p: ct.jac_dbl(F, p), a, k)
        assert torch.equal(_fast_dbl(form, tpi, 1, F, a, k), want)
        assert torch.equal(_fast_dbl(form, tpi, 1, F, a[-1:], k), want[-1:])


@pytest.mark.parametrize("tpi", build.ADD_TPIS["fq24"])
def test_fast_k3_bw6_g2_b3(tpi):
    """K3 over Fq 24 with b3 = 12 (BW6-761 G2): the b3 the launcher passes
    reaches every lane and every group."""
    F = ct.coord_field("bw6-761", True)
    b3 = ct.b3_of("bw6-761", True)
    assert b3 == 12
    a = _to_torch(F, _proj_inputs("bw6-761", True, 6, 17))
    for k in K3_KS:
        want = _plain_chain(lambda p: ct.proj_dbl(F, p, b3), a, k)
        assert torch.equal(_fast_dbl("fq24", tpi, 0, F, a, k, b3), want)


def _ref_pt(F8, triples):
    return {k: F8.pack([t[i] for t in triples])
            for i, k in enumerate(("x", "y", "z"))}


def _from_ref(F8, pt):
    cols = [F8.unpack(np.asarray(pt[k])) for k in ("x", "y", "z")]
    return list(zip(*cols))


def _from_torch(F, t):
    vals = F.unpack_mont(t.reshape(-1, *F.shape))
    return [tuple(vals[3 * i: 3 * i + 3]) for i in range(t.shape[0])]


@pytest.mark.parametrize("form", ["fq12", "fq24"])
def test_fast_dbl_chains_match_jnp_curves(form):
    """The kernels at the largest built TPI against the reference's jnp
    ProjCurve.dbl_chain (msm8 g1_pcurve8) and JacCurve.dbl_chain, through
    numpy."""
    import jax

    from zecale_tpu.ec import msm8 as ref_msm8
    from zecale_tpu.ec.curve_jax import JacCurve as RefJacCurve
    from zecale_tpu.ff import fp8

    curve, _ = FORMS[form]
    F = ct.coord_field(curve, False)
    b3 = ct.b3_of(curve, False)
    tpi = build.ADD_TPIS[form][-1]
    F8 = fp8.field8(P.CURVES[curve].q)
    for kind, ref, make, ks in (
            (0, ref_msm8.g1_pcurve8(curve), _proj_inputs, K3_KS),
            (1, RefJacCurve(F8), _jac_inputs, K5_KS)):
        triples = make(curve, False, N_POINTS, 19 + kind)
        a, a8 = _to_torch(F, triples), _ref_pt(ref.F, triples)
        # dbl_chain(., k) is k steps of dbl_chain(., 1): one compile
        step = jax.jit(lambda p, ref=ref: ref.dbl_chain(p, 1))
        done = 0
        for k in ks:
            while done < k:
                a8, done = step(a8), done + 1
            want = _from_ref(ref.F, a8)
            got = _fast_dbl(form, tpi, kind, F, a, k, b3)
            assert _from_torch(F, got) == want, (kind, k)


def test_dbl_tpi_table_covers_every_form_and_batch():
    """Both kernels have rows for every form; each row's TPI is one that
    fast_kernels.cu is built for (ADD_TPIS); the bounds rise to a last row
    for any batch; every n >= 1 gets a built variant."""
    assert set(build.DBL_TPI) == {"proj_dbl_chain", "jac_dbl_chain"}
    variants = build.KERNELS["fast_kernels.cu"]["variants"]
    for kernel, table in build.DBL_TPI.items():
        assert set(table) == set(FORMS)
        for form, rows in table.items():
            bounds = [bnd for bnd, _ in rows]
            assert bounds[-1] is None and None not in bounds[:-1]
            assert bounds[:-1] == sorted(bounds[:-1])
            for _, tpi in rows:
                assert tpi in build.ADD_TPIS[form] and (form, tpi) in variants
            for n in [1, 2, 35, 47, 48, 49, 1024, 65536, 1 << 20] + bounds[:-1]:
                assert build.dbl_tpi(kernel, form, n) in build.ADD_TPIS[form]


def test_dbl_wrappers_refuse_another_field_and_k0():
    """The fast kernels fix their prime at compile time: a field they were
    not built for (MNT4-298 Fq, 10 limbs) is refused before any build or
    launch; k < 1 is refused on every device."""
    F = ft.field(P.CURVES["mnt4-298"].q)
    t = torch.zeros(2, 3, F.n, dtype=torch.int32)
    with pytest.raises(ValueError, match="built for another field"):
        pc.launch_dbl("proj_dbl_chain", "zt_proj_dbl_chain", F, None, t, 3,
                      b3=3)
    with pytest.raises(ValueError, match="built for another field"):
        pc.launch_dbl("jac_dbl_chain", "zt_jac_dbl_chain", F, None, t, 3)
    G = ct.coord_field("bls12-377", False)
    p = torch.zeros(1, 3, G.n, dtype=torch.int32)
    with pytest.raises(ValueError, match="k = 0"):
        jc.jac_dbl_chain_tpi(G, p, 0, 4)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("form", sorted(FORMS))
def test_cuda_dbl_chains_every_tpi_match_plain(cuda_device, form):
    """Each built TPI of K3 and K5, and the wrappers' pick, equal the plain
    chains on the card, on one point and on 35."""
    curve, g2 = FORMS[form]
    F = ct.coord_field(curve, g2)
    b3 = ct.b3_of(curve, g2)
    for kind, make, ks in ((0, _proj_inputs, K3_KS), (1, _jac_inputs, K5_KS)):
        a = _to_torch(F, make(curve, g2, N_POINTS, 29))
        da = a.to(cuda_device)
        for k in ks:
            if kind == 0:
                want = _plain_chain(lambda p: ct.proj_dbl(F, p, b3), a, k)
                before = pc.proj_dbl_chain.launches
                got = pc.proj_dbl_chain(F, da, k, b3)
                assert pc.proj_dbl_chain.launches == before + 1
                run = lambda x, t: pc.proj_dbl_chain_tpi(  # noqa: E731
                    F, x, k, b3, t)
            else:
                want = _plain_chain(lambda p: ct.jac_dbl(F, p), a, k)
                before = jc.jac_dbl_chain.launches
                got = jc.jac_dbl_chain(F, da, k)
                assert jc.jac_dbl_chain.launches == before + 1
                run = lambda x, t: jc.jac_dbl_chain_tpi(  # noqa: E731
                    F, x, k, t)
            assert torch.equal(got.cpu(), want)
            for t in build.ADD_TPIS[form]:
                assert torch.equal(run(da, t).cpu(), want)
                assert torch.equal(run(da[-1:], t).cpu(), want[-1:])
