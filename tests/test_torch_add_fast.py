"""The redesigned add kernels' field core and group laws
(zecale_tpu_torch/csrc/field_fast.cuh, fast_kernels.cu: K2 proj_add and K4
jac_add with TPI threads per point) and the wrappers' TPI table.

Here, without a card: the CPU build of the fast core (csrc/host_check.cpp;
every carry-chain instruction as its 64-bit equivalent, and with TPI > 1
the lanes of a group as coroutines that exchange words in the order a
warp's shuffles and ballots would) against the plain PyTorch field
(ff/fp_torch.py, ff/fp2_torch.py) and group laws (ec/curve_torch.py), and
against the host field oracle of the JAX package.  Field values cover 0, 1,
p - 1, p - 2, the top bit of p, the largest canonical values of every
word count (2^(32k) - 1 and p - 2^(32k): whole lanes of ones and of zeros,
where the carries between lanes propagate) and random ones.  Group cases:
O+O, O+P, P+O, P+P, P+(-P) and distinct points with Z != 1; for K4 also
points at infinity with nonzero X and Y and P+P with different Z.  On a
card (`cuda` marker): every built (form, TPI) variant of both kernels
against the plain versions.  Tolerance: exact -- limbs must be equal.

Imports no JAX, so that it collects on the card's machine."""

import random

import numpy as np
import pytest
import torch

from zecale_tpu.ff import host_field as hf
from zecale_tpu_torch.ec import curve_torch as ct
from zecale_tpu_torch.ec import host_curve as hc
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
#: the host library's form codes, and every TPI the fast core admits
CODE = {"fq12": 12, "fq24": 24, "fq2": 2}
ALL_TPIS = {"fq12": (1, 2, 4), "fq24": (1, 2, 4, 8), "fq2": (1, 2, 4)}
CASES = [(form, t) for form, ts in ALL_TPIS.items() for t in ts]


def _values(p, rng, n):
    bits = p.bit_length()
    words = (bits + 31) // 32
    vals = [0, 1, 2, p - 1, p - 2, 1 << (bits - 1), (1 << (bits - 1)) - 1]
    vals += [(1 << (32 * k)) - 1 for k in range(1, words)]
    vals += [p - (1 << (32 * k)) for k in range(1, words)]
    return vals + [rng.randrange(p) for _ in range(n)]


def _fast_field(form, tpi, op, a, b):
    out = torch.empty_like(a)
    rc = build.host_check_lib().zt_cpu_fast_field(
        CODE[form], tpi, op, out.data_ptr(), a.data_ptr(), b.data_ptr(),
        a.shape[0])
    assert rc == 0
    return out


@pytest.mark.parametrize("form", ["fq12", "fq24"])
def test_fast_core_constants_are_the_fields(form):
    curve, _ = FORMS[form]
    F = ct.coord_field(curve, False)
    p, one, pinv, _ = ct.kernel_consts(F, 0)
    got_p = np.zeros(F.n, dtype=np.uint32)
    got_one = np.zeros(F.n, dtype=np.uint32)
    got_pinv = build.host_check_lib().zt_cpu_fast_consts(
        CODE[form], got_p.ctypes.data, got_one.ctypes.data)
    assert got_pinv == pinv
    assert np.array_equal(got_p, p) and np.array_equal(got_one, one)
    assert pc.FORM_PRIME[form] == F.p


@pytest.mark.parametrize("form,tpi", [c for c in CASES if c[0] != "fq2"])
def test_fast_field_ops_match_plain_and_host(form, tpi):
    """add, sub, neg and the Montgomery product of the fast core, limb for
    limb against fp_torch and, as values, against the host field."""
    F = ct.coord_field(FORMS[form][0], False)
    Fh = hf.PrimeField(F.p)
    rng = random.Random(7 + tpi)
    xs = _values(F.p, rng, 24 if tpi == 1 else 8)
    # every special value against every other at TPI 1, and against a
    # shuffle of the list (each value once on each side) with lanes
    ys = [rng.choice(xs) for _ in xs] if tpi > 1 else xs
    if tpi == 1:
        xs, ys = [x for x in xs for _ in ys], ys * len(xs)
    a, b = F.pack_mont(xs), F.pack_mont(ys)
    for op, plain, host in ((0, F.mul, Fh.mul), (1, F.add, Fh.add),
                            (2, F.sub, Fh.sub)):
        got = _fast_field(form, tpi, op, a, b)
        assert torch.equal(got, plain(a, b)), op
        assert F.unpack_mont(got) == [host(x, y) for x, y in zip(xs, ys)]
    got = _fast_field(form, tpi, 3, a, b)
    assert torch.equal(got, F.neg(a))


@pytest.mark.parametrize("tpi", ALL_TPIS["fq2"])
def test_fast_fq2_product_matches_plain(tpi):
    """The Fq2 field type of the fast core (Karatsuba over FqF) against
    fp2_torch and the host Fq2, element by element."""
    F = ct.coord_field("bls12-377", True)
    H = F.host
    rng = random.Random(3)
    q = F.base.p
    vals = _values(q, rng, 6)
    xs = [(v, vals[(i * 5 + 3) % len(vals)]) for i, v in enumerate(vals)]
    ys = [(vals[(i * 7 + 1) % len(vals)], v) for i, v in enumerate(vals)]
    a, b = F.pack_mont(xs), F.pack_mont(ys)
    got = _fast_field("fq2", tpi, 0, a, b)
    assert torch.equal(got, F.mul(a, b))
    assert F.unpack_mont(got) == [H.mul(x, y) for x, y in zip(xs, ys)]
    for op, plain in ((1, F.add), (2, F.sub)):
        assert torch.equal(_fast_field("fq2", tpi, op, a, b), plain(a, b))
    assert torch.equal(_fast_field("fq2", tpi, 3, a, b), F.neg(a))


def _host(curve, g2):
    return hc.g2_curve(curve) if g2 else hc.g1_curve(curve)


def _points(curve, g2, n):
    crv = _host(curve, g2)
    gen = hc.generators(curve)[1 if g2 else 0]
    pts, p = [], gen
    for _ in range(n):
        pts.append(p)
        p = crv.add(crv.dbl(p), gen)
    return pts


def _proj_pairs(curve, g2, seed):
    """Projective (x, y, z) triples for K2: O+O, O+P, P+O, P+P, P+(-P) and
    distinct points, all scaled by a random Z."""
    H = _host(curve, g2).F
    rng = random.Random(seed)
    pts = _points(curve, g2, 6)

    def proj(pt):
        z = H.rand(rng)
        return (H.mul(pt[0], z), H.mul(pt[1], z), z)

    ident = (H.zero(), H.rand(rng), H.zero())
    a, b = pts[0], pts[1]
    neg_a = (a[0], H.neg(a[1]))
    lhs = [ident, ident, proj(a), proj(a), proj(a), proj(b), proj(pts[2])]
    rhs = [ident, proj(b), ident, proj(a), proj(neg_a), proj(pts[3]),
           proj(pts[4])]
    return lhs, rhs


def _jac_pairs(curve, g2, seed):
    """Jacobian triples for K4: O+O, O+P and P+O with nonzero X and Y at
    infinity, P+P with one triple and with different Z, P+(-P), distinct
    points."""
    H = _host(curve, g2).F
    rng = random.Random(seed)
    pts = _points(curve, g2, 6)

    def jac(pt, z=None):
        z = H.rand(rng) if z is None else z
        z2 = H.sqr(z)
        return (H.mul(pt[0], z2), H.mul(pt[1], H.mul(z2, z)), z)

    def inf():
        return (H.rand(rng), H.rand(rng), H.zero())

    zero = (H.zero(), H.zero(), H.zero())
    a, b = pts[0], pts[1]
    neg_a = (a[0], H.neg(a[1]))
    za = H.rand(rng)
    lhs = [zero, inf(), jac(a), jac(a, za), jac(a), jac(a), jac(b),
           jac(pts[2])]
    rhs = [zero, jac(b), inf(), jac(a, za), jac(a), jac(neg_a),
           jac(pts[3]), jac(pts[4])]
    return lhs, rhs


def _to_torch(F, triples):
    flat = [c for t in triples for c in t]
    return F.pack_mont(flat).reshape(len(triples), 3, *F.shape)


def _fast_add(form, tpi, kind, F, a, b, b3):
    out = torch.empty_like(a)
    b3_buf = ct.kernel_consts(F, b3)[3] if kind == 0 else None
    rc = build.host_check_lib().zt_cpu_fast_add(
        CODE[form], tpi, kind, a.data_ptr(), b.data_ptr(), out.data_ptr(),
        a.shape[0], None if b3_buf is None else b3_buf.ctypes.data)
    assert rc == 0
    return out


@pytest.mark.parametrize("form,tpi", CASES)
def test_fast_k2_k4_laws_cpu_build_match_plain(form, tpi):
    """curve.cuh's proj_add and jac_add over the fast field type, built by
    g++ in the form and TPI of a kernel variant, give the plain versions'
    limbs on every case of the laws."""
    curve, g2 = FORMS[form]
    F = ct.coord_field(curve, g2)
    b3 = ct.b3_of(curve, g2)
    lhs, rhs = _proj_pairs(curve, g2, 11 + tpi)
    a, b = _to_torch(F, lhs), _to_torch(F, rhs)
    assert torch.equal(_fast_add(form, tpi, 0, F, a, b, b3),
                       ct.proj_add(F, a, b, b3))
    lhs, rhs = _jac_pairs(curve, g2, 13 + tpi)
    a, b = _to_torch(F, lhs), _to_torch(F, rhs)
    assert torch.equal(_fast_add(form, tpi, 1, F, a, b, None),
                       ct.jac_add(F, a, b))


def test_fast_k2_twist_and_bw6_g2_b3():
    """K2 over Fq 24 with b3 = 12 (BW6-761 G2) and over Fq2 with the twist
    constant, at TPI 2: the b3 the launcher passes reaches every lane."""
    for curve, g2, form in (("bw6-761", True, "fq24"),
                            ("bls12-377", True, "fq2")):
        F = ct.coord_field(curve, g2)
        b3 = ct.b3_of(curve, g2)
        lhs, rhs = _proj_pairs(curve, g2, 5)
        a, b = _to_torch(F, lhs), _to_torch(F, rhs)
        assert torch.equal(_fast_add(form, 2, 0, F, a, b, b3),
                           ct.proj_add(F, a, b, b3))


def test_add_tpi_table_covers_every_form_and_batch():
    """Both kernels have rows for every form; each TPI is built and
    admitted by the core (it divides N with at least three words a lane),
    at most two a form; the bounds rise to a last row for any batch; every
    n >= 1 gets a built variant."""
    assert set(build.ADD_TPI) == {"proj_add", "jac_add"}
    variants = build.KERNELS["fast_kernels.cu"]["variants"]
    assert set(build.ADD_TPIS) == set(build.FORMS) == set(FORMS)
    for form, tpis in build.ADD_TPIS.items():
        assert 1 <= len(tpis) <= 2
        for t in tpis:
            assert t in ALL_TPIS[form] and (form, t) in variants
    for kernel, table in build.ADD_TPI.items():
        assert set(table) == set(FORMS)
        for form, rows in table.items():
            bounds = [bnd for bnd, _ in rows]
            assert bounds[-1] is None and None not in bounds[:-1]
            assert bounds[:-1] == sorted(bounds[:-1])
            for n in [1, 2, 3, 105, 4095, 4096, 4097, 16384, 16385, 49152,
                      1182721, 1 << 24] + bounds[:-1]:
                assert build.add_tpi(kernel, form, n) in build.ADD_TPIS[form]


def test_add_wrappers_refuse_another_field():
    """The fast kernels fix their prime at compile time: a field that is
    not one they were built for (MNT4-298 Fq, 10 limbs) is refused before
    any build or launch."""
    F = ft.field(P.CURVES["mnt4-298"].q)
    t = torch.zeros(2, 3, F.n, dtype=torch.int32)
    with pytest.raises(ValueError, match="built for another field"):
        pc.launch_add("proj_add", "zt_proj_add", F, None, t, t, b3=3)
    with pytest.raises(ValueError, match="differ"):
        pc.launch_add("jac_add", "zt_jac_add", F, None, t, t[:1])


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("form", sorted(FORMS))
def test_cuda_add_kernels_every_tpi_match_plain(cuda_device, form):
    """Each built TPI variant of K2 and K4, and the wrappers' pick, equal
    the plain versions on the crafted cases on the card."""
    curve, g2 = FORMS[form]
    F = ct.coord_field(curve, g2)
    b3 = ct.b3_of(curve, g2)
    lhs, rhs = _proj_pairs(curve, g2, 41)
    a, b = _to_torch(F, lhs), _to_torch(F, rhs)
    da, db = a.to(cuda_device), b.to(cuda_device)
    want = ct.proj_add(F, a, b, b3)
    before = pc.proj_add.launches
    assert torch.equal(pc.proj_add(F, da, db, b3).cpu(), want)
    assert pc.proj_add.launches == before + 1
    for t in build.ADD_TPIS[form]:
        assert torch.equal(pc.proj_add_tpi(F, da, db, b3, t).cpu(), want)
    lhs, rhs = _jac_pairs(curve, g2, 43)
    a, b = _to_torch(F, lhs), _to_torch(F, rhs)
    da, db = a.to(cuda_device), b.to(cuda_device)
    want = ct.jac_add(F, a, b)
    assert torch.equal(jc.jac_add(F, da, db).cpu(), want)
    for t in build.ADD_TPIS[form]:
        assert torch.equal(jc.jac_add_tpi(F, da, db, t).cpu(), want)
