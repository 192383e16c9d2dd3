"""The msm8 engine's group law (zecale_tpu_torch/ec/proj_curve.py: K2
proj_add, K3 proj_dbl_chain) on the CPU, where the wrappers take their
plain versions, against the reference's jnp complete projective law
(ec/msm8.py g1_pcurve8 / g2_pcurve8, ec/curve_jax.py:ProjCurve .add / .dbl)
for BLS12-377 G1, BW6-761 G1 and G2 and BLS12-377 G2 (Fq2); and the CPU
build of the bucket reduce's device code (csrc/curve.cuh proj_add over
csrc/field_fast.cuh, as K1 runs it) against the plain versions.  Inputs
cover O+O, O+P, P+O, P+P, P+(-P) and Z != 1.
Tolerance: exact -- the projective coordinates themselves must be equal,
not only the affine points."""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zecale_tpu.ec import host_curve as hc
from zecale_tpu.ec import msm8 as ref_msm8
from zecale_tpu_torch.ec import curve_torch as ct
from zecale_tpu_torch.ec import proj_curve as pc
from zecale_tpu_torch.utils import build

# One intra-op thread: the suite runs in several worker processes at
# once, and torch's OpenMP threads spinning in each of them slow every
# worker many times over (a 13 s test took 695 s with four workers).
torch.set_num_threads(1)

GROUPS = [("bls12-377", False), ("bw6-761", False), ("bw6-761", True),
          ("bls12-377", True)]


def _host(curve, g2):
    return hc.g2_curve(curve) if g2 else hc.g1_curve(curve)


def _pairs(curve, g2, seed):
    """(lhs, rhs) lists of host projective triples (x, y, z) over the
    group's coordinate field: O+O, O+P, P+O, P+P, P+(-P), and sums of
    distinct points, all with random Z != 1 except the identities."""
    crv = _host(curve, g2)
    H = crv.F
    gen = hc.generators(curve)[1 if g2 else 0]
    pts = [gen]
    for _ in range(5):
        pts.append(crv.add(pts[-1], gen))
    rng = random.Random(seed)
    ident = (H.zero(), H.one(), H.zero())

    def proj(pt):
        z = H.rand(rng)
        return (H.mul(pt[0], z), H.mul(pt[1], z), z)

    a, b, c = (proj(p) for p in pts[:3])
    lhs = [ident, ident, a, a, a, b, proj(pts[3]), proj(pts[4])]
    rhs = [ident, b, ident, proj(pts[0]), proj(crv.neg(pts[0])), c,
           proj(pts[5]), proj(pts[1])]
    return lhs, rhs


def _to_torch(F, triples):
    flat = [c for t in triples for c in t]
    return F.pack_mont(flat).reshape(len(triples), 3, *F.shape)


def _from_torch(F, t):
    vals = F.unpack_mont(t.reshape(-1, *F.shape))
    return [tuple(vals[3 * i: 3 * i + 3]) for i in range(t.shape[0])]


def _to_jnp(crv8, triples):
    F8 = crv8.F
    return {k: jnp.asarray(F8.pack([t[i] for t in triples]))
            for i, k in enumerate(("x", "y", "z"))}


def _from_jnp(crv8, pt):
    F8 = crv8.F
    cols = [F8.unpack(np.asarray(pt[k])) for k in ("x", "y", "z")]
    return list(zip(*cols))


@pytest.mark.parametrize("curve,g2", GROUPS)
def test_plain_k2_k3_match_jnp_proj_curve(curve, g2):
    crv8 = (ref_msm8.g2_pcurve8 if g2 else ref_msm8.g1_pcurve8)(curve)
    crv = pc.ProjCurve(curve, g2)
    lhs, rhs = _pairs(curve, g2, 3 + 2 * g2)
    a, b = _to_torch(crv.F, lhs), _to_torch(crv.F, rhs)
    a8, b8 = _to_jnp(crv8, lhs), _to_jnp(crv8, rhs)
    assert _from_torch(crv.F, a) == _from_jnp(crv8, a8)

    got = crv.add(a, b)
    assert _from_torch(crv.F, got) == _from_jnp(crv8, crv8.add(a8, b8))
    assert _from_torch(crv.F, crv.dbl(a)) == _from_jnp(crv8, crv8.dbl(a8))
    # and the affine values are the host curve's
    host = _host(curve, g2)

    def aff(t):
        x, y, z = t
        H = host.F
        return None if H.is_zero(z) else (H.mul(x, H.inv(z)),
                                          H.mul(y, H.inv(z)))

    want = [host.add(aff(p), aff(q)) for p, q in zip(lhs, rhs)]
    assert crv.to_affine_host(got) == want


@pytest.mark.parametrize("curve,g2", GROUPS)
def test_kernel_device_code_cpu_build_matches_plain(curve, g2):
    """csrc/curve.cuh's proj_add as K1 runs it (reduce_segment over the
    fast field core, projective inputs, built by g++ with the warp's lanes
    as coroutines, in the form of the group): the sums of the segments
    [a_i, b_i] give the plain version's limbs, (O + a_i) + b_i.  K2's and
    K3's device code are checked in test_torch_add_fast.py and
    test_torch_dbl_fast.py."""
    crv = pc.ProjCurve(curve, g2)
    F, b3 = crv.F, crv.b3
    lhs, rhs = _pairs(curve, g2, 11)
    a, b = _to_torch(F, lhs), _to_torch(F, rhs)
    n = a.shape[0]
    pts = torch.cat([a, b])
    ent = torch.stack([torch.arange(n), torch.arange(n, 2 * n)], 1)
    ent = (ent.reshape(-1) * 2).to(torch.int32)
    seg = torch.arange(0, 2 * n + 1, 2, dtype=torch.int32)
    form = ct.form_of(F)
    out = torch.empty_like(a)
    rc = build.host_check_lib().zt_cpu_fast_reduce(
        {"fq12": 12, "fq24": 24, "fq2": 2}[form],
        build.sum_tpi("bucket_reduce", form, ent.numel()), 0, pts.data_ptr(),
        ent.data_ptr(), seg.data_ptr(), n, out.data_ptr(),
        ct.kernel_consts(F, b3)[3].ctypes.data)
    assert rc == 0
    ident = crv.identity_like(a)
    assert torch.equal(out, pc.proj_add(F, pc.proj_add(F, ident, a, b3), b,
                                        b3))


@pytest.mark.parametrize("curve,g2", [("bls12-377", False),
                                      ("bls12-377", True)])
def test_dbl_chain_equals_repeated_dbl(curve, g2):
    crv = pc.ProjCurve(curve, g2)
    lhs, _ = _pairs(curve, g2, 5)
    a = _to_torch(crv.F, lhs[:4])
    assert crv.dbl_chain(a, 0) is a
    rep = a
    for k in (1, 2, 3):
        rep = crv.dbl(rep)
        assert torch.equal(crv.dbl_chain(a, k), rep)
    host = _host(curve, g2)
    gen = hc.generators(curve)[1 if g2 else 0]
    xy, inf = ct.pack_affine(crv.F, [gen, None], "cpu")
    got = crv.to_affine_host(crv.dbl_chain(crv.from_affine(xy, inf), 3))
    assert got == [host.mul(8, gen), None]


def test_glue_mask_select_identity():
    crv = pc.ProjCurve("bls12-377", True)
    gen = hc.generators("bls12-377")[1]
    xy, inf = ct.pack_affine(crv.F, [gen, None, gen], "cpu")
    pts = crv.from_affine(xy, inf)
    assert crv.to_affine_host(pts) == [gen, None, gen]
    keep = torch.tensor([True, True, False])
    assert crv.to_affine_host(crv.mask(pts, keep)) == [gen, None, None]
    ident = crv.identity_like(pts)
    assert torch.equal(crv.select(~keep, ident, pts)[:2], pts[:2])
    # P + O is P up to the projective scale the complete law applies
    assert crv.to_affine_host(crv.add(pts, ident)) == [gen, None, gen]
    with pytest.raises(ValueError):
        pc.proj_dbl_chain(crv.F, pts, 0, crv.b3)
