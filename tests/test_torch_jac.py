"""The Jacobian engine's group law (zecale_tpu_torch/ec/jac_curve.py: K4
jac_add, K5 jac_dbl_chain, K6 aff_add, and add_mixed as K4 on the lifted
point) on the CPU, where the wrappers take their plain versions, against
the jnp unified law ec/curve_jax.py:JacCurve over the 8-bit fields
(ff/fp8.field8, ec/msm8.Fp28TPU) for BLS12-377 G1, BW6-761 G1 and G2 and
BLS12-377 G2 (Fq2), and against the host curve; the Pallas kernels they
replace are the second reference, in tests/test_torch_jac_pallas.py.  Then
the CPU build of the kernels' device code (csrc/curve.cuh) against the
plain versions, limb for limb, and the kernels themselves on a card.

Cases: O+O, O+P and P+O (a point at infinity with nonzero X and Y, which
the reference carries through as it stands), P+P with the same and with
different Z (lambda^2 X, lambda^3 Y, lambda Z), P+(-P), sums of distinct
points with random Z; doublings of infinity and of points; affine sums
with each infinity flag, P = Q and P = -Q.  Tolerance: exact -- the
Jacobian triples themselves must be equal as field values, not only the
affine points.  The JAX references are imported inside the tests that use
them, so that the file collects on the card's machine, which has no JAX,
and runs its `cuda` test there."""

import random

import numpy as np
import pytest
import torch

from zecale_tpu.ec import host_curve as hc
from zecale_tpu.ff import params as P
from zecale_tpu_torch.ec import curve_torch as ct
from zecale_tpu_torch.ec import jac_curve as jc
from zecale_tpu_torch.utils import build

# One intra-op thread: the suite runs in several worker processes at
# once, and torch's OpenMP threads spinning in each of them slow every
# worker many times over (a 13 s test took 695 s with four workers).
torch.set_num_threads(1)

GROUPS = [("bls12-377", False), ("bw6-761", False), ("bw6-761", True),
          ("bls12-377", True)]
#: one group per kernel form: fq12, fq24, fq2
FORMS = [("bls12-377", False), ("bw6-761", False), ("bls12-377", True)]


def _host(curve, g2):
    return hc.g2_curve(curve) if g2 else hc.g1_curve(curve)


def _ref_field(curve, g2):
    from zecale_tpu.ec.msm8 import Fp28TPU
    from zecale_tpu.ff import fp8

    q = P.CURVES[curve].q
    if g2 and P.CURVES[curve].g2_degree == 2:
        return Fp28TPU(q, P.BLS12_377_FQ2_QNR)
    return fp8.field8(q)


def _points(curve, g2, n):
    crv = _host(curve, g2)
    gen = hc.generators(curve)[1 if g2 else 0]
    pts, p = [], gen
    for _ in range(n):
        pts.append(p)
        p = crv.add(crv.dbl(p), gen)
    return pts


def _jac_pairs(curve, g2, seed):
    """(lhs, rhs) host Jacobian triples covering every case of the law."""
    H = _host(curve, g2).F
    rng = random.Random(seed)
    pts = _points(curve, g2, 8)

    def nz():
        z = H.rand(rng)
        return z if not H.is_zero(z) else H.one()

    def jac(pt, z=None):
        z = nz() if z is None else z
        z2 = H.sqr(z)
        return (H.mul(pt[0], z2), H.mul(pt[1], H.mul(z2, z)), z)

    def inf():  # X and Y need not be zero at infinity
        return (H.rand(rng), H.rand(rng), H.zero())

    zero = (H.zero(), H.zero(), H.zero())
    a, b = pts[0], pts[1]
    neg_a = (a[0], H.neg(a[1]))
    za = nz()
    lhs = [zero, inf(), inf(), jac(a), jac(a, za), jac(a, za), jac(a),
           jac(b), jac(pts[2]), jac(pts[3]), jac(pts[4]), inf()]
    rhs = [zero, jac(b), inf(), inf(), jac(a), jac(a, za), jac(neg_a),
           jac(neg_a, H.one()), jac(pts[5]), jac(pts[6]), jac(pts[7]),
           zero]
    return lhs, rhs


def _aff_pairs(curve, g2, seed):
    """((x, y), inf) operand lists for K6: each infinity flag (with
    nonzero x, y), P = Q, P = -Q and distinct points."""
    H = _host(curve, g2).F
    rng = random.Random(seed)
    pts = _points(curve, g2, 7)
    a = pts[0]
    neg_a = (a[0], H.neg(a[1]))
    garbage = (H.rand(rng), H.rand(rng))
    lhs = [(garbage, True), (garbage, True), (a, False), (a, False),
           (a, False), (pts[1], False), (pts[2], False), (pts[3], False),
           ((H.zero(), H.zero()), True), (pts[4], False)]
    rhs = [(pts[1], False), (garbage, True), (garbage, True), (a, False),
           (neg_a, False), (pts[5], False), (pts[6], False), (pts[1], False),
           ((H.zero(), H.zero()), True), (pts[4], False)]
    return lhs, rhs


def _to_torch(F, triples):
    flat = [c for t in triples for c in t]
    return F.pack_mont(flat).reshape(len(triples), -1, *F.shape)


def _aff_to_torch(F, ops):
    xy = _to_torch(F, [pt for pt, _ in ops])
    return xy, torch.tensor([i for _, i in ops])


def _from_torch(F, t):
    vals = F.unpack_mont(t.reshape(-1, *F.shape))
    return [tuple(vals[3 * i: 3 * i + 3]) for i in range(t.shape[0])]


def _ref_pt(F8, triples):
    return {k: F8.pack([t[i] for t in triples])
            for i, k in enumerate(("x", "y", "z"))}


def _ref_aff(F8, ops):
    import jax.numpy as jnp

    return {"x": F8.pack([pt[0] for pt, _ in ops]),
            "y": F8.pack([pt[1] for pt, _ in ops]),
            "inf": jnp.asarray([i for _, i in ops])}


def _from_ref(F8, pt):
    cols = [F8.unpack(np.asarray(pt[k])) for k in ("x", "y", "z")]
    return list(zip(*cols))


@pytest.mark.parametrize("curve,g2", GROUPS)
def test_plain_jac_law_matches_jnp_jac_curve(curve, g2):
    from zecale_tpu.ec.curve_jax import JacCurve as RefJacCurve

    F8 = _ref_field(curve, g2)
    ref = RefJacCurve(F8)
    crv = jc.JacCurve(curve, g2)
    F = crv.F
    lhs, rhs = _jac_pairs(curve, g2, 3 + 2 * g2)
    a, b = _to_torch(F, lhs), _to_torch(F, rhs)
    a8, b8 = _ref_pt(F8, lhs), _ref_pt(F8, rhs)

    # K4
    assert _from_torch(F, crv.add(a, b)) == _from_ref(F8, ref.add(a8, b8))
    # K5, once and chained
    assert _from_torch(F, crv.dbl(a)) == _from_ref(F8, ref.dbl(a8))
    want = a8
    for _ in range(3):
        want = ref.dbl(want)
    assert _from_torch(F, crv.dbl_chain(a, 3)) == _from_ref(F8, want)

    # add_mixed (K4 on the lifted point) and K6
    l_ops, r_ops = _aff_pairs(curve, g2, 7 + g2)
    xy_a, inf_a = _aff_to_torch(F, l_ops)
    xy_b, inf_b = _aff_to_torch(F, r_ops)
    aff_a, aff_b = _ref_aff(F8, l_ops), _ref_aff(F8, r_ops)
    z_one = F8.one_mont_elem()
    n = len(l_ops)
    assert (_from_torch(F, crv.add_mixed(a[:n], xy_b, inf_b))
            == _from_ref(F8, ref.add_mixed(
                {k: v[:n] for k, v in a8.items()}, aff_b, z_one)))
    assert (_from_torch(F, crv.add_affine_affine(xy_a, inf_a, xy_b, inf_b))
            == _from_ref(F8, ref.add_affine_affine(aff_a, aff_b, z_one)))


@pytest.mark.parametrize("curve,g2", FORMS)
def test_jac_law_affine_values_match_host_curve(curve, g2):
    crv = jc.JacCurve(curve, g2)
    host = _host(curve, g2)
    lhs, rhs = _jac_pairs(curve, g2, 17)
    a, b = _to_torch(crv.F, lhs), _to_torch(crv.F, rhs)
    got = crv.to_affine_host(crv.add(a, b))
    assert got == [host.add(p, q) for p, q in
                   zip(crv.to_affine_host(a), crv.to_affine_host(b))]
    l_ops, r_ops = _aff_pairs(curve, g2, 19)
    xy_a, inf_a = _aff_to_torch(crv.F, l_ops)
    xy_b, inf_b = _aff_to_torch(crv.F, r_ops)
    got = crv.to_affine_host(crv.add_affine_affine(xy_a, inf_a, xy_b, inf_b))
    want = [host.add(None if i else p, None if j else q)
            for (p, i), (q, j) in zip(l_ops, r_ops)]
    assert got == want


def _cpu_jac(F, op, a, b=None, k=0):
    """curve.cuh's jac_add (op 0) or k jac_dbl (op 1) over field.cuh's
    types, built by g++."""
    form = 2 if len(F.shape) == 2 else F.n
    p, one, pinv, _ = ct.kernel_consts(F, 0)
    lead = a.shape[0]
    out = torch.empty(lead, 3, *F.shape, dtype=torch.int32)
    rc = build.host_check_lib().zt_cpu_jac(
        form, op, a.data_ptr(), None if b is None else b.data_ptr(),
        out.data_ptr(), lead, k, p.ctypes.data, one.ctypes.data, pinv)
    assert rc == 0
    return out


def _cpu_aff_add(F, xy_a, inf_a, xy_b, inf_b):
    """K6's CPU build (the fast core) in the form and threads per point the
    wrapper would pick; the lanes of a warp run as coroutines."""
    form = ct.form_of(F)
    tpi = build.sum_tpi("aff_add", form, xy_a.shape[0])
    out = torch.empty(xy_a.shape[0], 3, *F.shape, dtype=torch.int32)
    rc = build.host_check_lib().zt_cpu_fast_aff_add(
        {"fq12": 12, "fq24": 24, "fq2": 2}[form], tpi, xy_a.data_ptr(),
        inf_a.data_ptr(), xy_b.data_ptr(), inf_b.data_ptr(), out.data_ptr(),
        xy_a.shape[0])
    assert rc == 0
    return out


@pytest.mark.parametrize("curve,g2", FORMS)
def test_kernel_device_code_cpu_build_matches_plain(curve, g2):
    """csrc/curve.cuh's jac_add and jac_dbl, built by g++ for the field
    form of the group, and K6's device code (aff_add over the fast field
    core, as fast_kernels.cu builds it), give the plain versions' limbs."""
    crv = jc.JacCurve(curve, g2)
    F = crv.F
    lhs, rhs = _jac_pairs(curve, g2, 23)
    a, b = _to_torch(F, lhs), _to_torch(F, rhs)
    assert torch.equal(_cpu_jac(F, 0, a, b), jc.jac_add(F, a, b))
    for k in (1, 3):
        assert torch.equal(_cpu_jac(F, 1, a, k=k), jc.jac_dbl_chain(F, a, k))
    l_ops, r_ops = _aff_pairs(curve, g2, 29)
    xy_a, inf_a = _aff_to_torch(F, l_ops)
    xy_b, inf_b = _aff_to_torch(F, r_ops)
    assert torch.equal(_cpu_aff_add(F, xy_a, inf_a, xy_b, inf_b),
                       jc.aff_add(F, xy_a, inf_a, xy_b, inf_b))


def test_glue_mask_select_tree_reduce():
    crv = jc.JacCurve("bls12-377", False)
    host = _host("bls12-377", False)
    pts = _points("bls12-377", False, 5)
    xy, inf = ct.pack_affine(crv.F, pts, "cpu")
    jac = crv.lift(xy, inf)
    assert crv.to_affine_host(jac) == pts
    keep = torch.tensor([True, False, True, False, True])
    masked = crv.mask(jac, keep)
    assert torch.equal(masked[:, :2], jac[:, :2])  # X, Y kept at infinity
    assert ct.is_zero(crv.F, masked[:, 2]).tolist() == [
        False, True, False, True, False]
    assert torch.equal(crv.select(keep, masked, jac), jac)
    want = None
    for p in (pts[0], pts[2], pts[4]):
        want = host.add(want, p)
    assert crv.to_affine_host(crv.tree_reduce(masked)) == [want]
    with pytest.raises(ValueError):
        jc.jac_dbl_chain(crv.F, jac, 0)
    with pytest.raises(ValueError):
        jc.JacCurve("mnt4-298", False)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("curve,g2", FORMS)
def test_cuda_k4_k5_k6_match_plain(cuda_device, curve, g2):
    F = jc.JacCurve(curve, g2).F
    lhs, rhs = _jac_pairs(curve, g2, 31)
    a, b = _to_torch(F, lhs), _to_torch(F, rhs)
    da, db = a.to(cuda_device), b.to(cuda_device)
    assert torch.equal(jc.jac_add(F, da, db).cpu(), jc.jac_add(F, a, b))
    for k in (1, 3, 8):
        assert torch.equal(jc.jac_dbl_chain(F, da, k).cpu(),
                           jc.jac_dbl_chain(F, a, k))
    l_ops, r_ops = _aff_pairs(curve, g2, 37)
    xy_a, inf_a = _aff_to_torch(F, l_ops)
    xy_b, inf_b = _aff_to_torch(F, r_ops)
    got = jc.aff_add(F, xy_a.to(cuda_device), inf_a.to(cuda_device),
                     xy_b.to(cuda_device), inf_b.to(cuda_device))
    assert torch.equal(got.cpu(), jc.aff_add(F, xy_a, inf_a, xy_b, inf_b))
