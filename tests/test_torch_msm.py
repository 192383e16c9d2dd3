"""The port's MSM (zecale_tpu_torch/ec/msm.py) on the CPU, where the
bucket-reduce wrapper takes its plain version, against the host curve for
BW6-761 G1/G2 (edge scalars and infinity as tests/test_msm4.py:87), and
the CPU build of the kernel's device code (csrc/curve.cuh over
csrc/field_fast.cuh) against that plain version.  Tolerance: exact."""

import numpy as np
import pytest
import torch

from zecale_tpu.ec import host_curve as hc
from zecale_tpu.ff import params as P
from zecale_tpu_torch.ec import curve_torch as ct
from zecale_tpu_torch.ec import msm
from zecale_tpu_torch.ff.fp_torch import field
from zecale_tpu_torch.utils import build

# One intra-op thread: the suite runs in several worker processes at
# once, and torch's OpenMP threads spinning in each of them slow every
# worker many times over (a 13 s test took 695 s with four workers).
torch.set_num_threads(1)


def _curve(curve, g2):
    return hc.g2_curve(curve) if g2 else hc.g1_curve(curve)


def _points(curve, g2, n):
    crv = _curve(curve, g2)
    pt = hc.generators(curve)[1 if g2 else 0]
    out = []
    for _ in range(n):
        out.append(pt)
        pt = crv.dbl(pt)
    return out


def _host_msm(curve, g2, scalars, pts):
    crv = _curve(curve, g2)
    acc = None
    for s, p in zip(scalars, pts):
        if p is not None and s:
            acc = crv.add(acc, crv.mul(s, p))
    return acc


def _scalars(r, n, seed):
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 1 << 62, size=(n, 7), dtype=np.int64)
    return [int(sum(int(w) << (62 * i) for i, w in enumerate(row))) % r
            for row in words]


def _run(curve, g2, scalars, pts):
    F = ct.base_field(curve)
    r = P.CURVES[curve].r
    xy, inf = ct.pack_affine(F, pts, "cpu")
    return msm.msm(curve, g2, field(r).pack(scalars), xy, inf)


@pytest.mark.parametrize("g2", [False, True])
def test_msm_bw6_matches_host_with_edges(g2):
    curve = "bw6-761"
    r = P.CURVES[curve].r
    n = 40
    pts = _points(curve, g2, n)
    pts[3] = None  # infinity input
    scalars = _scalars(r, n, 11 + g2)
    scalars[:8] = [0, 1, r - 1, 12345, 1, 2, r // 2, 0]
    assert _run(curve, g2, scalars, pts) == _host_msm(curve, g2, scalars,
                                                      pts)


def test_msm_bls12_bit_heavy_matches_host():
    """Witness-like scalars (mostly 0/1) flood bucket 1 of window 0: the
    run is longer than SEG and is summed over two kernel levels."""
    curve = "bls12-377"
    r = P.CURVES[curve].r
    n = 120
    pts = _points(curve, False, n)
    rng = np.random.default_rng(3)
    roll = rng.random(n)
    full = _scalars(r, n, 4)
    scalars = [1 if u < 0.6 else 0 if u < 0.8 else s
               for u, s in zip(roll, full)]
    assert sum(s == 1 for s in scalars) > 2 * msm.SEG
    assert _run(curve, False, scalars, pts) == _host_msm(curve, False,
                                                         scalars, pts)


def test_signed_digits_recompose():
    r = P.BW6_761_R
    scalars = _scalars(r, 64, 5) + [0, 1, r - 1]
    for c in (4, 6, 10):
        b, s = msm.signed_digits(field(r).pack(scalars), r.bit_length(), c)
        assert int(b.max()) <= 1 << (c - 1)
        d = (b * (1 - 2 * s)).tolist()
        got = [sum(d[w][i] << (c * w) for w in range(len(d)))
               for i in range(len(scalars))]
        assert got == scalars


def _segments_case(curve, g2, seed):
    F = ct.coord_field(curve, g2)
    D = 24
    pts = _points(curve, g2, D)
    xy, _ = ct.pack_affine(F, pts, "cpu")
    rng = np.random.default_rng(seed)
    segs = [[], [4], [6, 6], [8, 9, 10], [12] * 5, [14, 15], []]
    for _ in range(30):
        k = int(rng.integers(1, msm.SEG + 1))
        segs.append([int(v) for v in rng.integers(0, 2 * D, size=k)])
    ent = torch.tensor([e for s in segs for e in s], dtype=torch.int32)
    seg = torch.tensor(np.cumsum([0] + [len(s) for s in segs]),
                       dtype=torch.int32)
    return F, pts, xy, ent, seg, segs


def _cpu_kernel(F, pts, ent, seg, b3, affine):
    """K1's CPU build (the fast core, csrc/host_check.cpp) in the form and
    threads per segment the wrapper would pick."""
    out = torch.empty((seg.numel() - 1, 3, *F.shape), dtype=torch.int32)
    form = ct.form_of(F)
    tpi = build.sum_tpi("bucket_reduce", form, ent.numel())
    rc = build.host_check_lib().zt_cpu_fast_reduce(
        {"fq12": 12, "fq24": 24, "fq2": 2}[form], tpi, int(affine),
        pts.data_ptr(), ent.data_ptr(), seg.data_ptr(), seg.numel() - 1,
        out.data_ptr(), ct.kernel_consts(F, b3)[3].ctypes.data,
    )
    assert rc == 0
    return out


@pytest.mark.parametrize(
    "curve,g2", [("bls12-377", False), ("bw6-761", False), ("bw6-761", True),
                 ("bls12-377", True)]
)
def test_kernel_device_code_cpu_build_matches_plain(curve, g2):
    """Empty segments, single points, P+P, P+(-P), repeats and random
    mixes: the kernel's device code (csrc/curve.cuh reduce_segment over the
    fast field core), built for the CPU with the warp's lanes as
    coroutines, gives the plain version's limbs; both give the host
    curve's sums."""
    b3 = ct.b3_of(curve, g2)
    F, pts, xy, ent, seg, segs = _segments_case(curve, g2, 17)
    ref = msm.bucket_reduce(xy, ent, seg, F, b3, True)  # CPU: plain
    assert torch.equal(_cpu_kernel(F, xy, ent, seg, b3, True), ref)
    crv = _curve(curve, g2)
    for s, got in zip(segs, ct.to_affine_host(F, ref)):
        want = None
        for e in s:
            q = pts[e >> 1]
            want = crv.add(want, crv.neg(q) if e & 1 else q)
        assert got == want
    e2 = torch.arange(ref.shape[0], dtype=torch.int32) * 2
    s2 = torch.tensor([0, 1, 5, 5, ref.shape[0]], dtype=torch.int32)
    ref2 = msm.bucket_reduce(ref, e2, s2, F, b3, False)
    assert torch.equal(_cpu_kernel(F, ref, e2, s2, b3, False), ref2)


@pytest.mark.cuda
def test_bucket_reduce_kernel_matches_plain_on_gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    for curve, g2 in (("bls12-377", False), ("bw6-761", False),
                      ("bw6-761", True)):
        b3 = ct.b3_of(curve, g2)
        F, _, xy, ent, seg, _ = _segments_case(curve, g2, 23)
        xy, ent, seg = xy.cuda(), ent.cuda(), seg.cuda()
        before = msm.bucket_reduce.launches
        got = msm.bucket_reduce(xy, ent, seg, F, b3, True)
        assert msm.bucket_reduce.launches == before + 1
        ref = msm.bucket_reduce_ref(xy, ent, seg, F, b3, True)
        assert torch.equal(got, ref)


def _need_gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")


@pytest.mark.cuda
def test_bucket_reduce_fq2_kernel_matches_plain_on_gpu():
    """K1 in its Fq2 form (BLS12-377 G2), affine and projective inputs."""
    _need_gpu()
    curve, g2 = "bls12-377", True
    b3 = ct.b3_of(curve, g2)
    F, _, xy, ent, seg, _ = _segments_case(curve, g2, 29)
    xy, ent, seg = xy.cuda(), ent.cuda(), seg.cuda()
    before = msm.bucket_reduce.launches_by_form["fq2"]
    got = msm.bucket_reduce(xy, ent, seg, F, b3, True)
    assert msm.bucket_reduce.launches_by_form["fq2"] == before + 1
    ref = msm.bucket_reduce_ref(xy, ent, seg, F, b3, True)
    assert torch.equal(got, ref)
    e2 = torch.arange(ref.shape[0], dtype=torch.int32, device="cuda") * 2
    s2 = torch.tensor([0, 1, 5, 5, ref.shape[0]], dtype=torch.int32,
                      device="cuda")
    assert torch.equal(msm.bucket_reduce(ref, e2, s2, F, b3, False),
                       msm.bucket_reduce_ref(ref, e2, s2, F, b3, False))


@pytest.mark.cuda
@pytest.mark.parametrize(
    "curve,g2", [("bls12-377", False), ("bw6-761", False), ("bw6-761", True),
                 ("bls12-377", True)]
)
def test_proj_kernels_match_plain_on_gpu(curve, g2):
    """K2 and K3 against their plain versions, with identities, P+P,
    P+(-P) and Z != 1 among the inputs."""
    from zecale_tpu_torch.ec import proj_curve as pc

    _need_gpu()
    crv = pc.ProjCurve(curve, g2)
    F, b3 = crv.F, crv.b3
    pts = _points(curve, g2, 8)
    neg = [_curve(curve, g2).neg(p) for p in pts]
    xy, inf = ct.pack_affine(F, pts + [None] + pts, "cuda")
    a = crv.from_affine(xy, inf)
    xy2, inf2 = ct.pack_affine(F, pts[1:] + [pts[0], None] + neg, "cuda")
    b = ct.proj_dbl(F, crv.from_affine(xy2, inf2), b3)  # Z != 1
    a = torch.cat([a, ct.proj_dbl(F, a, b3)])
    b = torch.cat([b, a[: b.shape[0]]])
    before = pc.proj_add.launches
    got = pc.proj_add(F, a, b, b3)
    assert pc.proj_add.launches == before + 1
    assert torch.equal(got, ct.proj_add(F, a, b, b3))
    for k in (1, 6):
        ref = a
        for _ in range(k):
            ref = ct.proj_dbl(F, ref, b3)
        assert torch.equal(pc.proj_dbl_chain(F, a, k, b3), ref)
