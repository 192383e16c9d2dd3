"""The port's msm8 engine (zecale_tpu_torch/ec/msm8.py) on the CPU, where
K2 and K3 take their plain versions, against the host curve, with the edge
cases of tests/test_msm8.py:75-100 (zero scalars, 1, r - 1, duplicate
points, points at infinity, all-equal digits); the same inputs through the
msm4 route (ec/msm.py) give the same point.  Tolerance: exact."""

import random

import pytest
import torch

from zecale_tpu.ec import host_curve as hc
from zecale_tpu.ff import params as P
from zecale_tpu_torch.ec import curve_torch as ct
from zecale_tpu_torch.ec import msm, msm8
from zecale_tpu_torch.ff.fp_torch import field

# One intra-op thread: the suite runs in several worker processes at
# once, and torch's OpenMP threads spinning in each of them slow every
# worker many times over (a 13 s test took 695 s with four workers).
torch.set_num_threads(1)


def _points(curve, g2, n, rng):
    crv = hc.g2_curve(curve) if g2 else hc.g1_curve(curve)
    gen = hc.generators(curve)[1 if g2 else 0]
    pts, p = [], gen
    for _ in range(n):
        pts.append(p)
        p = crv.add(crv.dbl(p), gen)
    rng.shuffle(pts)
    return pts


def _host_msm(curve, g2, scalars, pts):
    crv = hc.g2_curve(curve) if g2 else hc.g1_curve(curve)
    acc = None
    for s, p in zip(scalars, pts):
        if p is not None and s:
            acc = crv.add(acc, crv.mul(s, p))
    return acc


def _both(curve, g2, scalars, pts, c):
    F = ct.coord_field(curve, g2)
    xy, inf = ct.pack_affine(F, pts, "cpu")
    scal = field(P.CURVES[curve].r).pack(scalars)
    return (msm8.msm8(curve, g2, scal, xy, inf, c),
            msm.msm(curve, g2, scal, xy, inf))


@pytest.mark.parametrize("curve,g2,n,c", [
    ("bls12-377", False, 64, 7),
    ("bls12-377", True, 16, 0),
    ("bw6-761", False, 16, 0),
])
def test_msm8_matches_host_and_msm4_route(curve, g2, n, c):
    rng = random.Random(42 + n + g2)
    r = P.CURVES[curve].r
    pts = _points(curve, g2, n, rng)
    scalars = [rng.randrange(r) for _ in range(n)]
    scalars[:4] = [0, 1, r - 1, 2]
    pts[5] = pts[6]  # duplicate point
    pts[7] = None  # infinity
    want = _host_msm(curve, g2, scalars, pts)
    got8, got4 = _both(curve, g2, scalars, pts, c)
    assert got8 == want
    assert got4 == want


def test_msm8_all_equal_digits_and_identity():
    """All-equal scalars put every point into one bucket per window (the
    combining tail runs its full log2 depth); all-zero scalars and a single
    1 give the identity and the point itself."""
    curve, n, c = "bls12-377", 32, 6
    rng = random.Random(7)
    r = P.CURVES[curve].r
    pts = _points(curve, False, n, rng)
    s = rng.randrange(r)
    got8, got4 = _both(curve, False, [s] * n, pts, c)
    want = _host_msm(curve, False, [s] * n, pts)
    assert got8 == got4 == want
    assert _both(curve, False, [0] * n, pts, c) == (None, None)
    one = [1] + [0] * (n - 1)
    assert _both(curve, False, one, pts, c) == (pts[0], pts[0])


def test_round_schedule_and_pairing():
    assert msm8._round_schedule(1000, 64) == [565, 315, 190, 128, 97, 81]
    assert msm8._round_schedule(1000, 64, 3) == [565, 315, 190]
    assert msm8._round_schedule(10, 64) == []
    S = msm8.SENT
    keys = torch.tensor([3, 3, 3, 5, 8, 8, 8, 8, S, S])
    can_pair, keep = msm8._pair_flags(keys)
    assert can_pair.tolist() == [1, 0, 0, 0, 1, 0, 1, 0, 0, 0]
    assert keep.tolist() == [1, 0, 1, 1, 1, 0, 1, 0, 0, 0]
    g, valid = msm8._compact_indices(keep, 6)
    assert g.tolist()[:5] == [0, 2, 3, 4, 6]
    assert valid.tolist() == [1, 1, 1, 1, 1, 0]


def test_default_window():
    assert [msm8.default_window(1 << k) for k in (2, 6, 8, 13, 16, 18, 20)] \
        == [4, 4, 7, 9, 11, 13, 15]
