"""The port's MSM on the CPU (plain bucket reduce) against the reference
engine ec/msm4.py with its Pallas bucket-reduce kernel in interpret mode,
at the size tests/test_msm4.py:51 runs it (n = 300, BLS12-377 G1).  The
JAX side compiles its whole pipeline on the CPU (about 90 s), so this
comparison has a file of its own.  Tolerance: exact."""

import numpy as np
import torch

from zecale_tpu.ec import host_curve as hc
from zecale_tpu.ec import msm4
from zecale_tpu.ff import params as P
from zecale_tpu_torch.ec import curve_torch as ct
from zecale_tpu_torch.ec import msm
from zecale_tpu_torch.ff.fp_torch import field

# One intra-op thread: the suite runs in several worker processes at
# once, and torch's OpenMP threads spinning in each of them slow every
# worker many times over (a 13 s test took 695 s with four workers).
torch.set_num_threads(1)


def test_msm_matches_jax_msm4_pallas_interpret():
    curve = "bls12-377"
    r = P.CURVES[curve].r
    n = 300  # not a power of two on purpose
    crv = hc.g1_curve(curve)
    pts, pt = [], hc.generators(curve)[0]
    for _ in range(n):
        pts.append(pt)
        pt = crv.dbl(pt)
    pts[17] = None
    rng = np.random.default_rng(7)
    words = rng.integers(0, 1 << 62, size=(n, 5), dtype=np.int64)
    scalars = [int(sum(int(w) << (62 * i) for i, w in enumerate(row))) % r
               for row in words]
    scalars[:4] = [0, 1, r - 1, 2]

    want = msm4.msm4(curve, scalars, pts, use_pallas=True)
    F = ct.base_field(curve)
    xy, inf = ct.pack_affine(F, pts, "cpu")
    got = msm.msm(curve, False, field(r).pack(scalars), xy, inf)
    assert got == want
