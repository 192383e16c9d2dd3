"""The port's msm8 engine on the CPU (plain K2 / K3) against the
reference's msm8 engine (ec/msm8.py, jnp group law, use_pallas=False) at
the shape tests/test_msm8.py:20 shares (BLS12-377 G1, n = 64, c = 6), with
its edge cases: a zero scalar, duplicate points and a point at infinity.
The JAX side compiles its whole pipeline on the CPU (about a minute), so
this comparison has a file of its own.  Tolerance: exact."""

import random

import torch

from zecale_tpu.ec import host_curve as hc
from zecale_tpu.ec import msm8 as ref_msm8
from zecale_tpu.ff import params as P
from zecale_tpu_torch.ec import curve_torch as ct
from zecale_tpu_torch.ec import msm8
from zecale_tpu_torch.ff.fp_torch import field

# One intra-op thread: the suite runs in several worker processes at
# once, and torch's OpenMP threads spinning in each of them slow every
# worker many times over (a 13 s test took 695 s with four workers).
torch.set_num_threads(1)

CURVE = "bls12-377"
N, C = 64, 6


def test_msm8_matches_jax_msm8():
    rng = random.Random(42)
    crv = hc.g1_curve(CURVE)
    gen = hc.generators(CURVE)[0]
    pts, p = [], gen
    for _ in range(N):
        pts.append(p)
        p = crv.add(crv.dbl(p), gen)
    rng.shuffle(pts)
    r = P.CURVES[CURVE].r
    scalars = [rng.randrange(r) for _ in range(N)]
    scalars[0] = 0
    scalars[1] = r - 1
    pts[1] = pts[2]
    pts[3] = None

    want = ref_msm8.msm8(CURVE, scalars, pts, c=C, use_pallas=False)
    F = ct.coord_field(CURVE, False)
    xy, inf = ct.pack_affine(F, pts, "cpu")
    got = msm8.msm8(CURVE, False, field(r).pack(scalars), xy, inf, C)
    assert got == want
    assert got == crv.msm([s for s, q in zip(scalars, pts) if q is not None],
                          [q for q in pts if q is not None])
