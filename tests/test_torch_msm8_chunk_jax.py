"""The port's msm8 in window chunks on the CPU (plain K2 / K3) against the
reference's (ec/msm8.py, jnp group law, use_pallas=False) at the shape of
tests/test_msm8.py:151 (BLS12-377 G1, n = 64, c = 6, 3 chunks of 15 of
the 43 windows, a zero scalar and a point at infinity): msm8_streamed
against msm8_streamed_jit (679), and the partial of the last window range
(windows 30-44, two of them padding) against msm8_jit's w_range partial
(625, 664-675).  Both reference functions compile their whole pipeline on
the CPU, 158-174 s each from a cold cache, so the tests are slow.
Tolerance: exact."""

import random

import jax.numpy as jnp
import pytest
import torch

from zecale_tpu.ec import host_curve as hc
from zecale_tpu.ec import msm8 as ref_msm8
from zecale_tpu.ff import fp8
from zecale_tpu.ff import params as P
from zecale_tpu_torch.ec import curve_torch as ct
from zecale_tpu_torch.ec import msm, msm8
from zecale_tpu_torch.ec.proj_curve import ProjCurve
from zecale_tpu_torch.ff.fp_torch import field

# One intra-op thread: the suite runs in several worker processes at
# once, and torch's OpenMP threads spinning in each of them slow every
# worker many times over (a 13 s test took 695 s with four workers).
torch.set_num_threads(1)

CURVE = "bls12-377"
N, C, CHUNKS = 64, 6, 3


@pytest.fixture(scope="module")
def inputs():
    """tests/test_msm8.py:151-161's inputs, for both packings."""
    rng = random.Random(23)
    crv = hc.g1_curve(CURVE)
    gen = hc.generators(CURVE)[0]
    pts, p = [], gen
    for _ in range(N):
        pts.append(p)
        p = crv.add(crv.dbl(p), gen)
    rng.shuffle(pts)
    pts[2] = None
    r = P.CURVES[CURVE].r
    scalars = [rng.randrange(r) for _ in range(N)]
    scalars[0] = 0
    xy, inf = ct.pack_affine(ct.coord_field(CURVE, False), pts, "cpu")
    return {
        "scalars": scalars, "pts": pts,
        "ref": (fp8.field8(r).pack(scalars, mont=False),
                ref_msm8.pack_points_affine8(CURVE, pts)),
        "port": (field(r).pack(scalars), xy, inf),
    }


@pytest.mark.slow
def test_msm8_streamed_matches_jax_streamed(inputs):
    dev = ref_msm8.msm8_streamed_jit(CURVE, False, C, CHUNKS,
                                     use_pallas=False)(*inputs["ref"])
    want = ref_msm8.unpack_jac_point8(CURVE, dev)
    got = msm8.msm8_streamed(CURVE, False, *inputs["port"], C, CHUNKS)
    assert got == want
    pts = inputs["pts"]
    assert got == hc.g1_curve(CURVE).msm(
        [s for s, q in zip(inputs["scalars"], pts) if q is not None],
        [q for q in pts if q is not None])


@pytest.mark.slow
def test_window_range_partial_matches_jax_w_range(inputs):
    r = P.CURVES[CURVE].r
    W = msm.num_windows(r.bit_length(), C)
    per = msm8.chunk_width(W, CHUNKS)
    lo = (CHUNKS - 1) * per
    assert lo + per > W  # the tail range, part padding
    dev = ref_msm8.msm8_jit(CURVE, False, C, False, 0, (0, per))(
        *inputs["ref"], jnp.int32(lo))
    want = ref_msm8.unpack_jac_point8(CURVE, dev)
    scal, xy, inf = inputs["port"]
    buckets, signs = msm.signed_digits(scal, r.bit_length(), C)
    crv = ProjCurve(CURVE, False)
    part = msm8.msm8_window_range(crv, buckets, signs, xy, inf, C, lo, per)
    assert crv.to_affine_host(part)[0] == want
