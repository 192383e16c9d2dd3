"""The port's Pippenger MSM (zecale_tpu_torch/ec/msm_jac.py) on the CPU
against the reference's JacCurve (ec/curve_jax.py over the 16-bit field
of ec/msm_tpu.py), step by step: the affine tiled round
(_segment_tile_reduce_mixed), the Jacobian tiled round
(_segment_tile_reduce) and the bit-serial combine (JacCurve.msm).  The
reference runs one window at a time, the port all windows at once.  The
whole jitted msm_pippenger takes minutes to compile on the CPU (its
bit-serial scan unrolls a nine-level tree of unified adds), so its steps
are compared at small sizes here and the whole MSM is held against the
host oracle in tests/test_torch_msm_jac.py.  Tolerance: exact -- digits
and every Jacobian triple, the coordinates carried through masked entries
included."""

import random

import jax.numpy as jnp
import numpy as np
import torch

from zecale_tpu.ec import host_curve as hc
from zecale_tpu.ec import msm_tpu
from zecale_tpu.ff import fp_jax
from zecale_tpu.ff import params as P
from zecale_tpu_torch.ec import curve_torch as ct
from zecale_tpu_torch.ec import msm_jac

# One intra-op thread: the suite runs in several worker processes at
# once, and torch's OpenMP threads spinning in each of them slow every
# worker many times over (a 13 s test took 695 s with four workers).
torch.set_num_threads(1)

CURVE = "bls12-377"
W, M, TILE, SENT = 2, 64, 8, 1 << 8


def _window_inputs(seed):
    """Per window: sorted digits with zeros first, runs across tile
    boundaries and sentinel padding last; points with duplicates (the
    doubling case inside a run) and infinity."""
    crv = hc.g1_curve(CURVE)
    gen = hc.generators(CURVE)[0]
    rng = random.Random(seed)
    base = [crv.mul(rng.randrange(1, crv.order), gen) for _ in range(5)]
    digits, pts = [], []
    for w in range(W):
        d = sorted([0] * 5 + [rng.randrange(1, 6) for _ in range(M - 9)]
                   + [rng.randrange(200, 256)]) + [SENT] * 3
        digits.append(d)
        row = [base[rng.randrange(5)] for _ in range(M)]
        row[7 + w] = None
        row[-3:] = [None] * 3
        pts.append(row)
    return digits, pts


def _ref_aff(digits, pts):
    F = fp_jax.field(P.CURVES[CURVE].q)
    d = jnp.asarray(digits, jnp.int32)
    return d, {
        "x": F.pack([0 if p is None else p[0] for p in pts]),
        "y": F.pack([0 if p is None else p[1] for p in pts]),
        "inf": jnp.asarray([p is None for p in pts]) | (d == 0),
    }


def _ref_vals(pt):
    F = fp_jax.field(P.CURVES[CURVE].q)
    cols = [F.unpack(np.asarray(pt[k])) for k in ("x", "y", "z")]
    return list(zip(*cols))


def _port_vals(F, t):
    vals = F.unpack_mont(t.reshape(-1, *F.shape))
    return [tuple(vals[3 * i: 3 * i + 3]) for i in range(len(vals) // 3)]


def test_tile_rounds_and_bit_serial_match_reference():
    ref = msm_tpu.g1_curve_tpu(CURVE)
    crv = msm_jac.curve(CURVE, False)
    F = crv.F
    digits, pts = _window_inputs(3)

    # the affine round, every window at once against one at a time
    flat = [p for row in pts for p in row]
    xy, inf = ct.pack_affine(F, flat, "cpu")
    d = torch.tensor(digits)
    xy = xy.reshape(W, M, 2, *F.shape)
    inf = inf.reshape(W, M) | (d == 0)
    d1, p1 = msm_jac._tile_reduce_mixed(crv, d, xy, inf, TILE, SENT)
    ref1 = []
    z_one = ref.F.one_mont_elem()
    for w in range(W):
        rd, aff = _ref_aff(digits[w], pts[w])
        rd1, rp1 = ref._segment_tile_reduce_mixed(rd, aff, TILE, SENT, z_one)
        ref1.append((rd1, rp1))
        assert d1[w].tolist() == np.asarray(rd1).tolist()
        assert _port_vals(F, p1[w]) == _ref_vals(rp1)

    # a Jacobian round on the round's output
    d2, p2 = msm_jac._tile_reduce(crv, d1, p1, TILE, SENT)
    for w in range(W):
        rd2, rp2 = ref._segment_tile_reduce(*ref1[w], TILE, SENT)
        assert d2[w].tolist() == np.asarray(rd2).tolist()
        assert _port_vals(F, p2[w]) == _ref_vals(rp2)
        if w == 0:
            ref2 = rp2

    # the bit-serial combine of 16 partials of window 0 over c = 8 bits
    dd = torch.where(d2[0, :16] >= SENT, 0, d2[0, :16])
    bits = torch.stack([(dd >> (7 - b)) & 1 for b in range(8)])
    got = crv.msm(bits, p2[0, :16])
    want = ref.msm(jnp.asarray(bits.numpy(), jnp.int32),
                   {k: v[:16] for k, v in ref2.items()})
    assert _port_vals(F, got) == _ref_vals({k: v[None] for k, v in
                                            want.items()})
