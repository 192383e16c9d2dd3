"""The port's msm8 in window chunks (zecale_tpu_torch/ec/msm8.py:
window_range, msm8_window_range, msm8_streamed, msm8_chunked_host and
msm8(chunks=k)) on the CPU, where K2 and K3 take their plain versions,
against the host oracle and the unchunked msm8, with the edge cases of
tests/test_torch_msm8_jax.py (a zero scalar, r - 1, a duplicate point, a
point at infinity) and chunk counts that leave a tail of padding windows;
the reference's chunk rule (snark/groth16_tpu.py:504-507, 536) as
groth16_torch.msm8_chunks, and Groth16Torch.prove taking it for all five
msm8 MSMs.  Tolerance: exact."""

import random

import pytest
import torch

from zecale_tpu.aggregator import dummy_app as ref_da
from zecale_tpu.ec import host_curve as hc
from zecale_tpu.ff import params as P
from zecale_tpu.snark.groth16 import Groth16 as RefGroth16
from zecale_tpu_torch.ec import curve_torch as ct
from zecale_tpu_torch.ec import msm, msm8
from zecale_tpu_torch.ff.fp_torch import field
from zecale_tpu_torch.snark import groth16_torch as gt

# One intra-op thread: the suite runs in several worker processes at
# once, and torch's OpenMP threads spinning in each of them slow every
# worker many times over (a 13 s test took 695 s with four workers).
torch.set_num_threads(1)


def _case(curve, g2, n, seed):
    """n points (a duplicate, one at infinity) and scalars (0, r - 1) ->
    (scalars, points, the host oracle's MSM)."""
    rng = random.Random(seed)
    crv = hc.g2_curve(curve) if g2 else hc.g1_curve(curve)
    gen = hc.generators(curve)[1 if g2 else 0]
    pts, p = [], gen
    for _ in range(n):
        pts.append(p)
        p = crv.add(crv.dbl(p), gen)
    rng.shuffle(pts)
    r = P.CURVES[curve].r
    scalars = [rng.randrange(r) for _ in range(n)]
    scalars[0] = 0
    scalars[1] = r - 1
    pts[1] = pts[2]
    pts[3] = None
    want = crv.msm([s for s, q in zip(scalars, pts) if q is not None],
                   [q for q in pts if q is not None])
    return scalars, pts, want


def _packed(curve, g2, scalars, pts):
    xy, inf = ct.pack_affine(ct.coord_field(curve, g2), pts, "cpu")
    return field(P.CURVES[curve].r).pack(scalars), xy, inf


@pytest.mark.parametrize("curve,n,want", [
    ("bw6-761", 1 << 16, 1),
    ("bw6-761", 1 << 17, 2),
    ("bw6-761", 1 << 18, 4),
    ("bw6-761", 1 << 20, 16),
    ("bw6-761", 1 << 10, 1),
    ("bls12-377", 1 << 18, 1),
    ("bls12-377", 1 << 19, 2),
    ("bls12-377", 1 << 20, 4),
])
def test_msm8_chunks_is_the_references_rule(curve, n, want):
    # unit 2^16 where the base field q takes 96 bytes, else 2^18
    assert gt.msm8_chunks(curve, n) == want


def test_window_range_pads_a_tail_with_zero_windows():
    planes = torch.arange(1, 5 * 3 + 1).reshape(5, 3)
    assert torch.equal(msm8.window_range(planes, 0, 2), planes[:2])
    tail = msm8.window_range(planes, 4, 3)
    assert tail.shape == (3, 3)
    assert torch.equal(tail[0], planes[4])
    assert not tail[1:].any()
    # 43 windows in 3 chunks: 15 a chunk, the last two padding
    assert msm8.chunk_width(43, 3) == 15
    assert msm8.chunk_width(43, 43) == msm8.chunk_width(43, 60) == 1
    with pytest.raises(ValueError):
        msm8.chunk_width(43, 0)


# (curve, G2, n, c, route, chunks): each count leaves padding windows in
# its last chunk (W = 43 at c = 6 and 64 at c = 4 on BLS12-377, 95 at
# c = 4 on BW6-761)
@pytest.mark.parametrize("curve,g2,n,c,route,chunks", [
    ("bls12-377", False, 64, 6, "msm8", 3),
    ("bls12-377", False, 64, 6, "host", 2),
    ("bls12-377", True, 16, 4, "streamed", 3),
    ("bw6-761", False, 16, 4, "msm8", 2),
])
def test_chunked_msm8_matches_host_oracle(curve, g2, n, c, route, chunks):
    scalars, pts, want = _case(curve, g2, n, 42 + n + g2)
    scal, xy, inf = _packed(curve, g2, scalars, pts)
    W = msm.num_windows(P.CURVES[curve].r.bit_length(), c)
    assert chunks * msm8.chunk_width(W, chunks) > W
    fn = {"msm8": lambda: msm8.msm8(curve, g2, scal, xy, inf, c, chunks),
          "streamed": lambda: msm8.msm8_streamed(curve, g2, scal, xy, inf,
                                                 c, chunks),
          "host": lambda: msm8.msm8_chunked_host(curve, g2, scal, xy, inf,
                                                 c, chunks)}[route]
    assert fn() == want


@pytest.mark.slow
@pytest.mark.parametrize("chunks", [43, 60])
def test_one_window_a_chunk_equals_unchunked_msm8(chunks):
    """Every window a chunk of its own (60: 17 chunks wholly in the
    padding, which add nothing) against the unchunked msm8, BLS12-377 G1
    at n = 64, c = 6 (~45 s each on one CPU thread)."""
    curve, c = "bls12-377", 6
    scalars, pts, want = _case(curve, False, 64, 7)
    scal, xy, inf = _packed(curve, False, scalars, pts)
    one = msm8.msm8(curve, False, scal, xy, inf, c)
    assert one == want
    assert msm8.msm8(curve, False, scal, xy, inf, c, chunks) == one


def test_prove_takes_the_chunk_rule_for_every_msm8(monkeypatch):
    """The msm8 engine's five MSMs (A, B1, B2, L, H) each get
    msm8_chunks(curve, n) chunks; msm4 makes no msm8 call.  The recorder
    computes each MSM by the msm4 route, so the proof must still be the
    host prover's."""
    curve = "bw6-761"
    r1cs, kp = ref_da.dummy_app_setup(curve, random.Random(5))
    asg = ref_da.dummy_app_assignment(curve, 9)
    want = RefGroth16(curve).prove(r1cs, kp.pk, asg, random.Random(77))
    calls = []

    def rule(curve_name, n):
        assert curve_name == curve
        return n + 3

    def recorder(curve_name, g2, scal, xy, inf, c=0, chunks=1):
        calls.append((g2, xy.shape[0], chunks))
        return msm.msm(curve_name, g2, scal, xy, inf)

    monkeypatch.setattr(gt, "msm8_chunks", rule)
    monkeypatch.setattr(gt.msm8, "msm8", recorder)
    for engine in ("msm4", "msm8"):
        prover = gt.Groth16Torch(curve, device="cpu", engine=engine)
        got = prover.prove(r1cs, kp.pk, asg, random.Random(77))
        assert (got.a, got.b, got.c) == (want.a, want.b, want.c)
    dpk = gt.pack_pk(curve, kp.pk, r1cs.num_primary + 1, "cpu")
    g1, g2 = (False, dpk.n_g1, dpk.n_g1 + 3), (True, dpk.n_g2, dpk.n_g2 + 3)
    assert calls == [g1, g1, g2, g1, g1]
