"""The port's Jacobian MSM engine and fixed-base multiply
(zecale_tpu_torch/ec/msm_jac.py) on the CPU, where the kernels' wrappers
take their plain versions: digits against the reference's
msm_tpu.scalar_digit_planes; the Pippenger MSM against the host oracle at
n = 1037 (built as tests/test_tpu_kernels.py builds its case: heavy
duplication, zero scalars, a point at infinity, equal digits on equal and
on different points, a length that is not tile-aligned), at n = 2100 (a
second, Jacobian tiled round), at n <= 512 and in G2 over Fq2; the
bit-serial MSM, the fixed-base multiply at 0, 1, r - 1 and random scalars,
the per-lane double-and-add, and the device setup's MSM entry.
Tolerance: exact."""

import random

import numpy as np
import pytest
import torch

from zecale_tpu.ec import msm_tpu
from zecale_tpu_torch.ec import curve_torch as ct
from zecale_tpu_torch.ec import host_curve as hc
from zecale_tpu_torch.ec import jac_curve as jc
from zecale_tpu_torch.ec import msm_jac
from zecale_tpu_torch.ff import params as P
from zecale_tpu_torch.ff.fp_torch import field
from zecale_tpu_torch.snark.groth16_torch import Groth16Torch

# One intra-op thread: the suite runs in several worker processes at
# once, and torch's OpenMP threads spinning in each of them slow every
# worker many times over (a 13 s test took 695 s with four workers).
torch.set_num_threads(1)


def _host(curve, g2):
    return hc.g2_curve(curve) if g2 else hc.g1_curve(curve)


@pytest.mark.parametrize("curve,c", [("bls12-377", 8), ("bw6-761", 8),
                                     ("bls12-377", 5), ("bw6-761", 5),
                                     ("bls12-377", 13), ("bls12-377", 1)])
def test_digit_planes_match_reference(curve, c):
    r = P.CURVES[curve].r
    rng = random.Random(c)
    scalars = [0, 1, r - 1, (1 << (r.bit_length() - 1))] + [
        rng.randrange(r) for _ in range(60)]
    got = msm_jac.scalar_digit_planes(field(r).pack(scalars),
                                      r.bit_length(), c)
    want = np.asarray(msm_tpu.scalar_digit_planes(scalars, r.bit_length(), c))
    assert np.array_equal(got.numpy(), want)
    assert got.shape == (msm_jac.num_windows(r.bit_length(), c),
                         len(scalars))


def _tpu_kernels_case(n, seed):
    """tests/test_tpu_kernels.py:181's case at length n."""
    curve = "bls12-377"
    crv = hc.g1_curve(curve)
    rng = random.Random(seed)
    gen = hc.generators(curve)[0]
    base = [crv.mul(rng.randrange(1, crv.order), gen) for _ in range(16)]
    pts = [base[i % 16] for i in range(n)]
    scalars = [rng.randrange(crv.order) for _ in range(n)]
    scalars[7] = 0
    scalars[8] = 0
    pts[9] = None
    scalars[20] = scalars[36]  # pts[20] != pts[36]
    scalars[16] = scalars[32]  # pts[16] == pts[32]
    return curve, crv, scalars, pts


@pytest.mark.parametrize("n", [1037, 2100])
def test_pippenger_matches_host_large(n):
    """n = 1037: one affine tiled round (tiles of 8, padded to 1040);
    n = 2100: the affine round leaves 521 > 512 entries per window, so a
    Jacobian round runs too."""
    curve, crv, scalars, pts = _tpu_kernels_case(n, 44)
    got = msm_jac.msm_g1_pippenger(curve, scalars, pts, device="cpu")
    assert crv.eq(got, crv.msm(scalars, pts))


def test_pippenger_small_and_edge_cases():
    curve = "bls12-377"
    crv = hc.g1_curve(curve)
    rng = random.Random(5)
    gen = hc.generators(curve)[0]
    pts = [crv.mul(rng.randrange(1, crv.order), gen) for _ in range(40)]
    r = P.CURVES[curve].r
    scalars = [rng.randrange(r) for _ in range(40)]
    scalars[0], scalars[1] = 0, r - 1
    pts[2] = None
    pts[3] = pts[4]
    scalars[3] = scalars[4]
    got = msm_jac.msm_g1_pippenger(curve, scalars, pts, device="cpu")
    assert got == crv.msm(scalars, pts)
    # all zero scalars: the identity
    assert msm_jac.msm_g1_pippenger(curve, [0] * 5, pts[:5],
                                    device="cpu") is None


@pytest.mark.parametrize("curve", ["bls12-377", "bw6-761"])
def test_pippenger_g2(curve):
    """BLS12-377 G2 over Fq2 and BW6-761 G2 over Fq."""
    crv = hc.g2_curve(curve)
    rng = random.Random(9)
    gen = hc.generators(curve)[1]
    pts = [crv.mul(rng.randrange(1, crv.order), gen) for _ in range(6)]
    pts = [pts[i % 6] for i in range(24)]
    r = P.CURVES[curve].r
    scalars = [rng.randrange(r) for _ in range(24)]
    scalars[5] = 0
    pts[6] = None
    got = msm_jac.msm_g2_pippenger(curve, scalars, pts, device="cpu")
    assert got == crv.msm(scalars, pts)


def test_bit_serial_msm():
    curve = "bls12-377"
    crv = hc.g1_curve(curve)
    rng = random.Random(2)
    gen = hc.generators(curve)[0]
    pts = [crv.mul(rng.randrange(1, crv.order), gen) for _ in range(5)]
    pts[1] = None
    r = P.CURVES[curve].r
    scalars = [rng.randrange(r) for _ in range(5)]
    scalars[3] = 0
    got = msm_jac.msm_g1(curve, scalars, pts, device="cpu")
    assert got == crv.msm(scalars, pts)


@pytest.mark.parametrize("curve,g2", [("bls12-377", False), ("bw6-761", True),
                                      ("bls12-377", True)])
def test_fixed_base_mul_batch(curve, g2):
    host = _host(curve, g2)
    r = P.CURVES[curve].r
    rng = random.Random(17)
    gen = hc.generators(curve)[1 if g2 else 0]
    base = host.mul(rng.randrange(1, r), gen)
    scalars = [0, 1, r - 1, 2, 31, 32] + [rng.randrange(r) for _ in range(4)]
    pts = msm_jac.fixed_base_mul_batch(curve, g2, field(r).pack(scalars),
                                       base)
    got = msm_jac.curve(curve, g2).to_affine_host(pts)
    assert got == [host.mul(s, base) for s in scalars]
    assert got[0] is None and got[2] == host.neg(base)


def test_batch_mul_per_lane():
    curve = "bw6-761"
    host = hc.g1_curve(curve)
    gen = hc.generators(curve)[0]
    bases = [gen, host.dbl(gen), None, host.mul(5, gen)]
    ks = [0x1234, 1, 77, 0xFFFF]
    crv = msm_jac.curve(curve, False)
    xy, inf = ct.pack_affine(crv.F, bases, "cpu")
    bits = torch.tensor([[(k >> (15 - b)) & 1 for k in ks]
                         for b in range(16)])
    got = msm_jac.batch_mul(curve, False, bits, crv.lift(xy, inf))
    assert crv.to_affine_host(got) == [
        None if p is None else host.mul(k, p) for k, p in zip(ks, bases)]


def test_msm_device_against_host():
    curve = "bls12-377"
    crv = hc.g1_curve(curve)
    gen = hc.generators(curve)[0]
    rng = random.Random(4)
    pts = [crv.mul(rng.randrange(1, crv.order), gen) for _ in range(6)]
    scalars = [rng.randrange(crv.order) for _ in range(5)]
    prover = Groth16Torch(curve, device="cpu")
    F = ct.coord_field(curve, False)
    xy, inf = ct.pack_affine(F, pts + [None, None], "cpu")
    acc = prover.msm_device(False, {"xy": xy, "inf": inf},
                            prover._scalars(scalars, len(xy)))
    assert msm_jac.curve(curve, False).to_affine_host(acc) == [
        crv.msm(scalars, pts[:5])]
    with pytest.raises(ValueError):
        prover.msm_device(False, {"xy": xy, "inf": inf},
                          prover._scalars([1] * 9, 9))


def test_wrappers_refuse_bad_input():
    F = ct.coord_field("bls12-377", False)
    a = torch.zeros(2, 3, F.n, dtype=torch.int32)
    with pytest.raises(ValueError):
        jc.jac_dbl_chain(F, a, 0)
    with pytest.raises(ValueError):
        msm_jac.scalar_digit_planes(torch.zeros(1, 8, dtype=torch.int32),
                                    253, 0)
    with pytest.raises(ValueError):
        msm_jac.msm("bls12-377", False, torch.zeros(3, 8, dtype=torch.int32),
                    torch.zeros(2, 2, F.n, dtype=torch.int32),
                    torch.zeros(2, dtype=torch.bool))
