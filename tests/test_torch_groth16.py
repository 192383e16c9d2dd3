"""The port's device prover (zecale_tpu_torch/snark/groth16_torch.py) on
the CPU against the reference's host Groth16 prover and verifier, on both
curves (BW6-761, and BLS12-377 with G2 over Fq2) and with all three MSM
engines (msm4, msm8, and jac: the reference's use_msm8=False branch), and
the carry-over of the reference's packed proving key.  Tolerance: exact
(the same random.Random state must give the same A, B, C)."""

import random

import numpy as np
import pytest
import torch

from zecale_tpu.aggregator import dummy_app as ref_da
from zecale_tpu.snark.groth16 import Groth16 as RefGroth16
from zecale_tpu.snark.groth16_tpu import pack_pk8
from zecale_tpu_torch.snark.groth16_torch import (
    QUERIES,
    Groth16Torch,
    from_reference_pk8,
    pack_pk,
)
from zecale_tpu_torch.utils.device import resolve

# One intra-op thread: the suite runs in several worker processes at
# once, and torch's OpenMP threads spinning in each of them slow every
# worker many times over (a 13 s test took 695 s with four workers).
torch.set_num_threads(1)

CURVE = "bw6-761"


@pytest.fixture(scope="module")
def dummy_bw6():
    r1cs, kp = ref_da.dummy_app_setup(CURVE, random.Random(5))
    return r1cs, kp


def test_groth16_torch_cpu_equals_host_prover_and_verifies(dummy_bw6):
    r1cs, kp = dummy_bw6
    asg = ref_da.dummy_app_assignment(CURVE, 9)
    host = RefGroth16(CURVE)
    want = host.prove(r1cs, kp.pk, asg, random.Random(77))
    timings = {}
    got = Groth16Torch(CURVE, device="cpu").prove(
        r1cs, kp.pk, asg, random.Random(77), timings=timings)
    assert (got.a, got.b, got.c) == (want.a, want.b, want.c)
    assert set(timings) == {"witness", "fft", "digitize", "msm", "assembly"}
    assert host.verify([9], got, kp.vk)
    assert not host.verify([10], got, kp.vk)


def test_from_reference_pk8_equals_pack_pk(dummy_bw6):
    r1cs, kp = dummy_bw6
    num_pub = r1cs.num_primary + 1
    ref = pack_pk8(CURVE, kp.pk, num_pub)
    arrays = {
        name: {k: np.asarray(v) for k, v in getattr(ref, name).items()}
        for name in QUERIES
    }
    points = {k: getattr(ref, k) for k in
              ("alpha_g1", "beta_g1", "beta_g2", "delta_g1", "delta_g2")}
    got = from_reference_pk8(arrays, CURVE, num_pub, points, device="cpu")
    want = pack_pk(CURVE, kp.pk, num_pub, device="cpu")
    assert (got.n_g1, got.n_g2) == (want.n_g1, want.n_g2) == (
        ref.n_g1, ref.n_g2)
    for name in QUERIES:
        assert torch.equal(getattr(got, name)["xy"], getattr(want, name)["xy"])
        assert torch.equal(getattr(got, name)["inf"],
                           getattr(want, name)["inf"])
    for k in points:
        assert getattr(got, k) == getattr(want, k)


def test_groth16_torch_bls12_377_cpu_equals_host_prover_and_verifies():
    """The nested curve: G2 over Fq2 through the msm4 route."""
    curve = "bls12-377"
    r1cs, kp = ref_da.dummy_app_setup(curve, random.Random(6))
    asg = ref_da.dummy_app_assignment(curve, 7)
    host = RefGroth16(curve)
    want = host.prove(r1cs, kp.pk, asg, random.Random(78))
    got = Groth16Torch(curve, device="cpu", engine="msm4").prove(
        r1cs, kp.pk, asg, random.Random(78))
    assert (got.a, got.b, got.c) == (want.a, want.b, want.c)
    assert host.verify([7], got, kp.vk)


def test_msm8_engine_equals_msm4_engine(dummy_bw6, monkeypatch):
    r1cs, kp = dummy_bw6
    asg = ref_da.dummy_app_assignment(CURVE, 9)
    proofs = {}
    for engine in ("msm4", "msm8"):
        timings = {}
        prover = Groth16Torch(CURVE, device="cpu", engine=engine)
        proofs[engine] = prover.prove(r1cs, kp.pk, asg, random.Random(77),
                                      timings=timings)
        assert set(timings) == {"witness", "fft", "digitize", "msm",
                                "assembly"}
    p4, p8 = proofs["msm4"], proofs["msm8"]
    assert (p8.a, p8.b, p8.c) == (p4.a, p4.b, p4.c)
    assert RefGroth16(CURVE).verify([9], p8, kp.vk)
    # engine=None reads ZECALE_USE_MSM8 as the reference prover does
    monkeypatch.delenv("ZECALE_USE_MSM8", raising=False)
    assert Groth16Torch(CURVE, device="cpu").engine == "msm4"
    monkeypatch.setenv("ZECALE_USE_MSM8", "1")
    assert Groth16Torch(CURVE, device="cpu").engine == "msm8"
    with pytest.raises(ValueError):
        Groth16Torch(CURVE, device="cpu", engine="msm5")


@pytest.mark.parametrize("curve", ["bw6-761", "bls12-377"])
def test_jac_engine_equals_host_prover_and_msm4_engine(curve):
    """The Jacobian engine (ec/msm_jac.py): the same rng state gives the
    host prover's proof and the msm4 engine's, bit for bit."""
    r1cs, kp = ref_da.dummy_app_setup(curve, random.Random(8))
    asg = ref_da.dummy_app_assignment(curve, 9)
    host = RefGroth16(curve)
    want = host.prove(r1cs, kp.pk, asg, random.Random(79))
    proofs = {}
    for engine in ("msm4", "jac"):
        timings = {}
        prover = Groth16Torch(curve, device="cpu", engine=engine)
        proofs[engine] = prover.prove(r1cs, kp.pk, asg, random.Random(79),
                                      timings=timings)
        assert set(timings) == {"witness", "fft", "digitize", "msm",
                                "assembly"}
    for got in proofs.values():
        assert (got.a, got.b, got.c) == (want.a, want.b, want.c)
    assert host.verify([9], proofs["jac"], kp.vk)


def test_from_reference_pk8_equals_pack_pk_bls12_377():
    """The Fq2 G2 query's (n, 2, 48) byte planes regroup into the port's
    (n, 2, 2, 12) limbs."""
    curve = "bls12-377"
    r1cs, kp = ref_da.dummy_app_setup(curve, random.Random(6))
    num_pub = r1cs.num_primary + 1
    ref = pack_pk8(curve, kp.pk, num_pub)
    arrays = {
        name: {k: np.asarray(v) for k, v in getattr(ref, name).items()}
        for name in QUERIES
    }
    points = {k: getattr(ref, k) for k in
              ("alpha_g1", "beta_g1", "beta_g2", "delta_g1", "delta_g2")}
    got = from_reference_pk8(arrays, curve, num_pub, points, device="cpu")
    want = pack_pk(curve, kp.pk, num_pub, device="cpu")
    assert want.b_g2_query["xy"].shape == (want.n_g2, 2, 2, 12)
    for name in QUERIES:
        assert torch.equal(getattr(got, name)["xy"], getattr(want, name)["xy"])
        assert torch.equal(getattr(got, name)["inf"],
                           getattr(want, name)["inf"])


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        assert resolve(None).type == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Groth16Torch(CURVE)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve(None)
    assert resolve("cpu").type == "cpu"


@pytest.mark.slow
def test_batch1_wrapper_prove_on_cpu():
    """The main path at full width on the CPU (plain versions): a batch-1
    BW6-761 wrapper over one BLS12-377 dummy-app proof.  Tens of minutes."""
    from zecale_tpu_torch.aggregator import dummy_app as da
    from zecale_tpu_torch.aggregator.circuit import AggregatorCircuit
    from zecale_tpu_torch.snark import setup_native
    from zecale_tpu_torch.snark.groth16 import Groth16

    rng = random.Random(11)
    _, nkp = da.dummy_app_setup("bls12-377", rng)
    eps = [da.dummy_app_prove("bls12-377", nkp, 7, rng)]
    circ = AggregatorCircuit(1, 1)
    wkp = setup_native.generate_setup(CURVE, circ.r1cs, rng)
    prover = Groth16Torch(CURVE, device="cpu")
    wep = circ.prove(nkp.vk, eps, wkp.pk, rng, prover=prover, check=True)
    assert Groth16(CURVE).verify(wep.inputs, wep.proof, wkp.vk)
    assert list(wep.inputs) == [circ.compute_nested_vk_hash(nkp.vk), 1, 7]
