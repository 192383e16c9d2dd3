"""The rollup's nested application at full size (the joinsplit: 350,776
constraints, QAP domain 2^19), both tests slow.  On the CPU: one joinsplit
proved by the port's Groth16Torch with the plain PyTorch versions of its
kernels, against a keypair from the port's native C setup; the proof
verifies on the host verifier.  (The three engines' proofs are held equal
at this size on the card by chip_smoke.py [3m]; the msm8 engine, in 2
window chunks there, and the jac engine, with all its windows at once,
take many GB of device memory at n = 2^19 (PERF.md section 5), too much
for a CPU test.)  On the card (``cuda``; this file imports no
JAX): the device setup gives the native setup's keypair from one rng
state.  Tolerance: exact."""

import random
import time

import pytest
import torch

from zecale_tpu_torch.snark import setup_native
from zecale_tpu_torch.snark.groth16 import Groth16
from zecale_tpu_torch.snark.groth16_torch import Groth16Torch
from zecale_tpu_torch.zeth.dev_vectors import make_test_joinsplit
from zecale_tpu_torch.zeth.joinsplit import JoinsplitCircuit

# One intra-op thread: the suite runs in several worker processes at
# once, and torch's OpenMP threads spinning in each of them slow every
# worker many times over.
torch.set_num_threads(1)


@pytest.mark.slow
def test_joinsplit_proof_on_the_plain_versions_verifies():
    circ = JoinsplitCircuit()
    assert circ.r1cs.qap_degree == 1 << 19
    rng = random.Random(17)
    kp = setup_native.generate_setup("bls12-377", circ.r1cs, rng)
    w = circ.generate_witness(**make_test_joinsplit(random.Random(100)))
    assert circ.r1cs.first_failing_constraint(w) is None
    prover = Groth16Torch("bls12-377", device="cpu", engine="msm4")
    dpk = prover.pack_pk(kp.pk, circ.r1cs.num_primary + 1)
    proof = prover.prove(circ.r1cs, kp.pk, w, rng, device_pk=dpk)
    assert Groth16("bls12-377").verify(w[1:2], proof, kp.vk)


@pytest.mark.slow
@pytest.mark.cuda
def test_joinsplit_device_setup_equals_the_native_setup():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    r1cs = JoinsplitCircuit().r1cs
    timings = {}
    t0 = time.time()
    dev_kp = Groth16Torch("bls12-377").generate_setup(
        r1cs, random.Random(17), timings=timings)
    dev_s = time.time() - t0
    t0 = time.time()
    nat_kp = setup_native.generate_setup("bls12-377", r1cs,
                                         random.Random(17))
    nat_s = time.time() - t0
    print(f"joinsplit setup: device {dev_s:.1f}s "
          f"{ {k: round(v, 2) for k, v in timings.items()} }, "
          f"native {nat_s:.1f}s")
    assert dev_kp.pk == nat_kp.pk
    assert dev_kp.vk == nat_kp.vk
