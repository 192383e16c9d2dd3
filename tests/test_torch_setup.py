"""The device trusted setup, Groth16Torch.generate_setup
(zecale_tpu_torch/snark/groth16_torch.py: the fixed-base products as
windowed Jacobian scans, ec/msm_jac.py), on the CPU, where the kernels'
wrappers take their plain versions, against the native C setup
(zecale_tpu_torch/snark/setup_native.py) and the reference's host setup
(zecale_tpu/snark/groth16.py) from one rng state, for the BLS12-377
(G2 over Fq2) and BW6-761 dummy applications, and the batched
multiplications it is made of against the host curve.  Tolerance: exact --
every point of the two keypairs must be equal."""

import random

import pytest
import torch

from zecale_tpu.aggregator import dummy_app as ref_da
from zecale_tpu.snark.groth16 import Groth16 as RefGroth16
from zecale_tpu_torch.aggregator import dummy_app as da
from zecale_tpu_torch.ec import host_curve as hc
from zecale_tpu_torch.ff import params as P
from zecale_tpu_torch.snark import setup_native
from zecale_tpu_torch.snark.groth16_torch import Groth16Torch

# One intra-op thread: the suite runs in several worker processes at
# once, and torch's OpenMP threads spinning in each of them slow every
# worker many times over (a 13 s test took 695 s with four workers).
torch.set_num_threads(1)

PK = ("alpha_g1", "beta_g1", "beta_g2", "delta_g1", "delta_g2", "a_query",
      "b_g1_query", "b_g2_query", "l_query", "h_query")
VK = ("alpha", "beta", "delta", "abc")


def _fields(kp):
    return ({k: getattr(kp.pk, k) for k in PK},
            {k: getattr(kp.vk, k) for k in VK})


@pytest.mark.parametrize("curve", ["bls12-377", "bw6-761"])
def test_device_setup_equals_native_and_host_setup(curve):
    r1cs = da.dummy_app_r1cs(curve)
    got = Groth16Torch(curve, device="cpu").generate_setup(
        r1cs, random.Random(21))
    native = setup_native.generate_setup(curve, r1cs, random.Random(21))
    host = RefGroth16(curve).generate_setup(ref_da.dummy_app_r1cs(curve),
                                            random.Random(21))
    assert _fields(got) == _fields(native) == _fields(host)
    # and the keypair proves: the host prover and verifier accept it
    asg = ref_da.dummy_app_assignment(curve, 7)
    proof = RefGroth16(curve).prove(ref_da.dummy_app_r1cs(curve), host.pk,
                                    asg, random.Random(3))
    assert RefGroth16(curve).verify([7], proof, got.vk)


def test_batch_mul_g1_g2_against_host_curve():
    curve = "bls12-377"
    prover = Groth16Torch(curve, device="cpu")
    r = P.CURVES[curve].r
    rng = random.Random(5)
    ks = [0, 1, r - 1] + [rng.randrange(r) for _ in range(3)]
    g1, g2 = hc.generators(curve)
    assert prover.batch_mul_g1(ks) == [hc.g1_curve(curve).mul(k, g1)
                                       for k in ks]
    base = hc.g2_curve(curve).mul(3, g2)
    assert prover.batch_mul_g2(ks, base) == [hc.g2_curve(curve).mul(k, base)
                                             for k in ks]
    assert prover.batch_mul_g1([]) == []
