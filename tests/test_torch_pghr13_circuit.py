"""The port's PGHR13 modules that are copies of the JAX package's
JAX-free ones, against the JAX package: the nested-PGHR13 verifier gadgets
(gadgets/pghr13_verifier.py, gadgets/mnt_pairing_gadget.py) in the MNT6-298
aggregator circuit, the PGHR13 wrapper option of the BW6-761 circuit, the
dummy application's PGHR13 keypair (snark/pghr13.py), and the native
pairing engine (native/pairing.py), which the port's verifiers now reach.
Tolerance: exact."""

import hashlib
import random

import pytest
import torch

from zecale_tpu.aggregator import circuit as ref_circuit
from zecale_tpu.aggregator import dummy_app as ref_da
from zecale_tpu.native import pairing as ref_npair
from zecale_tpu_torch.aggregator import circuit
from zecale_tpu_torch.aggregator import dummy_app as da
from zecale_tpu_torch.ec import host_curve as hc
from zecale_tpu_torch.native import pairing as npair
from zecale_tpu_torch.pairing import host_pairing
from zecale_tpu_torch.snark.groth16 import Groth16
from zecale_tpu_torch.snark.pghr13 import Pghr13

# One intra-op thread: the suite runs in several worker processes at
# once, and torch's OpenMP threads spinning in each of them slow every
# worker many times over.
torch.set_num_threads(1)


def _shape(r1cs):
    """Sizes and a digest of every A, B, C row of a constraint system."""
    digest = hashlib.sha256(repr(r1cs.constraints).encode()).hexdigest()
    return (r1cs.num_constraints, r1cs.num_variables, r1cs.num_primary,
            digest)


def test_nested_pghr13_circuit_matches_reference():
    kw = dict(wrapper_curve="mnt6-298", nested_snark="PGHR13")
    got = circuit.AggregatorCircuit(1, 1, **kw)
    want = ref_circuit.AggregatorCircuit(1, 1, **kw)
    assert _shape(got.r1cs) == _shape(want.r1cs)
    assert type(got.verifier).__name__ == "Pghr13VerifierGadget"
    assert got.wsnark.name == "GROTH16"


def test_pghr13_wrapper_option_gives_a_pghr13_wrapper_snark():
    got = circuit.AggregatorCircuit(1, 1, wrapper_snark="PGHR13",
                                    hash_nested_vk=False)
    assert isinstance(got.wsnark, Pghr13)
    assert got.wsnark.curve_name == "bw6-761"
    want = ref_circuit.AggregatorCircuit(1, 1, wrapper_snark="PGHR13",
                                         hash_nested_vk=False)
    assert _shape(got.r1cs)[:3] == _shape(want.r1cs)[:3]


@pytest.mark.parametrize("curve", ["bls12-377", "mnt4-298"])
def test_dummy_app_pghr13_keypair_and_proof_match_reference(curve):
    r1cs, kp = da.dummy_app_setup(curve, random.Random(5), snark="PGHR13")
    _, want = ref_da.dummy_app_setup(curve, random.Random(5), snark="PGHR13")
    assert kp.pk.__dict__ == want.pk.__dict__
    assert kp.vk.__dict__ == want.vk.__dict__
    ep = da.dummy_app_prove(curve, kp, 7, random.Random(6), snark="PGHR13")
    ep_ref = ref_da.dummy_app_prove(curve, want, 7, random.Random(6),
                                    snark="PGHR13")
    assert ep.proof.__dict__ == ep_ref.proof.__dict__
    assert ep.inputs == ep_ref.inputs == [7]
    assert Pghr13(curve).verify([7], ep.proof, kp.vk)
    assert not Pghr13(curve).verify([8], ep.proof, kp.vk)


ENGINES = {"bw6-761": (npair.bw6, ref_npair.bw6),
           "bls12-377": (npair.bls12, ref_npair.bls12),
           "mnt6-298": (lambda: npair.generic("mnt6-298"),
                        lambda: ref_npair.generic("mnt6-298"))}


@pytest.mark.parametrize("curve", list(ENGINES))
def test_native_pairing_agrees_with_reference(curve):
    port, ref = (make() for make in ENGINES[curve])
    assert port is not None and ref is not None
    g1, g2 = hc.g1_curve(curve), hc.g2_curve(curve)
    p, q = hc.generators(curve)
    rng = random.Random(8)
    a, b = rng.randrange(1, g1.order), rng.randrange(1, g1.order)
    pa, qb = g1.mul(a, p), g2.mul(b, q)
    good = [(pa, qb), (g1.neg(g1.mul(a * b, p)), q)]
    bad = [(pa, qb), (g1.neg(p), q)]
    for pairs, want in ((good, True), (bad, False)):
        assert port.pairing_product_is_one(pairs) is want
        assert ref.pairing_product_is_one(pairs) is want
    assert port.pairing_product([(pa, qb)]) == ref.pairing_product(
        [(pa, qb)])


def test_verifiers_reach_the_native_pairing(monkeypatch):
    curve = "bls12-377"
    calls = []
    orig = npair.NativeBLS12Pairing.pairing_product_is_one

    def spy(self, pairs):
        calls.append(len(pairs))
        return orig(self, pairs)

    def oracle(*_):
        raise AssertionError("the Python pairing oracle was used")

    monkeypatch.setattr(npair.NativeBLS12Pairing, "pairing_product_is_one",
                        spy)
    monkeypatch.setattr(host_pairing.PairingContext,
                        "pairing_product_is_one", oracle)
    _, kp = da.dummy_app_setup(curve, random.Random(1))
    ep = da.dummy_app_prove(curve, kp, 3, random.Random(2))
    assert Groth16(curve).verify([3], ep.proof, kp.vk)
    assert calls == [4]
    _, kp = da.dummy_app_setup(curve, random.Random(1), snark="PGHR13")
    ep = da.dummy_app_prove(curve, kp, 3, random.Random(2), snark="PGHR13")
    assert Pghr13(curve).verify([3], ep.proof, kp.vk)
    assert calls == [4, 2, 2, 2, 3, 3]
