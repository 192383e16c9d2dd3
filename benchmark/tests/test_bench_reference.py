"""The reference against the port's own host code, on the CPU: the
nested key's hash, the nested application's proofs (valid and off by one)
and their JSON, and the reference's trusted setup."""

import random

import pytest

from benchmark.reference import groth16 as ref
from benchmark.reference import params as P
from benchmark.reference import setup


def test_nested_app_proofs_and_hash_agree_with_the_port():
    from zecale_tpu_torch.gadgets import vk_hash as vkh
    from zecale_tpu_torch.serialization import json_codec as jc
    from zecale_tpu_torch.snark.groth16 import Groth16

    app = ref.NestedApp("bls12-377", 1, random.Random(11))
    vk = jc.groth16_vk_from_json("bls12-377",
                                 ref.vk_json("bls12-377", app.vk))
    wr = P.CURVES["bw6-761"].r
    assert ref.vk_hash("bls12-377", app.vk, wr) == vkh.compute_vk_hash(
        "bls12-377", vk, wr)
    rng = random.Random(12)
    x = rng.randrange(P.CURVES["bls12-377"].r)
    proof = app.prove([x], rng)
    port = Groth16("bls12-377")
    for inputs, want in (([x], True), ([x + 1], False)):
        ep = jc.extended_proof_from_json(
            "bls12-377", ref.ext_proof_json("bls12-377", proof, inputs))
        assert port.verify(ep.inputs, ep.proof, vk) is want
        assert ref.verify("bls12-377", app.vk, inputs, proof) is want
        p2, in2 = ref.ext_proof_from_json(
            jc.extended_proof_to_json("bls12-377", ep))
        assert (p2, in2) == (proof, inputs)


def test_bw6_simulated_proof_verifies_on_both_sides():
    from zecale_tpu_torch.snark.groth16 import (Groth16, Groth16Proof,
                                                Groth16VerificationKey)

    app = ref.NestedApp("bw6-761", 4, random.Random(13))
    xs = [3, 1, 5, 7]
    p = app.prove(xs, random.Random(14))
    vk = Groth16VerificationKey(alpha=app.vk.alpha, beta=app.vk.beta,
                                delta=app.vk.delta, abc=app.vk.abc)
    assert Groth16("bw6-761").verify(xs, Groth16Proof(p.a, p.b, p.c), vk)
    assert ref.verify("bw6-761", app.vk, xs, p)
    assert not ref.verify("bw6-761", app.vk, [3, 1, 5, 8], p)


def _squarings(curve, k):
    """x_0 public, x_{j+1} = x_j^2 for j < k: (R1CS, its assignment)."""
    from zecale_tpu_torch.snark.r1cs import R1CS

    r = P.CURVES[curve].r
    r1cs = R1CS(r=r, num_primary=1, num_aux=k)
    for j in range(k):
        r1cs.add_constraint([(1 + j, 1)], [(1 + j, 1)], [(2 + j, 1)])
    xs = [3]
    for _ in range(k):
        xs.append(xs[-1] ** 2 % r)
    return r1cs, [1] + xs


@pytest.mark.parametrize("curve", ["bls12-377", "bw6-761"])
def test_reference_setup_equals_the_ports_native_setup(curve):
    from zecale_tpu_torch.snark import setup_native

    r1cs, _ = _squarings(curve, 9)
    got = setup.generate(curve, r1cs.constraints, r1cs.num_primary,
                         r1cs.num_aux, random.Random(5))
    want = setup_native.generate_setup(curve, r1cs, random.Random(5))
    for k, v in got["pk"].items():
        assert v == getattr(want.pk, k), k
    vk = got["vk"]
    assert (vk.alpha, vk.beta, vk.delta, vk.abc) == (
        want.vk.alpha, want.vk.beta, want.vk.delta, want.vk.abc)


def test_port_proof_verifies_under_the_reference_key():
    from zecale_tpu_torch.snark.groth16 import Groth16, Groth16ProvingKey

    curve = "bw6-761"
    r1cs, z = _squarings(curve, 5)
    kp = setup.generate(curve, r1cs.constraints, r1cs.num_primary,
                        r1cs.num_aux, random.Random(6))
    proof = Groth16(curve).prove(r1cs, Groth16ProvingKey(**kp["pk"]), z,
                                 random.Random(7))
    p = ref.Proof(a=proof.a, b=proof.b, c=proof.c)
    assert ref.verify(curve, kp["vk"], [3], p)
    assert not ref.verify(curve, kp["vk"], [4], p)
