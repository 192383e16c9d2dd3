"""Plain Groth16 of the benchmark's reference: verification, the nested
application's keys and proofs, and the JSON wire format.

Keys follow the convention of the system under test (gamma fixed to 1, so
a verification key is {alpha, beta, delta, ABC} and [gamma]_2 is the G2
generator).  Verification is the pairing product
e(A, B) e(-alpha, beta) e(-acc, [1]_2) e(-C, delta) == 1 with
acc = ABC_0 + sum_i x_i ABC_{i+1}, on the frozen native pairing.

The nested application is the dummy application of the upstream tests
(one public input).  Its proofs are made by the Groth16 simulator from the
setup's trapdoor: random A, B and C = (ab - alpha beta - acc) / delta,
which has the distribution of an honest prover's proofs, so the system
under test cannot tell them apart, and costs three scalar products a
proof.  Nothing here imports the system under test.
"""

from __future__ import annotations

import dataclasses
import random
from typing import List, Sequence

from . import host_curve as hc
from . import native_pairing as npg
from . import params as P
from .mimc import mimc_hash_inputs


@dataclasses.dataclass
class Proof:
    a: tuple
    b: tuple
    c: tuple


@dataclasses.dataclass
class VerificationKey:
    alpha: tuple
    beta: tuple
    delta: tuple
    abc: List[tuple]


def _pairing(curve: str):
    return npg.bw6() if curve == "bw6-761" else npg.bls12()


def verify(curve: str, vk: VerificationKey, inputs: Sequence[int],
           proof: Proof) -> bool:
    """Whether ``proof`` verifies for ``inputs`` under ``vk``."""
    g1, g2 = hc.g1_curve(curve), hc.g2_curve(curve)
    if len(inputs) + 1 != len(vk.abc):
        return False
    if not (g1.is_on_curve(proof.a) and g2.is_on_curve(proof.b)
            and g1.is_on_curve(proof.c)):
        return False
    r = P.CURVES[curve].r
    acc = vk.abc[0]
    for x, pt in zip(inputs, vk.abc[1:]):
        acc = g1.add(acc, g1.mul(x % r, pt))
    return _pairing(curve).pairing_product_is_one([
        (proof.a, proof.b),
        (g1.neg(vk.alpha), vk.beta),
        (g1.neg(acc), hc.generators(curve)[1]),
        (g1.neg(proof.c), vk.delta),
    ])


class NestedApp:
    """A Groth16 application with ``num_inputs`` public inputs, its
    verification key and trapdoor drawn from ``rng``."""

    def __init__(self, curve: str, num_inputs: int, rng: random.Random):
        self.curve = curve
        self.r = r = P.CURVES[curve].r
        self.g1, self.g2 = hc.g1_curve(curve), hc.g2_curve(curve)
        self.G1, self.G2 = hc.generators(curve)
        self._alpha, self._beta, self._delta = (
            rng.randrange(1, r) for _ in range(3))
        self._k = [rng.randrange(1, r) for _ in range(num_inputs + 1)]
        self.vk = VerificationKey(
            alpha=self.g1.mul(self._alpha, self.G1),
            beta=self.g2.mul(self._beta, self.G2),
            delta=self.g2.mul(self._delta, self.G2),
            abc=[self.g1.mul(k, self.G1) for k in self._k],
        )

    def prove(self, inputs: Sequence[int], rng: random.Random) -> Proof:
        """A proof that verifies for exactly ``inputs``."""
        r = self.r
        acc = (self._k[0] + sum(x * k for x, k in zip(inputs, self._k[1:])))
        a, b = rng.randrange(1, r), rng.randrange(1, r)
        c = ((a * b - self._alpha * self._beta - acc)
             * pow(self._delta, -1, r) % r)
        return Proof(a=self.g1.mul(a, self.G1), b=self.g2.mul(b, self.G2),
                     c=self.g1.mul(c, self.G1))


def vk_hash(nested_curve: str, vk: VerificationKey, wrapper_r: int) -> int:
    """MiMC over the wrapper's scalar field of the nested key's
    coordinates: alpha, beta, delta, then each ABC point, x before y,
    extension coefficients low first."""
    vals: List[int] = []
    for pt in [vk.alpha, vk.beta, vk.delta, *vk.abc]:
        for coord in pt:
            vals += list(coord) if isinstance(coord, tuple) else [coord]
    return mimc_hash_inputs(vals, wrapper_r)


# -- the JSON wire format: "0x" big-endian hex, zero-padded to the field's
# -- bytes; an extension element is a list of coefficients, HIGH first

def _fq(curve: str, v: int) -> str:
    return "0x" + v.to_bytes(P.CURVES[curve].coord_bytes, "big").hex()


def fr_json(curve: str, v: int) -> str:
    return "0x" + v.to_bytes(P.CURVES[curve].scalar_bytes, "big").hex()


def _coord_json(curve: str, v):
    if isinstance(v, tuple):
        return [_fq(curve, c) for c in reversed(v)]
    return _fq(curve, v)


def _coord(j):
    if isinstance(j, list):
        return tuple(int(c, 16) for c in reversed(j))
    return int(j, 16)


def point_json(curve: str, pt) -> list:
    return [_coord_json(curve, pt[0]), _coord_json(curve, pt[1])]


def point(j) -> tuple:
    return (_coord(j[0]), _coord(j[1]))


def vk_json(curve: str, vk: VerificationKey) -> dict:
    return {"alpha": point_json(curve, vk.alpha),
            "beta": point_json(curve, vk.beta),
            "delta": point_json(curve, vk.delta),
            "ABC": [point_json(curve, p) for p in vk.abc]}


def vk_from_json(j: dict) -> VerificationKey:
    return VerificationKey(alpha=point(j["alpha"]), beta=point(j["beta"]),
                           delta=point(j["delta"]),
                           abc=[point(p) for p in j["ABC"]])


def ext_proof_json(curve: str, proof: Proof, inputs: Sequence[int]) -> dict:
    return {"proof": {"a": point_json(curve, proof.a),
                      "b": point_json(curve, proof.b),
                      "c": point_json(curve, proof.c)},
            "inputs": [fr_json(curve, x) for x in inputs]}


def ext_proof_from_json(j: dict) -> tuple:
    """(Proof, inputs) of an extended proof's JSON."""
    p = j["proof"]
    return (Proof(a=point(p["a"]), b=point(p["b"]), c=point(p["c"])),
            [int(x, 16) for x in j["inputs"]])
