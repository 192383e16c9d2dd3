# Copied from zecale_tpu/serialization/json_codec.py (JAX-free); only the docstrings changed.
"""JSON encode/decode for field elements, curve points, proofs and keys.

The wire format matches the reference's libzeth JSON conventions so that the
golden vectors of the reference's ``testdata/dummy_app`` round-trip bit-exactly:

  * prime-field element: "0x" + big-endian hex, zero-padded to the field's
    byte length (48 bytes for BLS12-377 Fq, 96 for BW6-761 Fq, 32 for
    BLS12-377 Fr, ...), as in testdata/dummy_app/vk.json.
  * extension-field element: JSON array [c0, c1, ...] low coefficient first
    (empirically validated against the G2 points of the golden vectors by
    on-curve checks; see tests/test_golden_vectors.py).
  * G1 point: [x, y]; G2 point: [x, y] with coords as above.
  * Groth16 proof: {"a": G1, "b": G2, "c": G1}
    (testdata/dummy_app/extproof1.json).
  * Groth16 verification key: {"alpha": G1, "beta": G2, "delta": G2,
    "ABC": [G1...]} (testdata/dummy_app/vk.json); gamma is fixed to 1 so
    [gamma]_2 is the G2 generator.
  * extended proof: {"proof": ..., "inputs": [Fr hex...]}.
"""

from __future__ import annotations

from typing import Any, List, Sequence

from ..ff import host_field as hf
from ..ff import params as P

# ---------------------------------------------------------------------------
# field elements
# ---------------------------------------------------------------------------


def int_to_hex(v: int, num_bytes: int) -> str:
    return "0x" + v.to_bytes(num_bytes, "big").hex()


def hex_to_int(s: str) -> int:
    return int(s, 16)


def fq_to_json(curve_name: str, v: int) -> str:
    return int_to_hex(v, P.CURVES[curve_name].coord_bytes)


def fr_to_json(curve_name: str, v: int) -> str:
    return int_to_hex(v, P.CURVES[curve_name].scalar_bytes)


def ext_to_json(curve_name: str, v) -> Any:
    """Encode a G2-coordinate field element (prime or extension).

    Extension coefficients are listed HIGH-first in the JSON (libzeth
    convention, validated empirically: testdata G2 points only lie on the
    twist when parsed [c1, c0]).
    """
    if isinstance(v, tuple):
        return [fq_to_json(curve_name, c) for c in reversed(v)]
    return fq_to_json(curve_name, v)


def ext_from_json(curve_name: str, j) -> Any:
    if isinstance(j, list):
        return tuple(hex_to_int(c) for c in reversed(j))
    return hex_to_int(j)


# ---------------------------------------------------------------------------
# points
# ---------------------------------------------------------------------------


def g1_to_json(curve_name: str, pt) -> List[str]:
    assert pt is not None, "cannot serialize the point at infinity"
    return [fq_to_json(curve_name, pt[0]), fq_to_json(curve_name, pt[1])]


def g1_from_json(curve_name: str, j) -> tuple:
    return (hex_to_int(j[0]), hex_to_int(j[1]))


def g2_to_json(curve_name: str, pt) -> List[Any]:
    assert pt is not None, "cannot serialize the point at infinity"
    return [ext_to_json(curve_name, pt[0]), ext_to_json(curve_name, pt[1])]


def g2_from_json(curve_name: str, j) -> tuple:
    return (ext_from_json(curve_name, j[0]), ext_from_json(curve_name, j[1]))


# ---------------------------------------------------------------------------
# Groth16 proof / keys / extended proofs
# ---------------------------------------------------------------------------


def groth16_proof_to_json(curve_name: str, proof) -> dict:
    return {
        "a": g1_to_json(curve_name, proof.a),
        "b": g2_to_json(curve_name, proof.b),
        "c": g1_to_json(curve_name, proof.c),
    }


def groth16_proof_from_json(curve_name: str, j: dict):
    from ..snark.groth16 import Groth16Proof

    return Groth16Proof(
        a=g1_from_json(curve_name, j["a"]),
        b=g2_from_json(curve_name, j["b"]),
        c=g1_from_json(curve_name, j["c"]),
    )


def groth16_vk_to_json(curve_name: str, vk) -> dict:
    return {
        "alpha": g1_to_json(curve_name, vk.alpha),
        "beta": g2_to_json(curve_name, vk.beta),
        "delta": g2_to_json(curve_name, vk.delta),
        "ABC": [g1_to_json(curve_name, p) for p in vk.abc],
    }


def groth16_vk_from_json(curve_name: str, j: dict):
    from ..snark.groth16 import Groth16VerificationKey

    return Groth16VerificationKey(
        alpha=g1_from_json(curve_name, j["alpha"]),
        beta=g2_from_json(curve_name, j["beta"]),
        delta=g2_from_json(curve_name, j["delta"]),
        abc=[g1_from_json(curve_name, p) for p in j["ABC"]],
    )


def extended_proof_to_json(
    curve_name: str, ext_proof, snark: str = "GROTH16"
) -> dict:
    proof_to, _, _, _ = snark_codec(snark)
    return {
        "proof": proof_to(curve_name, ext_proof.proof),
        "inputs": [fr_to_json(curve_name, v) for v in ext_proof.inputs],
    }


def extended_proof_from_json(curve_name: str, j: dict, snark: str = "GROTH16"):
    from ..snark.groth16 import ExtendedProof

    _, proof_from, _, _ = snark_codec(snark)
    return ExtendedProof(
        proof=proof_from(curve_name, j["proof"]),
        inputs=[hex_to_int(v) for v in j["inputs"]],
    )


# ---------------------------------------------------------------------------
# PGHR13 proof / keys (zeth pghr13 JSON naming)
# ---------------------------------------------------------------------------


def pghr13_proof_to_json(curve_name: str, proof) -> dict:
    return {
        "a": g1_to_json(curve_name, proof.a),
        "a_p": g1_to_json(curve_name, proof.a_p),
        "b": g2_to_json(curve_name, proof.b),
        "b_p": g1_to_json(curve_name, proof.b_p),
        "c": g1_to_json(curve_name, proof.c),
        "c_p": g1_to_json(curve_name, proof.c_p),
        "h": g1_to_json(curve_name, proof.h),
        "k": g1_to_json(curve_name, proof.k),
    }


def pghr13_proof_from_json(curve_name: str, j: dict):
    from ..snark.pghr13 import Pghr13Proof

    return Pghr13Proof(
        a=g1_from_json(curve_name, j["a"]),
        a_p=g1_from_json(curve_name, j["a_p"]),
        b=g2_from_json(curve_name, j["b"]),
        b_p=g1_from_json(curve_name, j["b_p"]),
        c=g1_from_json(curve_name, j["c"]),
        c_p=g1_from_json(curve_name, j["c_p"]),
        h=g1_from_json(curve_name, j["h"]),
        k=g1_from_json(curve_name, j["k"]),
    )


def pghr13_vk_to_json(curve_name: str, vk) -> dict:
    return {
        "a": g2_to_json(curve_name, vk.a),
        "b": g1_to_json(curve_name, vk.b),
        "c": g2_to_json(curve_name, vk.c),
        "g": g2_to_json(curve_name, vk.g),
        "gb1": g1_to_json(curve_name, vk.gb1),
        "gb2": g2_to_json(curve_name, vk.gb2),
        "z": g2_to_json(curve_name, vk.z),
        "IC": [g1_to_json(curve_name, p) for p in vk.ic],
    }


def pghr13_vk_from_json(curve_name: str, j: dict):
    from ..snark.pghr13 import Pghr13VerificationKey

    return Pghr13VerificationKey(
        a=g2_from_json(curve_name, j["a"]),
        b=g1_from_json(curve_name, j["b"]),
        c=g2_from_json(curve_name, j["c"]),
        g=g2_from_json(curve_name, j["g"]),
        gb1=g1_from_json(curve_name, j["gb1"]),
        gb2=g2_from_json(curve_name, j["gb2"]),
        z=g2_from_json(curve_name, j["z"]),
        ic=[g1_from_json(curve_name, p) for p in j["IC"]],
    )


# ---------------------------------------------------------------------------
# snark provider registry (reference analog: zeth IZKSnarkProvider naming,
# aggregator_config.py:11-47 resolves providers by name)
# ---------------------------------------------------------------------------


def snark_codec(snark_name: str):
    """(proof_to, proof_from, vk_to, vk_from) for GROTH16 / PGHR13."""
    name = snark_name.upper()
    if name == "GROTH16":
        return (
            groth16_proof_to_json,
            groth16_proof_from_json,
            groth16_vk_to_json,
            groth16_vk_from_json,
        )
    if name == "PGHR13":
        return (
            pghr13_proof_to_json,
            pghr13_proof_from_json,
            pghr13_vk_to_json,
            pghr13_vk_from_json,
        )
    raise KeyError(snark_name)
