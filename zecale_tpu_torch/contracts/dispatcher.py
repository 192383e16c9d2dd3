# Copied from zecale_tpu/contracts/dispatcher.py (JAX-free); unchanged but for this line.
"""On-chain settlement layer: EVM word-level encodings + a dispatcher
engine with the exact semantics of the reference contracts.

The reference settles batches via ZecaleDispatcher.sol (process_batch:
length checks -> Groth16BW6_761.verify -> per-proof result-bit extraction ->
IZecaleApplication.dispatch; ZecaleDispatcher.sol:79-169) against an EVM
fork with BW6-761 precompiles.  No such EVM exists in this environment, so
this module provides:

  * the calldata encodings (uint256-word layouts identical to the
    reference's client: Fr = 2 words, Fq = 3 words, G1/G2 = 6 words,
    proof = 18 words, vk = [alpha, -beta, -delta, abc...];
    contracts/Groth16BW6_761.sol:9-14,36-43 and
    client/zecale/core/dispatcher_contract.py:62-94), and
  * ``DispatcherEngine``: a word-for-word executable model of
    process_batch + the dummy application, verified against the golden
    batch vectors, standing in for the ganache-based end-to-end test
    (scripts/test-client).

Fresh Solidity sources implementing the same layouts live in
contracts/ at the repo root for real-chain deployment.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

from ..ff import params as P
from ..snark.groth16 import ExtendedProof, Groth16, Groth16VerificationKey

WORD = 1 << 256
FR_WORDS = 2  # BW6-761 Fr (377 bits)
FQ_WORDS = 3  # BW6-761 Fq (761 bits)
POINT_WORDS = 2 * FQ_WORDS
PROOF_WORDS = 3 * POINT_WORDS  # a, b, c


def _int_to_words(v: int, n: int) -> List[int]:
    """Big-endian uint256 word split (HO word first)."""
    out = []
    for i in range(n - 1, -1, -1):
        out.append((v >> (256 * i)) % WORD)
    return out


def _words_to_int(words: Sequence[int]) -> int:
    acc = 0
    for w in words:
        acc = (acc << 256) | w
    return acc


def point_to_words(pt) -> List[int]:
    assert pt is not None
    return _int_to_words(pt[0], FQ_WORDS) + _int_to_words(pt[1], FQ_WORDS)


def words_to_point(words: Sequence[int]) -> tuple:
    return (
        _words_to_int(words[:FQ_WORDS]),
        _words_to_int(words[FQ_WORDS : 2 * FQ_WORDS]),
    )


def proof_to_contract_parameters(proof) -> List[int]:
    """18 uint256 words [a, b, c] (reference dispatcher_contract.py:77)."""
    return (
        point_to_words(proof.a)
        + point_to_words(proof.b)
        + point_to_words(proof.c)
    )


def inputs_to_contract_parameters(inputs: Sequence[int]) -> List[int]:
    """Each wrapper Fr input as (HO, LO) uint256 pair."""
    out: List[int] = []
    for v in inputs:
        out.extend(_int_to_words(v, FR_WORDS))
    return out


def vk_to_contract_parameters(vk: Groth16VerificationKey) -> List[int]:
    """[alpha, -beta, -delta, abc...] (Groth16BW6_761.sol:36-43)."""
    from ..ec import host_curve as hc

    g2 = hc.g2_curve("bw6-761")
    words = point_to_words(vk.alpha)
    words += point_to_words(g2.neg(vk.beta))
    words += point_to_words(g2.neg(vk.delta))
    for pt in vk.abc:
        words += point_to_words(pt)
    return words


def num_inputs_from_vk_length(vk_words: int) -> int:
    """(len - 3 points) / point - 1 (Groth16BW6_761.sol:267-272)."""
    return (vk_words - 3 * POINT_WORDS) // POINT_WORDS - 1


class Groth16BW6Verifier:
    """Word-level model of the Groth16BW6_761 library contract: decodes the
    vk/proof/input words and runs the pairing check the precompiles would
    (e(a,b) e(accum,-g2) e(alpha,-beta) e(c,-delta) == 1)."""

    def __init__(self):
        self.snark = Groth16("bw6-761")
        self.g2 = self.snark.g2
        self.g1 = self.snark.g1

    def verify(
        self,
        vk_words: Sequence[int],
        proof_words: Sequence[int],
        input_words: Sequence[int],
    ) -> bool:
        n_inputs = num_inputs_from_vk_length(len(vk_words))
        if len(input_words) != FR_WORDS * n_inputs:
            return False
        alpha = words_to_point(vk_words[0:POINT_WORDS])
        minus_beta = words_to_point(vk_words[POINT_WORDS : 2 * POINT_WORDS])
        minus_delta = words_to_point(
            vk_words[2 * POINT_WORDS : 3 * POINT_WORDS]
        )
        abc = [
            words_to_point(
                vk_words[(3 + i) * POINT_WORDS : (4 + i) * POINT_WORDS]
            )
            for i in range(n_inputs + 1)
        ]
        a = words_to_point(proof_words[0:POINT_WORDS])
        b = words_to_point(proof_words[POINT_WORDS : 2 * POINT_WORDS])
        c = words_to_point(proof_words[2 * POINT_WORDS : 3 * POINT_WORDS])
        inputs = [
            _words_to_int(input_words[FR_WORDS * i : FR_WORDS * (i + 1)])
            for i in range(n_inputs)
        ]
        from ..snark.groth16 import Groth16Proof

        vk = Groth16VerificationKey(
            alpha=alpha,
            beta=self.g2.neg(minus_beta),
            delta=self.g2.neg(minus_delta),
            abc=abc,
        )
        return self.snark.verify(inputs, Groth16Proof(a, b, c), vk)


@dataclasses.dataclass
class DispatchCall:
    vk_hash: int
    inputs: List[int]
    parameters: bytes


class DummyApplicationEngine:
    """Model of DummyApplication.sol: records scalar -> parameters, enforcing
    permitted-dispatcher, vk-hash and replay checks
    (DummyApplication.sol:35-61)."""

    def __init__(self, dispatcher, expected_vk_hash: int):
        self.dispatcher = dispatcher
        self.expected_vk_hash = expected_vk_hash
        self.scalars: Dict[int, bytes] = {}

    def dispatch(self, caller, call: DispatchCall) -> None:
        assert caller is self.dispatcher, "not the permitted dispatcher"
        assert call.vk_hash == self.expected_vk_hash, "wrong vk hash"
        scalar = call.inputs[0]
        assert scalar not in self.scalars, "scalar already seen"
        self.scalars[scalar] = call.parameters

    def get(self, scalar: int) -> Optional[bytes]:
        return self.scalars.get(scalar)


class DispatcherEngine:
    """Model of ZecaleDispatcher.process_batch (ZecaleDispatcher.sol:79-169),
    parameterized by batch size (the reference hard-codes 2)."""

    def __init__(self, vk_words: Sequence[int], batch_size: int = 2):
        self.vk_words = list(vk_words)
        self.batch_size = batch_size
        self.verifier = Groth16BW6Verifier()
        total_inputs = num_inputs_from_vk_length(len(self.vk_words))
        # -2 for vk_hash and results (ZecaleDispatcher.sol:44-50)
        self.inputs_per_nested_tx = (total_inputs - 2) // batch_size
        self.applications: Dict[str, DummyApplicationEngine] = {}
        self.events: List[tuple] = []

    def register_application(self, app) -> None:
        self.applications[id(app)] = app

    def process_batch(
        self,
        proof_words: Sequence[int],
        input_words: Sequence[int],
        nested_parameters: Sequence[bytes],
        app: DummyApplicationEngine,
    ) -> bool:
        if len(proof_words) != PROOF_WORDS:
            raise ValueError("bad proof length")
        expect_inputs = FR_WORDS * (
            2 + self.batch_size * self.inputs_per_nested_tx
        )
        if len(input_words) != expect_inputs:
            raise ValueError("bad inputs length")
        if len(nested_parameters) != self.batch_size:
            raise ValueError("bad parameters length")

        if not self.verifier.verify(self.vk_words, proof_words, input_words):
            self.events.append(("log", "invalid batch proof", 0))
            return False

        vk_hash = _words_to_int(input_words[0:FR_WORDS])
        results = _words_to_int(input_words[FR_WORDS : 2 * FR_WORDS])
        off = 2 * FR_WORDS
        for i in range(self.batch_size):
            bit = (results >> i) & 1
            nested_inputs = []
            for j in range(self.inputs_per_nested_tx):
                # LO word only, like the dispatcher's copy of the LO words
                # (ZecaleDispatcher.sol:122-161)
                words = input_words[off : off + FR_WORDS]
                nested_inputs.append(words[1])
                off += FR_WORDS
            if not bit:
                self.events.append(("log", "skipping invalid proof", i))
                continue
            app.dispatch(
                self,
                DispatchCall(
                    vk_hash=vk_hash,
                    inputs=nested_inputs,
                    parameters=nested_parameters[i],
                ),
            )
        return True
