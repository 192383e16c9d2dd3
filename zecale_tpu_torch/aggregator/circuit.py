# Copied from zecale_tpu/aggregator/circuit.py (JAX-free); imports, build paths and the tracer's spans changed.
"""The aggregator (wrapper) circuit: one BW6-761 Groth16 proof attesting to
the verification of N nested BLS12-377 Groth16 proofs.

Primary-input layout, identical to the reference
(aggregator_circuit.hpp:18-31; the on-chain dispatcher depends on it,
ZecaleDispatcher.sol:56-74):

    [ nested_vk_hash, packed_results, nested_inputs[0][...], ...,
      nested_inputs[N-1][...] ]

packed_results bit i (LO first) is the verification result of the i-th
nested proof; invalid nested proofs are tolerated and simply yield bit 0
(aggregator_circuit.hpp:51-54, negative test aggregator_dummy_test.cpp:
141-187).
"""

from __future__ import annotations

import dataclasses
import random
from typing import List, Optional, Sequence

from ..ff import params as P
from ..gadgets import vk_hash as vkh
from ..gadgets.groth16_verifier import Groth16VerifierGadget
from ..gadgets.packing import pack_bits
from ..gadgets.protoboard import LC, Protoboard
from ..snark.groth16 import (
    ExtendedProof,
    Groth16,
    Groth16KeyPair,
    Groth16Proof,
    Groth16VerificationKey,
)
from ..utils import profiling


class AggregatorCircuit:
    """Wrapper circuit over BW6-761 verifying N BLS12-377 proofs.

    Reference analog: aggregator_circuit<wppT, wsnarkT, nverifierT, NumProofs>
    (aggregator_circuit.hpp:92-114).
    """

    def __init__(
        self,
        num_inputs_per_nested_proof: int,
        num_proofs: int,
        wrapper_curve: str = "bw6-761",
        hash_nested_vk: bool = True,
        nested_snark: str = "GROTH16",
        wrapper_snark: str = "GROTH16",
    ):
        """``hash_nested_vk=False`` replaces the MiMC vk-hash binding with a
        null hash (digest 0), like the reference's development-time
        null_hash_gadget (null_hash_gadget.hpp:11-14) -- the batch1.json
        golden vectors were produced in that mode.

        ``nested_snark`` selects the in-circuit verifier family (reference
        nverifierT trait: groth16_verifier_parameters /
        pghr13_verifier_parameters); ``wrapper_snark`` selects the snark the
        wrapping proof itself is produced with (reference wsnarkT,
        ZECALE_SNARK CMake option)."""
        assert num_inputs_per_nested_proof >= 1
        assert num_proofs >= 1
        nested, wrapper = P.CURVE_PAIRS[wrapper_curve]
        self.WRAPPER_CURVE = wrapper
        self.NESTED_CURVE = nested
        self.num_inputs = num_inputs_per_nested_proof
        self.num_proofs = num_proofs
        self.nested_snark = nested_snark.upper()
        self.wrapper_snark = wrapper_snark.upper()

        pb = Protoboard(P.CURVES[wrapper].r)
        self.pb = pb

        # --- primary inputs, in the documented order -------------------
        self._vk_hash_var = pb.allocate_primary()
        self._results_var = pb.allocate_primary()
        self._nested_input_vars = [
            pb.allocate_primary_array(num_inputs_per_nested_proof)
            for _ in range(num_proofs)
        ]
        pb.seal_primary()

        # --- verifier machinery ---------------------------------------
        if self.nested_snark == "GROTH16":
            self.verifier = Groth16VerifierGadget(pb, self.NESTED_CURVE)
        elif self.nested_snark == "PGHR13":
            from ..gadgets.pghr13_verifier import Pghr13VerifierGadget

            self.verifier = Pghr13VerifierGadget(pb, self.NESTED_CURVE)
        else:
            raise KeyError(f"unknown nested snark: {nested_snark}")
        self._vk_var = self.verifier.alloc_vk(num_inputs_per_nested_proof)
        self._proof_vars = [
            self.verifier.alloc_proof() for _ in range(num_proofs)
        ]

        # vk hash binds the witnessed vk to the primary input
        self.hash_nested_vk = hash_nested_vk
        digest = (
            vkh.vk_hash_gadget(pb, self._vk_var)
            if hash_nested_vk
            else LC()  # null hash: digest fixed to 0
        )
        pb.enforce_equal(digest, LC.of_var(self._vk_hash_var))
        self._hook_assign_primary(self._vk_hash_var, digest)

        # shared vk processing + per-proof online verification.  The hook
        # ranges of the N independent verifier witnesses are recorded so
        # generate_witness can replay them in parallel processes
        # (SURVEY.md section 2c "pipeline across proof batch").
        pvk = self.verifier.process_vk(self._vk_var)
        result_bits: List[LC] = []
        self._proof_hook_ranges: List[tuple] = []
        for i in range(num_proofs):
            input_lcs = [
                LC.of_var(v) for v in self._nested_input_vars[i]
            ]
            h0 = len(pb.witness_hooks)
            bit = self.verifier.verify(pvk, self._proof_vars[i], input_lcs)
            self._proof_hook_ranges.append((h0, len(pb.witness_hooks)))
            result_bits.append(bit)

        packed = pack_bits(pb, result_bits)
        pb.enforce_equal(packed, LC.of_var(self._results_var))
        self._hook_assign_primary(self._results_var, packed)

        self.r1cs = pb.to_r1cs()
        if self.wrapper_snark == "GROTH16":
            self.wsnark = Groth16(self.WRAPPER_CURVE)
        elif self.wrapper_snark == "PGHR13":
            from ..snark.pghr13 import Pghr13

            self.wsnark = Pghr13(self.WRAPPER_CURVE)
        else:
            raise KeyError(f"unknown wrapper snark: {wrapper_snark}")


    def _hook_assign_primary(self, var_idx: int, lc: LC) -> None:
        pb = self.pb

        def fn(w, _v=var_idx, _lc=lc, _pb=pb):
            w[_v] = _pb.lc_val(w, _lc)

        pb.add_hook(fn, op=("assign", var_idx, lc))

    # ------------------------------------------------------------------
    @property
    def num_primary_inputs(self) -> int:
        """1 (vk hash) + 1 (results) + N * inputs-per-proof
        (reference: aggregator_circuit.tcc:172-180)."""
        return 2 + self.num_proofs * self.num_inputs

    def get_constraint_system(self):
        return self.r1cs

    # ------------------------------------------------------------------
    def generate_trusted_setup(
        self, rng: Optional[random.Random] = None, prover=None
    ) -> Groth16KeyPair:
        if prover is not None:
            return prover.generate_setup(self.r1cs, rng)
        return self.wsnark.generate_setup(self.r1cs, rng)

    # ------------------------------------------------------------------
    def generate_witness(
        self,
        nested_vk: Groth16VerificationKey,
        nested_proofs: Sequence[ExtendedProof],
        parallel: Optional[bool] = None,
    ) -> List[int]:
        """Full wrapper assignment for a batch of nested extended proofs.

        ``parallel``: replay the N independent per-proof verifier witness
        programs in forked processes (SURVEY.md section 2c "pipeline
        across proof batch") — the witness phase stays ~flat in N instead
        of linear.  Default: the ZECALE_PARALLEL_WITNESS env var (off —
        fork from a threaded gRPC server is the caller's call)."""
        if len(nested_proofs) != self.num_proofs:
            raise ValueError(
                f"expected {self.num_proofs} proofs, got {len(nested_proofs)}"
            )
        for ep in nested_proofs:
            if len(ep.inputs) != self.num_inputs:
                # reference throws the same way (aggregator_circuit.tcc:138-141)
                raise ValueError(
                    "nested proof has wrong number of primary inputs"
                )
        if not self.verifier.check_vk_shape(nested_vk, self.num_inputs):
            raise ValueError("nested vk shape does not match input count")

        def extra(w):
            self.verifier.set_vk_witness(w, self._vk_var, nested_vk)
            for pvar, ep in zip(self._proof_vars, nested_proofs):
                self.verifier.set_proof_witness(w, pvar, ep.proof)
            for vars_i, ep in zip(self._nested_input_vars, nested_proofs):
                for v, val in zip(vars_i, ep.inputs):
                    # Fr<npp> -> Fr<wpp> embedding is the identity on ints
                    # (libff fp_from_fp analog, aggregator_dummy_test.cpp:93)
                    w[v] = val % self.pb.r

        if parallel is None:
            import os

            parallel = os.environ.get("ZECALE_PARALLEL_WITNESS") == "1"
        with profiling.span("circuit.witness"):
            return self.pb.generate_witness(
                [0] * self.pb.num_primary,
                extra_setter=extra,
                parallel_ranges=(
                    self._proof_hook_ranges if parallel else None
                ),
            )

    def prove(
        self,
        nested_vk: Groth16VerificationKey,
        nested_proofs: Sequence[ExtendedProof],
        wpk,
        rng: Optional[random.Random] = None,
        prover=None,
        check: bool = False,
    ) -> ExtendedProof:
        """Witness the batch and produce the wrapping proof
        (reference: aggregator_circuit.tcc:119-170), as the span
        ``circuit.prove``."""
        with profiling.span("circuit.prove"):
            w = self.generate_witness(nested_vk, nested_proofs)
            if check:
                bad = self.r1cs.first_failing_constraint(w)
                assert bad is None, f"wrapper witness fails constraint {bad}"
            primary = w[1 : 1 + self.pb.num_primary]
            if prover is not None:
                proof = prover.prove(self.r1cs, wpk, w, rng)
            else:
                proof = self.wsnark.prove(self.r1cs, wpk, w, rng)
            return ExtendedProof(proof=proof, inputs=primary)

    # ------------------------------------------------------------------
    def compute_nested_vk_hash(self, nested_vk: Groth16VerificationKey) -> int:
        if not getattr(self, "hash_nested_vk", True):
            return 0
        return vkh.compute_vk_hash(
            self.NESTED_CURVE, nested_vk, P.CURVES[self.WRAPPER_CURVE].r
        )
