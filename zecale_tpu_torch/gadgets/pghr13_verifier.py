# Copied from zecale_tpu/gadgets/pghr13_verifier.py (JAX-free); only imports and build paths changed.
"""In-circuit PGHR13 (Pinocchio / BCTV14) verifier for nested proofs.

Reference analog: libsnark's ``r1cs_ppzksnark_*`` verifier-gadget family
selected by ``pghr13_verifier_parameters`` (pghr13_verifier_parameters.hpp:
14-31).  The reference notes those gadgets only work with MNT curves
(aggregator_dummy_test.cpp:225-228); this implementation is derived from the
scheme's algebra on top of our generic pairing gadgets, so it runs on either
curve pair, with MNT4-298 nested inside MNT6-298 as the parity
configuration.

Verification relation (same 5 pairing-product checks as
``zecale_tpu.snark.pghr13.Pghr13.verify``), with
``acc = IC_0 + sum_j input_j * IC_{j+1}``:

    1. e(A,  alphaA_g2) * e(-A', g2)                                == 1
    2. e(alphaB_g1, B)  * e(-B', g2)                                == 1
    3. e(C,  alphaC_g2) * e(-C', g2)                                == 1
    4. e(K,  gamma_g2)  * e(-(acc+A+C), gamma_beta_g2)
                        * e(-gamma_beta_g1, B)                      == 1
    5. e(acc+A, B)      * e(-H, rC_Z_g2) * e(-C, g2)                == 1

Like the Groth16 gadget (and the reference, aggregator_circuit.hpp:51-54),
verification emits a RESULT BIT (the AND of the five checks) rather than
constraining validity, so invalid nested proofs are tolerated.  Proof points
get in-circuit on-curve checks; VK points are bound by the MiMC vk hash.

The mixed-group knowledge commitments (A', B', C', K in G1 while B is in G2)
map onto the merged multi-pairing gadget unchanged: every pair is
(precomputed-G2-line-chain, G1 point).  VK G2 chains are precomputed once
per batch in ``process_vk`` (reference mirrors this sharing with
process_verification_key_gadget, aggregator_gadget.tcc:27-28); the
G2-generator chain is host-precomputed constants (zero constraint cost).
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence

from ..ec import host_curve as hc
from ..ff import params as P
from .curve_ops import CurveGadget
from .field_ext import gadget_towers
from .packing import unpack_bits
from .protoboard import LC, Protoboard


@dataclasses.dataclass
class Pghr13VkVariable:
    """Allocated PGHR13 verification-key variables (zeth naming)."""

    a: tuple  # alphaA in G2
    b: tuple  # alphaB in G1
    c: tuple  # alphaC in G2
    g: tuple  # gamma in G2
    gb1: tuple  # gamma*beta in G1
    gb2: tuple  # gamma*beta in G2
    z: tuple  # rC*Z(t) in G2
    ic: List[tuple]  # G1 list

    def points(self) -> List[tuple]:
        """Hash/coordinate order (documented contract, see vk_hash.py)."""
        return [self.a, self.b, self.c, self.g, self.gb1, self.gb2,
                self.z, *self.ic]


@dataclasses.dataclass
class Pghr13ProofVariable:
    a: tuple  # G1
    a_p: tuple  # G1
    b: tuple  # G2
    b_p: tuple  # G1
    c: tuple  # G1
    c_p: tuple  # G1
    h: tuple  # G1
    k: tuple  # G1


@dataclasses.dataclass
class Pghr13ProcessedVk:
    vk: Pghr13VkVariable
    a_chain: list  # alphaA_g2
    c_chain: list  # alphaC_g2
    g_chain: list  # gamma_g2
    gb2_chain: list  # gamma_beta_g2
    z_chain: list  # rC_Z_g2
    gen_chain: list  # constant G2 generator


def pghr13_vk_host_points(host_vk) -> List[object]:
    """Host-side points in the same order as Pghr13VkVariable.points()."""
    return [host_vk.a, host_vk.b, host_vk.c, host_vk.g, host_vk.gb1,
            host_vk.gb2, host_vk.z, *host_vk.ic]


class Pghr13VerifierGadget:
    """Nested PGHR13 verification arithmetized over the wrapper scalar
    field.  Interface-identical to Groth16VerifierGadget so the aggregator
    circuit treats snark choice as a trait (reference nverifierT)."""

    snark_name = "PGHR13"

    def __init__(self, pb: Protoboard, nested_curve: str = "mnt4-298"):
        self.NESTED_CURVE = nested_curve
        assert pb.r == P.CURVES[nested_curve].q, (
            "wrapper scalar field must equal the nested base field"
        )
        self.pb = pb
        self.towers = gadget_towers(pb, nested_curve)
        if nested_curve == "mnt4-298":
            from .mnt_pairing_gadget import MNT4PairingGadget

            self.pairing = MNT4PairingGadget(pb, self.towers)
        elif nested_curve == "bls12-377":
            from .pairing_gadget import BLS12PairingGadget

            self.pairing = BLS12PairingGadget(pb, self.towers)
        else:
            raise KeyError(nested_curve)
        host_g1 = hc.g1_curve(nested_curve)
        self.host_g1 = host_g1
        self.host_g2 = hc.g2_curve(nested_curve)
        self.g1_gadget = CurveGadget(self.towers["fq"], host_g1.a, host_g1.b)
        self.g2_gadget = self.pairing.g2_gadget
        self.scalar_bits = P.CURVES[nested_curve].r.bit_length()

        # MSM offset point (same dummy-offset trick as the Groth16 gadget)
        self._offset_D = host_g1._mul_raw(
            0xD00D_F00D_0BADBEEF, hc.generators(nested_curve)[0]
        )
        self._offset_final = host_g1._mul_raw(
            1 << self.scalar_bits, self._offset_D
        )

    # ------------------------------------------------------------------
    # variable allocation + witness setters
    # ------------------------------------------------------------------
    def alloc_vk(self, num_inputs: int) -> Pghr13VkVariable:
        g1a = self.g1_gadget.alloc_point
        g2a = self.g2_gadget.alloc_point
        return Pghr13VkVariable(
            a=g2a(), b=g1a(), c=g2a(), g=g2a(), gb1=g1a(), gb2=g2a(),
            z=g2a(), ic=[g1a() for _ in range(num_inputs + 1)],
        )

    def check_vk_shape(self, host_vk, num_inputs: int) -> bool:
        return len(host_vk.ic) == num_inputs + 1

    def set_vk_witness(self, w, vkvar: Pghr13VkVariable, host_vk) -> None:
        g1s, g2s = (self.g1_gadget.set_point_witness,
                    self.g2_gadget.set_point_witness)
        g2s(w, vkvar.a, host_vk.a)
        g1s(w, vkvar.b, host_vk.b)
        g2s(w, vkvar.c, host_vk.c)
        g2s(w, vkvar.g, host_vk.g)
        g1s(w, vkvar.gb1, host_vk.gb1)
        g2s(w, vkvar.gb2, host_vk.gb2)
        g2s(w, vkvar.z, host_vk.z)
        assert len(host_vk.ic) == len(vkvar.ic)
        for var, pt in zip(vkvar.ic, host_vk.ic):
            g1s(w, var, pt)

    def alloc_proof(self) -> Pghr13ProofVariable:
        g1a = self.g1_gadget.alloc_point
        return Pghr13ProofVariable(
            a=g1a(), a_p=g1a(), b=self.g2_gadget.alloc_point(), b_p=g1a(),
            c=g1a(), c_p=g1a(), h=g1a(), k=g1a(),
        )

    def set_proof_witness(self, w, pvar: Pghr13ProofVariable, host_proof) -> None:
        g1s = self.g1_gadget.set_point_witness
        g1s(w, pvar.a, host_proof.a)
        g1s(w, pvar.a_p, host_proof.a_p)
        self.g2_gadget.set_point_witness(w, pvar.b, host_proof.b)
        g1s(w, pvar.b_p, host_proof.b_p)
        g1s(w, pvar.c, host_proof.c)
        g1s(w, pvar.c_p, host_proof.c_p)
        g1s(w, pvar.h, host_proof.h)
        g1s(w, pvar.k, host_proof.k)

    # ------------------------------------------------------------------
    # vk processing (shared per batch)
    # ------------------------------------------------------------------
    def process_vk(self, vkvar: Pghr13VkVariable) -> Pghr13ProcessedVk:
        pre = self.pairing.g2_precompute
        _, g2gen = hc.generators(self.NESTED_CURVE)
        return Pghr13ProcessedVk(
            vk=vkvar,
            a_chain=pre(vkvar.a),
            c_chain=pre(vkvar.c),
            g_chain=pre(vkvar.g),
            gb2_chain=pre(vkvar.gb2),
            z_chain=pre(vkvar.z),
            gen_chain=self.pairing.g2_precompute_const(g2gen),
        )

    # ------------------------------------------------------------------
    # online verification (per proof)
    # ------------------------------------------------------------------
    def verify(
        self,
        pvk: Pghr13ProcessedVk,
        proof: Pghr13ProofVariable,
        input_lcs: Sequence[LC],
    ) -> LC:
        """Emit the result bit (AND of the 5 pairing checks)."""
        pb = self.pb
        g1 = self.g1_gadget

        # on-curve checks for all 8 proof points (constrained, not gated)
        for pt in (proof.a, proof.a_p, proof.b_p, proof.c, proof.c_p,
                   proof.h, proof.k):
            g1.enforce_on_curve(pt)
        self.g2_gadget.enforce_on_curve(proof.b)

        # acc = IC_0 + sum_j input_j * IC_{j+1}
        bit_lists = [unpack_bits(pb, lc, self.scalar_bits) for lc in input_lcs]
        assert len(bit_lists) + 1 == len(pvk.vk.ic)
        msm = g1.msm_with_offset(
            pvk.vk.ic[1:], bit_lists, self._offset_D, self._offset_final
        )
        acc = g1.add_unequal(msm, pvk.vk.ic[0])

        b_chain = self.pairing.g2_precompute(proof.b)
        result_of = self.pairing.pairing_product_result
        one_bit = self.pairing.is_one_bit

        # 1. e(A, alphaA_g2) * e(-A', g2)
        bit1 = one_bit(result_of(
            [(pvk.a_chain, proof.a), (pvk.gen_chain, g1.neg(proof.a_p))]
        ))
        # 2. e(alphaB_g1, B) * e(-B', g2)
        bit2 = one_bit(result_of(
            [(b_chain, pvk.vk.b), (pvk.gen_chain, g1.neg(proof.b_p))]
        ))
        # 3. e(C, alphaC_g2) * e(-C', g2)
        bit3 = one_bit(result_of(
            [(pvk.c_chain, proof.c), (pvk.gen_chain, g1.neg(proof.c_p))]
        ))
        # 4. e(K, gamma_g2) * e(-(acc+A+C), gamma_beta_g2)
        #    * e(-gamma_beta_g1, B)
        acc_a_c = g1.add_unequal(g1.add_unequal(acc, proof.a), proof.c)
        bit4 = one_bit(result_of(
            [
                (pvk.g_chain, proof.k),
                (pvk.gb2_chain, g1.neg(acc_a_c)),
                (b_chain, g1.neg(pvk.vk.gb1)),
            ]
        ))
        # 5. e(acc+A, B) * e(-H, rC_Z_g2) * e(-C, g2)
        acc_a = g1.add_unequal(acc, proof.a)
        bit5 = one_bit(result_of(
            [
                (b_chain, acc_a),
                (pvk.z_chain, g1.neg(proof.h)),
                (pvk.gen_chain, g1.neg(proof.c)),
            ]
        ))

        out = pb.bit_and(pb.bit_and(bit1, bit2), pb.bit_and(bit3, bit4))
        return pb.bit_and(out, bit5)
