# Copied from zecale_tpu/zeth/joinsplit.py (JAX-free); only imports and build paths changed.
"""The Zeth-style joinsplit circuit — the nested application of the
reference's full zk-zk-rollup test (aggregator_test.cpp:74-314, which uses
libzeth's circuit_wrapper<BLAKE2s_256, MiMC tree hash, npp, snark, 2, 2,
depth 4>).

Statement (2-in / 2-out), all hashes BLAKE2s-256, Merkle tree MiMC-MP:

  for each input i:
      a_pk_i = PRF_addr(a_sk_i)
      nf_i   = PRF_nf(a_sk_i, rho_i)
      h_i    = PRF_pk(a_sk_i, i, h_sig)
      cm_i   = COMM(a_pk_i, rho_i, trap_r_i, v_i)
      v_i != 0  =>  MerkleRoot(cm_i, addr_i, path_i) == root
  for each output j:
      rho^out_j = PRF_rho(phi, j, h_sig)
      cm^out_j  = COMM(a_pk^out_j, rho^out_j, trap_r^out_j, v^out_j)
  sum(v_in) + v_pub_in == sum(v_out) + v_pub_out        (64-bit values)

The single primary input is the MiMC input-hash of the public data
vector (aggregator_test.cpp:63-65: "The single primary input is the hash
of the public data elements: [Root, Nullifiers, Commitments, h_sig, h_is,
Residual Field Element]"):

  public_data = [ root,
                  nf_0.field, nf_1.field,
                  cm^out_0.field, cm^out_1.field,
                  h_sig.field, h_0.field, h_1.field,
                  residual ]

where digest.field is the low (capacity = |r|-1) bits of the 256-bit
digest and ``residual`` packs v_pub_in(64) || v_pub_out(64) and the
4 leftover top bits of each exposed digest:

  residual = vpub_in << 84 | vpub_out << 20 | hsig_res << 16
             | nf0_res << 12 | nf1_res << 8 | h0_res << 4 | h1_res

(on BLS12-377, capacity 252; the MNT-style fully-packing variant of the
reference test is the capacity >= 256 case of the same layout).
"""

from __future__ import annotations

import random
from typing import List, Optional, Sequence

from ..ff import params as P
from ..gadgets import blake2s as b2
from ..gadgets import mimc
from ..gadgets.packing import pack_lc, unpack_bits
from ..gadgets.protoboard import LC, Protoboard
from ..snark.groth16 import ExtendedProof, Groth16
from . import merkle, notes


def _pack_be_bits(bits_msb_first) -> LC:
    """LC packing of MSB-first bit LCs into the big-endian integer value."""
    return pack_lc(list(reversed(bits_msb_first)))


class JoinsplitCircuit:
    """Equivalent of libzeth's circuit_wrapper for the rollup test app."""

    NUM_INPUTS = 2
    NUM_OUTPUTS = 2

    def __init__(
        self,
        curve_name: str = "bls12-377",
        tree_depth: int = 4,
        snark: str = "GROTH16",
    ):
        self.curve_name = curve_name
        self.tree_depth = tree_depth
        self.r = P.CURVES[curve_name].r
        self.capacity = self.r.bit_length() - 1
        self.snark_name = snark.upper()
        if self.snark_name == "GROTH16":
            self.snark = Groth16(curve_name)
        else:
            from ..snark.pghr13 import Pghr13

            self.snark = Pghr13(curve_name)

        pb = Protoboard(self.r)
        self.pb = pb
        self._hash_var = pb.allocate_primary()
        pb.seal_primary()

        d = tree_depth

        def alloc_bits(n):
            vs = pb.allocate_array(n)
            lcs = [LC.of_var(v) for v in vs]
            for x in lcs:
                pb.enforce_boolean(x)
            return vs, lcs

        # ---- free witness inputs --------------------------------------
        self._root_var = pb.allocate()
        root = LC.of_var(self._root_var)
        self._hsig_vars, hsig_bits = alloc_bits(256)
        self._phi_vars, phi_bits = alloc_bits(256)
        self._vpub_in_vars, vpub_in_bits = alloc_bits(64)
        self._vpub_out_vars, vpub_out_bits = alloc_bits(64)

        self._in_vars = []  # per input: dict of var arrays
        in_value_lcs: List[LC] = []
        nf_bits_all: List[List[LC]] = []
        h_bits_all: List[List[LC]] = []
        for i in range(self.NUM_INPUTS):
            ask_v, ask = alloc_bits(256)
            rho_v, rho = alloc_bits(256)
            trap_v, trap = alloc_bits(256)
            val_v, val = alloc_bits(64)
            addr_v, addr = alloc_bits(d)
            path_v = pb.allocate_array(d)
            path = [LC.of_var(v) for v in path_v]
            self._in_vars.append(
                dict(a_sk=ask_v, rho=rho_v, trap_r=trap_v, value=val_v,
                     addr=addr_v, path=path_v)
            )

            # PRFs (tag bits replace the top 4 bits of a_sk)
            apk = b2.blake2s_gadget(
                pb,
                [LC.const(1), LC.const(1), LC.const(0), LC.const(0)]
                + ask[4:]
                + [LC.const(0)] * 256,
            )
            nf = b2.blake2s_gadget(
                pb,
                [LC.const(1), LC.const(1), LC.const(1), LC.const(0)]
                + ask[4:]
                + rho,
            )
            h_i = b2.blake2s_gadget(
                pb,
                [LC.const(0), LC.const(i), LC.const(0), LC.const(0)]
                + ask[4:]
                + hsig_bits,
            )
            nf_bits_all.append(nf)
            h_bits_all.append(h_i)

            # commitment + merkle membership
            cm = b2.blake2s_gadget(pb, apk + rho + trap + val)
            leaf = _pack_be_bits(cm[256 - self.capacity :])
            computed_root = merkle.merkle_root_gadget(pb, leaf, addr, path)
            value_lc = _pack_be_bits(val)
            in_value_lcs.append(value_lc)
            _, nz = pb.inv_or_zero(value_lc)
            # v != 0 => computed_root == root (dummy notes skip the check,
            # aggregator_test.cpp:149-151)
            pb.add_r1cs(computed_root - root, nz, LC())

        self._out_vars = []
        out_value_lcs: List[LC] = []
        cm_out_lcs: List[LC] = []
        for j in range(self.NUM_OUTPUTS):
            apk_v, apk = alloc_bits(256)
            trap_v, trap = alloc_bits(256)
            val_v, val = alloc_bits(64)
            self._out_vars.append(dict(a_pk=apk_v, trap_r=trap_v, value=val_v))

            rho_out = b2.blake2s_gadget(
                pb,
                [LC.const(0), LC.const(j), LC.const(1), LC.const(0)]
                + phi_bits[4:]
                + hsig_bits,
            )
            cm = b2.blake2s_gadget(pb, apk + rho_out + trap + val)
            cm_out_lcs.append(_pack_be_bits(cm[256 - self.capacity :]))
            out_value_lcs.append(_pack_be_bits(val))

        # ---- balance ---------------------------------------------------
        lhs = _pack_be_bits(vpub_in_bits)
        for v in in_value_lcs:
            lhs = lhs + v
        rhs = _pack_be_bits(vpub_out_bits)
        for v in out_value_lcs:
            rhs = rhs + v
        pb.enforce_equal(lhs, rhs)

        # ---- public data + input hasher ---------------------------------
        def field_part(bits):
            return _pack_be_bits(bits[256 - self.capacity :])

        def res_part(bits):
            return bits[: 256 - self.capacity]

        residual_bits = (
            vpub_in_bits
            + vpub_out_bits
            + res_part(hsig_bits)
            + res_part(nf_bits_all[0])
            + res_part(nf_bits_all[1])
            + res_part(h_bits_all[0])
            + res_part(h_bits_all[1])
        )
        public_data = (
            [root]
            + [field_part(nf) for nf in nf_bits_all]
            + cm_out_lcs
            + [field_part(hsig_bits)]
            + [field_part(h) for h in h_bits_all]
            + [_pack_be_bits(residual_bits)]
        )
        self.num_public_data = len(public_data)

        digest = mimc.mimc_hash_inputs_gadget(pb, public_data)
        pb.enforce_equal(digest, LC.of_var(self._hash_var))

        def assign_hash(w, _lc=digest, _v=self._hash_var, _pb=pb):
            w[_v] = _pb.lc_val(w, _lc)

        pb.add_hook(assign_hash)

        self.r1cs = pb.to_r1cs()

    # ------------------------------------------------------------------
    def generate_trusted_setup(
        self, rng: Optional[random.Random] = None, prover=None
    ):
        if prover is not None:
            return prover.generate_setup(self.r1cs, rng)
        return self.snark.generate_setup(self.r1cs, rng)

    # ------------------------------------------------------------------
    def _set_bits(self, w, vars_, data: bytes, n: int):
        bits = b2.bytes_to_bits_be(data)
        assert len(bits) == n == len(vars_)
        for v, bit in zip(vars_, bits):
            w[v] = bit

    def generate_witness(
        self,
        root: int,
        inputs: Sequence[notes.JoinsplitInput],
        outputs: Sequence[notes.ZethNote],
        vpub_in: int,
        vpub_out: int,
        h_sig: bytes,
        phi: bytes,
    ) -> List[int]:
        assert len(inputs) == self.NUM_INPUTS
        assert len(outputs) == self.NUM_OUTPUTS

        def extra(w):
            w[self._root_var] = root % self.r
            self._set_bits(w, self._hsig_vars, h_sig, 256)
            self._set_bits(w, self._phi_vars, phi, 256)
            self._set_bits(
                w, self._vpub_in_vars, vpub_in.to_bytes(8, "big"), 64
            )
            self._set_bits(
                w, self._vpub_out_vars, vpub_out.to_bytes(8, "big"), 64
            )
            for vars_, inp in zip(self._in_vars, inputs):
                self._set_bits(w, vars_["a_sk"], inp.a_sk, 256)
                self._set_bits(w, vars_["rho"], inp.note.rho, 256)
                self._set_bits(w, vars_["trap_r"], inp.note.trap_r, 256)
                self._set_bits(
                    w, vars_["value"], inp.note.value.to_bytes(8, "big"), 64
                )
                for k, v in enumerate(vars_["addr"]):
                    w[v] = (inp.address >> k) & 1
                for v, sib in zip(vars_["path"], inp.path):
                    w[v] = sib % self.r
            for vars_, note in zip(self._out_vars, outputs):
                self._set_bits(w, vars_["a_pk"], note.a_pk, 256)
                self._set_bits(w, vars_["trap_r"], note.trap_r, 256)
                self._set_bits(
                    w, vars_["value"], note.value.to_bytes(8, "big"), 64
                )

        return self.pb.generate_witness([0], extra_setter=extra)

    def prove(
        self,
        root: int,
        inputs: Sequence[notes.JoinsplitInput],
        outputs: Sequence[notes.ZethNote],
        vpub_in: int,
        vpub_out: int,
        h_sig: bytes,
        phi: bytes,
        pk,
        rng: Optional[random.Random] = None,
        prover=None,
        check: bool = False,
    ) -> ExtendedProof:
        """Mirrors circuit_wrapper.prove (aggregator_test.cpp:190-200):
        witness the joinsplit and return the extended proof whose single
        primary input is the public-data hash."""
        w = self.generate_witness(
            root, inputs, outputs, vpub_in, vpub_out, h_sig, phi
        )
        if check:
            bad = self.r1cs.first_failing_constraint(w)
            assert bad is None, f"joinsplit witness fails constraint {bad}"
        primary = w[1 : 1 + self.pb.num_primary]
        backend = prover if prover is not None else self.snark
        proof = backend.prove(self.r1cs, pk, w, rng)
        return ExtendedProof(proof=proof, inputs=primary)
