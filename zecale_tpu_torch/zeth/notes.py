# Copied from zecale_tpu/zeth/notes.py (JAX-free); only imports and build paths changed.
"""Zeth note primitives (host side): PRFs, note commitment, h_sig.

Shape follows the published Zeth protocol (Sprout-style tagged BLAKE2s
PRFs; single-hash note commitment), used by the rollup test as the nested
application (reference: aggregator_test.cpp:100-190 builds notes with
a_pk/value/rho/trap_r and nullifiers).  The in-circuit versions live in
joinsplit.py and are differential-tested against these.

PRF(tag4, x, y) = blake2s( tag4 || x[4:256] || y )   (64-byte preimage)

  a_pk  = PRF(1100, a_sk, 0^256)          (address PRF)
  nf    = PRF(1110, a_sk, rho)            (nullifier PRF)
  h_i   = PRF(0 i 0 0, a_sk, h_sig)       (malleability-fix PRF, i < 2)
  rho_i = PRF(0 i 1 0, phi, h_sig)        (output-serial PRF, i < 2)

Note commitment (one two-block BLAKE2s, 104-byte preimage):

  cm        = blake2s(a_pk || rho || trap_r || value_be64)
  cm_field  = cm interpreted as a big-endian integer, truncated to the
              field capacity (lowest r.bit_length()-1 bits) — the Merkle
              tree leaf.
"""

from __future__ import annotations

import dataclasses
from typing import List

from ..gadgets.blake2s import blake2s_host


def _tagged(tag_bits: str, x: bytes) -> bytes:
    """Replace the top 4 bits of the 32-byte x with the tag."""
    assert len(tag_bits) == 4 and len(x) == 32
    first = (int(tag_bits, 2) << 4) | (x[0] & 0x0F)
    return bytes([first]) + x[1:]


def prf_addr(a_sk: bytes) -> bytes:
    return blake2s_host(_tagged("1100", a_sk) + b"\x00" * 32)


def prf_nf(a_sk: bytes, rho: bytes) -> bytes:
    return blake2s_host(_tagged("1110", a_sk) + rho)


def prf_pk(a_sk: bytes, index: int, h_sig: bytes) -> bytes:
    assert index in (0, 1)
    return blake2s_host(_tagged(f"0{index}00", a_sk) + h_sig)


def prf_rho(phi: bytes, index: int, h_sig: bytes) -> bytes:
    assert index in (0, 1)
    return blake2s_host(_tagged(f"0{index}10", phi) + h_sig)


@dataclasses.dataclass
class ZethNote:
    """a_pk/value/rho/trap_r quad (reference zeth_note,
    aggregator_test.cpp:134-135)."""

    a_pk: bytes  # 32
    value: int  # 64-bit
    rho: bytes  # 32
    trap_r: bytes  # 32

    def commitment(self) -> bytes:
        assert 0 <= self.value < 1 << 64
        return blake2s_host(
            self.a_pk + self.rho + self.trap_r + self.value.to_bytes(8, "big")
        )

    def commitment_field(self, r: int) -> int:
        cap = r.bit_length() - 1
        return int.from_bytes(self.commitment(), "big") & ((1 << cap) - 1)


@dataclasses.dataclass
class JoinsplitInput:
    """One spend: Merkle path + address + note + spending key
    (reference joinsplit_input, aggregator_test.cpp:142-156)."""

    path: List[int]  # sibling field elements, leaf level first
    address: int
    note: ZethNote
    a_sk: bytes  # 32

    def nullifier(self) -> bytes:
        return prf_nf(self.a_sk, self.note.rho)
