# Copied from zecale_tpu/gadgets/blake2s.py (JAX-free); only imports and build paths changed.
"""BLAKE2s-256 as an R1CS gadget + host oracle.

Role: the zeth joinsplit circuit's PRFs and note commitments are BLAKE2s-256
(reference: aggregator_test.cpp:52 `using hash = libzeth::BLAKE2s_256<...>`;
the gadget itself lives in the absent zeth submodule).  This is a fresh
bit-level arithmetization of RFC 7693 BLAKE2s (sequential mode, no key,
32-byte digest), differential-tested against hashlib.blake2s.

In-circuit representation: a 32-bit word is a list of 32 boolean LCs,
LSB-first.  Costs per operation:

  * xor        — 1 constraint/bit  (c = a + b - 2ab)
  * rotr       — free (rewiring)
  * add mod 32 — 1 unpacking of 32+k bits (k = carry width) + k+32 boolean
                 constraints; the packing equality rides the unpack gadget.

One compression is ~21k constraints; the joinsplit uses 16 of them.
"""

from __future__ import annotations

from typing import List, Sequence

from .protoboard import LC, Protoboard

IV = (
    0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A,
    0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19,
)

SIGMA = (
    (0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15),
    (14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3),
    (11, 8, 12, 0, 5, 2, 15, 13, 10, 14, 3, 6, 7, 1, 9, 4),
    (7, 9, 3, 1, 13, 12, 11, 14, 2, 6, 5, 10, 4, 0, 15, 8),
    (9, 0, 5, 7, 2, 4, 10, 15, 14, 1, 11, 12, 6, 8, 3, 13),
    (2, 12, 6, 10, 0, 11, 8, 3, 4, 13, 7, 5, 15, 14, 1, 9),
    (12, 5, 1, 15, 14, 13, 4, 10, 0, 7, 6, 3, 9, 2, 8, 11),
    (13, 11, 7, 14, 12, 1, 3, 9, 5, 0, 15, 4, 8, 6, 2, 10),
    (6, 15, 14, 9, 11, 3, 0, 8, 12, 2, 13, 7, 1, 4, 10, 5),
    (10, 2, 8, 4, 7, 6, 1, 5, 15, 11, 9, 14, 3, 12, 13, 0),
)

# Parameter block word 0 for digest_length=32, key=0, fanout=1, depth=1
_PARAM_W0 = 0x01010020


# ---------------------------------------------------------------------------
# host oracle (pure int; hashlib-compatible, verified in tests)
# ---------------------------------------------------------------------------


def _rotr(x: int, n: int) -> int:
    return ((x >> n) | (x << (32 - n))) & 0xFFFFFFFF


def _g(v, a, b, c, d, x, y):
    v[a] = (v[a] + v[b] + x) & 0xFFFFFFFF
    v[d] = _rotr(v[d] ^ v[a], 16)
    v[c] = (v[c] + v[d]) & 0xFFFFFFFF
    v[b] = _rotr(v[b] ^ v[c], 12)
    v[a] = (v[a] + v[b] + y) & 0xFFFFFFFF
    v[d] = _rotr(v[d] ^ v[a], 8)
    v[c] = (v[c] + v[d]) & 0xFFFFFFFF
    v[b] = _rotr(v[b] ^ v[c], 7)


def _compress(h: List[int], block: bytes, t: int, last: bool) -> List[int]:
    m = [int.from_bytes(block[4 * i : 4 * i + 4], "little") for i in range(16)]
    v = list(h) + list(IV)
    v[12] ^= t & 0xFFFFFFFF
    v[13] ^= (t >> 32) & 0xFFFFFFFF
    if last:
        v[14] ^= 0xFFFFFFFF
    for rnd in range(10):
        s = SIGMA[rnd]
        _g(v, 0, 4, 8, 12, m[s[0]], m[s[1]])
        _g(v, 1, 5, 9, 13, m[s[2]], m[s[3]])
        _g(v, 2, 6, 10, 14, m[s[4]], m[s[5]])
        _g(v, 3, 7, 11, 15, m[s[6]], m[s[7]])
        _g(v, 0, 5, 10, 15, m[s[8]], m[s[9]])
        _g(v, 1, 6, 11, 12, m[s[10]], m[s[11]])
        _g(v, 2, 7, 8, 13, m[s[12]], m[s[13]])
        _g(v, 3, 4, 9, 14, m[s[14]], m[s[15]])
    return [h[i] ^ v[i] ^ v[i + 8] for i in range(8)]


def blake2s_host(data: bytes) -> bytes:
    """BLAKE2s-256 of ``data`` (== hashlib.blake2s(data).digest())."""
    h = list(IV)
    h[0] ^= _PARAM_W0
    if len(data) == 0:
        h = _compress(h, b"\x00" * 64, 0, True)
        return b"".join(w.to_bytes(4, "little") for w in h)
    blocks = [data[i : i + 64] for i in range(0, len(data), 64)]
    t = 0
    for blk in blocks[:-1]:
        t += 64
        h = _compress(h, blk, t, False)
    last = blocks[-1]
    t += len(last)
    h = _compress(h, last.ljust(64, b"\x00"), t, True)
    return b"".join(w.to_bytes(4, "little") for w in h)


# ---------------------------------------------------------------------------
# bit helpers (big-endian digest bit order used by the joinsplit:
# digest_bits[0] is the MSB of byte 0 of the digest)
# ---------------------------------------------------------------------------


def bytes_to_bits_be(data: bytes) -> List[int]:
    """MSB-first bit list of a byte string."""
    out = []
    for byte in data:
        for i in range(7, -1, -1):
            out.append((byte >> i) & 1)
    return out


def bits_be_to_bytes(bits: Sequence[int]) -> bytes:
    assert len(bits) % 8 == 0
    out = bytearray()
    for i in range(0, len(bits), 8):
        b = 0
        for j in range(8):
            b = (b << 1) | (int(bits[i + j]) & 1)
        out.append(b)
    return bytes(out)


# ---------------------------------------------------------------------------
# gadget path
# ---------------------------------------------------------------------------


class _Word:
    """32 boolean LCs, LSB-first, plus an optional known constant value."""

    __slots__ = ("bits", "const")

    def __init__(self, bits: List[LC], const: int = None):
        self.bits = bits
        self.const = const

    @staticmethod
    def constant(v: int) -> "_Word":
        return _Word([LC.const((v >> i) & 1) for i in range(32)], v & 0xFFFFFFFF)


def _word_rotr(w: _Word, n: int) -> _Word:
    bits = [w.bits[(i + n) % 32] for i in range(32)]
    c = _rotr(w.const, n) if w.const is not None else None
    return _Word(bits, c)


def _word_xor(pb: Protoboard, a: _Word, b: _Word) -> _Word:
    """Bitwise xor; constants fold for free."""
    if a.const is not None and b.const is not None:
        return _Word.constant(a.const ^ b.const)
    if a.const is not None:
        a, b = b, a
    out = []
    for i in range(32):
        x, y = a.bits[i], b.bits[i]
        if b.const is not None:
            # xor with known bit: 0 -> x, 1 -> 1 - x (free)
            out.append(x if (b.const >> i) & 1 == 0 else LC.const(1) - x)
            continue
        v = pb.allocate()

        def fn(w, _x=x, _y=y, _v=v, _pb=pb):
            w[_v] = _pb.lc_val(w, _x) ^ _pb.lc_val(w, _y)

        # NOTE: the native replay opcode for ("xor", ...) computes
        # nonzero(a) XOR nonzero(b) (csrc/witness_engine.c kind 5) — it is
        # only equivalent to the integer '^' above because x and y are
        # boolean-constrained bit wires.  Do not emit this op tag for
        # non-bit operands.
        pb.add_hook(fn, op=("xor", v, x, y))
        # c = x + y - 2xy  <=>  (2x)(y) = x + y - c
        pb.add_r1cs(x.scale(2), y, x + y - LC.of_var(v))
        out.append(LC.of_var(v))
    return _Word(out)


def _word_add(pb: Protoboard, terms: List[_Word]) -> _Word:
    """Sum of 2 or 3 words mod 2^32 via (32+k)-bit unpacking."""
    const_sum = sum(t.const for t in terms if t.const is not None)
    lcs = [t for t in terms if t.const is None]
    if not lcs:
        return _Word.constant(const_sum & 0xFFFFFFFF)
    total = LC.const(const_sum)
    for t in lcs:
        for i, b in enumerate(t.bits):
            total = total + b.scale(1 << i)
    width = 32 + max(1, (len(terms) - 1).bit_length())
    from .packing import unpack_bits

    bits = unpack_bits(pb, total, width)
    return _Word(bits[:32])


def _g_gadget(pb, v, a, b, c, d, x: _Word, y: _Word):
    v[a] = _word_add(pb, [v[a], v[b], x])
    v[d] = _word_rotr(_word_xor(pb, v[d], v[a]), 16)
    v[c] = _word_add(pb, [v[c], v[d]])
    v[b] = _word_rotr(_word_xor(pb, v[b], v[c]), 12)
    v[a] = _word_add(pb, [v[a], v[b], y])
    v[d] = _word_rotr(_word_xor(pb, v[d], v[a]), 8)
    v[c] = _word_add(pb, [v[c], v[d]])
    v[b] = _word_rotr(_word_xor(pb, v[b], v[c]), 7)


def _bits_be_to_words(bits: List[LC]) -> List[_Word]:
    """Bytes-MSB-first bit LCs -> little-endian 32-bit words (RFC 7693
    loads message words little-endian)."""
    assert len(bits) % 32 == 0
    words = []
    for w in range(len(bits) // 32):
        chunk = bits[32 * w : 32 * (w + 1)]  # 4 bytes, each MSB-first
        lsb_first = []
        for byte in range(4):
            for i in range(7, -1, -1):
                lsb_first.append(chunk[8 * byte + i])
        # byte 0 is the least significant byte of the word
        words.append(_Word(lsb_first))
    return words


def _words_to_bits_be(words: List[_Word]) -> List[LC]:
    bits = []
    for w in words:
        for byte in range(4):
            for i in range(7, -1, -1):
                bits.append(w.bits[8 * byte + i])
    return bits


def blake2s_compress_gadget(
    pb: Protoboard,
    h: List[_Word],
    m: List[_Word],
    t: int,
    last: bool,
) -> List[_Word]:
    v = list(h) + [_Word.constant(c) for c in IV]
    v[12] = _word_xor(pb, v[12], _Word.constant(t & 0xFFFFFFFF))
    v[13] = _word_xor(pb, v[13], _Word.constant((t >> 32) & 0xFFFFFFFF))
    if last:
        v[14] = _word_xor(pb, v[14], _Word.constant(0xFFFFFFFF))
    for rnd in range(10):
        s = SIGMA[rnd]
        _g_gadget(pb, v, 0, 4, 8, 12, m[s[0]], m[s[1]])
        _g_gadget(pb, v, 1, 5, 9, 13, m[s[2]], m[s[3]])
        _g_gadget(pb, v, 2, 6, 10, 14, m[s[4]], m[s[5]])
        _g_gadget(pb, v, 3, 7, 11, 15, m[s[6]], m[s[7]])
        _g_gadget(pb, v, 0, 5, 10, 15, m[s[8]], m[s[9]])
        _g_gadget(pb, v, 1, 6, 11, 12, m[s[10]], m[s[11]])
        _g_gadget(pb, v, 2, 7, 8, 13, m[s[12]], m[s[13]])
        _g_gadget(pb, v, 3, 4, 9, 14, m[s[14]], m[s[15]])
    return [
        _word_xor(pb, _word_xor(pb, h[i], v[i]), v[i + 8]) for i in range(8)
    ]


def blake2s_gadget(pb: Protoboard, input_bits: List[LC]) -> List[LC]:
    """BLAKE2s-256 over a whole number of bytes of boolean LCs (MSB-first
    per byte).  Returns the 256 digest bits (MSB-first per byte).

    The message length is a circuit-layout constant (as in any R1CS hash
    gadget), so the t counters and padding are fixed at build time."""
    assert len(input_bits) % 8 == 0
    nbytes = len(input_bits) // 8
    h = [_Word.constant(IV[0] ^ _PARAM_W0)] + [
        _Word.constant(IV[i]) for i in range(1, 8)
    ]
    if nbytes == 0:
        m = [_Word.constant(0)] * 16
        h = blake2s_compress_gadget(pb, h, m, 0, True)
        return _words_to_bits_be(h)
    nblocks = (nbytes + 63) // 64
    t = 0
    for blk in range(nblocks):
        start, end = 64 * blk, min(64 * (blk + 1), nbytes)
        bits = input_bits[8 * start : 8 * end]
        bits = bits + [LC.const(0)] * (8 * (64 - (end - start)))
        m = _bits_be_to_words(bits)
        last = blk == nblocks - 1
        t = nbytes if last else t + 64
        h = blake2s_compress_gadget(pb, h, m, t, last)
    return _words_to_bits_be(h)
