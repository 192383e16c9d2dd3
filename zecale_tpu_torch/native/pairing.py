# Copied from zecale_tpu/native/pairing.py (JAX-free); only imports and build paths changed.
"""Native BW6-761 pairing (csrc/ec_engine.c bw6_miller_product + ext_pow).

The wrapper-proof verification / settlement hot path: a Tate pairing
product over the direct sextic Fq6 = Fq[w]/(w^6 - xi) with batched
inversions and 3-sparse line multiplication — ~100x the pure-Python
host oracle it is differentially tested against
(zecale_tpu/pairing/host_pairing.py).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Sequence, Tuple

import numpy as np

from ..ff import params as P
from . import ec as nec

CURVE = "bw6-761"


class NativeBW6Pairing:
    def __init__(self):
        assert nec.available()
        self.lib = nec._lib()
        self.q = P.BW6_761_Q
        self.r = P.CURVES[CURVE].r
        self.nl = -(-self.q.bit_length() // 64)
        R = 1 << (64 * self.nl)
        self._R = R
        # k=6 sextic context: nr = xi = -4
        xi = P.BW6_761_XI
        n0inv = (-pow(self.q, -1, 1 << 64)) % (1 << 64)
        self._e6 = ctypes.create_string_buffer(self.lib.ext_ctx_size())
        self.lib.ext_init(
            self._e6,
            ctypes.c_int(self.nl),
            nec._ptr(nec._u64s(self.q, self.nl)),
            nec._ptr(nec._u64s(R * R % self.q, self.nl)),
            ctypes.c_uint64(n0inv),
            ctypes.c_int(6),
            nec._ptr(nec._u64s(xi * R % self.q, self.nl)),
        )
        self.g1 = nec.NativeCurve(CURVE, g2=False)
        self._one = nec._u64s(R % self.q, self.nl)
        self._one6 = np.zeros(6 * self.nl, dtype=np.uint64)
        self._one6[: self.nl] = self._one
        xi_inv = pow(xi, self.q - 2, self.q)
        self._xi_inv = nec._u64s(xi_inv * R % self.q, self.nl)
        self._exp_p2 = nec._u64s(
            self.q - 2, -(-(self.q - 2).bit_length() // 64)
        )
        fe = (self.q**6 - 1) // self.r
        self._fe = nec._u64s(fe, -(-fe.bit_length() // 64))
        bits = bin(self.r)[2:]
        self._rbits = np.frombuffer(
            bytes(int(b) for b in bits), dtype=np.uint8
        ).copy()

    def miller_product(self, pairs: Sequence[Tuple]) -> np.ndarray:
        """prod f_{r,P_i}(psi(Q_i)) as a raw Fq6 Montgomery array."""
        live = [
            (p, q) for p, q in pairs if p is not None and q is not None
        ]
        n = len(live)
        out = self._one6.copy()
        if not n:
            return out
        ps = np.zeros((n, 2 * self.nl), dtype=np.uint64)
        qs = np.zeros((n, 2 * self.nl), dtype=np.uint64)
        for i, (p, q) in enumerate(live):
            ps[i, : self.nl] = self.g1._elem_to_mont(p[0])
            ps[i, self.nl :] = self.g1._elem_to_mont(p[1])
            qs[i, : self.nl] = self.g1._elem_to_mont(q[0])
            qs[i, self.nl :] = self.g1._elem_to_mont(q[1])
        self.lib.bw6_miller_product(
            self._e6,
            self.g1._ctx,
            nec._ptr(ps),
            nec._ptr(qs),
            None,
            ctypes.c_long(n),
            nec._u8ptr(self._rbits),
            ctypes.c_int(len(self._rbits)),
            nec._ptr(self._xi_inv),
            nec._ptr(self._exp_p2),
            ctypes.c_int(len(self._exp_p2)),
            nec._ptr(self._one),
            nec._ptr(out),
        )
        return out

    def pairing_product_is_one(self, pairs) -> bool:
        f = self.miller_product(pairs)
        out = np.zeros_like(f)
        self.lib.ext_pow(
            self._e6,
            nec._ptr(out),
            nec._ptr(f),
            nec._ptr(self._fe),
            ctypes.c_int(len(self._fe)),
            nec._ptr(self._one6),
        )
        return bool(np.array_equal(out, self._one6))

    def pairing_product(self, pairs) -> tuple:
        """Full pairing product as a host Fq6 tower value (for parity with
        the host oracle's nested (Fq3, Fq3) representation)."""
        f = self.miller_product(pairs)
        out = np.zeros_like(f)
        self.lib.ext_pow(
            self._e6,
            nec._ptr(out),
            nec._ptr(f),
            nec._ptr(self._fe),
            ctypes.c_int(len(self._fe)),
            nec._ptr(self._one6),
        )
        rinv = pow(self._R, self.q - 2, self.q)
        flat = [
            int.from_bytes(
                out[i * self.nl : (i + 1) * self.nl].tobytes(), "little"
            )
            * rinv
            % self.q
            for i in range(6)
        ]
        # direct sextic basis w^i -> nested Fq3[w]/(w^2 - v):
        # ((c0, c2, c4), (c1, c3, c5))
        return ((flat[0], flat[2], flat[4]), (flat[1], flat[3], flat[5]))


@functools.lru_cache(maxsize=1)
def bw6() -> Optional[NativeBW6Pairing]:
    if not nec.available():
        return None
    return NativeBW6Pairing()


class NativeBLS12Pairing:
    """BLS12-377 Tate pairing via the C engine's towered sextic
    Fq12 = Fq2[w]/(w^6 - u) (csrc/ec_engine.c bls_miller_product +
    tow_pow).  Kills the Python-oracle verify path for nested proofs
    (round-2 KNOWN_GAPS #7); differentially tested against
    zecale_tpu/pairing/host_pairing.py."""

    CURVE = "bls12-377"

    def __init__(self):
        assert nec.available()
        self.lib = nec._lib()
        cp = P.CURVES[self.CURVE]
        self.q = cp.q
        self.r = cp.r
        self.nl = -(-self.q.bit_length() // 64)
        R = 1 << (64 * self.nl)
        self._R = R
        n0inv = (-pow(self.q, -1, 1 << 64)) % (1 << 64)
        qnr = P.BLS12_377_FQ2_QNR
        self.lib.tow_ctx_size.restype = ctypes.c_long
        self._tw = ctypes.create_string_buffer(self.lib.tow_ctx_size())
        # nr2 = u (the Fq2 generator): (0, 1) in Montgomery form
        nr2 = np.zeros(2 * self.nl, dtype=np.uint64)
        nr2[self.nl :] = nec._u64s(R % self.q, self.nl)
        self.lib.tow_init(
            self._tw,
            ctypes.c_int(self.nl),
            nec._ptr(nec._u64s(self.q, self.nl)),
            nec._ptr(nec._u64s(R * R % self.q, self.nl)),
            ctypes.c_uint64(n0inv),
            nec._ptr(nec._u64s(qnr * R % self.q, self.nl)),
            nec._ptr(nr2),
        )
        self.g1 = nec.NativeCurve(self.CURVE, g2=False)
        self._one = nec._u64s(R % self.q, self.nl)
        self._one12 = np.zeros(12 * self.nl, dtype=np.uint64)
        self._one12[: self.nl] = self._one
        self._exp_p2 = nec._u64s(
            self.q - 2, -(-(self.q - 2).bit_length() // 64)
        )
        fe = (self.q**12 - 1) // self.r
        self._fe = nec._u64s(fe, -(-fe.bit_length() // 64))
        bits = bin(self.r)[2:]
        self._rbits = np.frombuffer(
            bytes(int(b) for b in bits), dtype=np.uint8
        ).copy()

    def miller_product(self, pairs: Sequence[Tuple]) -> np.ndarray:
        live = [
            (p, q) for p, q in pairs if p is not None and q is not None
        ]
        n = len(live)
        out = self._one12.copy()
        if not n:
            return out
        ps = np.zeros((n, 2 * self.nl), dtype=np.uint64)
        qs = np.zeros((n, 4 * self.nl), dtype=np.uint64)
        for i, (p, q) in enumerate(live):
            ps[i, : self.nl] = self.g1._elem_to_mont(p[0])
            ps[i, self.nl :] = self.g1._elem_to_mont(p[1])
            (x0, x1), (y0, y1) = q  # G2 affine with Fq2 coords
            qs[i, 0 * self.nl : 1 * self.nl] = self.g1._elem_to_mont(x0)
            qs[i, 1 * self.nl : 2 * self.nl] = self.g1._elem_to_mont(x1)
            qs[i, 2 * self.nl : 3 * self.nl] = self.g1._elem_to_mont(y0)
            qs[i, 3 * self.nl : 4 * self.nl] = self.g1._elem_to_mont(y1)
        self.lib.bls_miller_product(
            self._tw,
            self.g1._ctx,
            nec._ptr(ps),
            nec._ptr(qs),
            None,
            ctypes.c_long(n),
            nec._u8ptr(self._rbits),
            ctypes.c_int(len(self._rbits)),
            nec._ptr(self._exp_p2),
            ctypes.c_int(len(self._exp_p2)),
            nec._ptr(self._one),
            nec._ptr(out),
        )
        return out

    def _final_exp(self, f: np.ndarray) -> np.ndarray:
        out = np.zeros_like(f)
        self.lib.tow_pow(
            self._tw,
            nec._ptr(out),
            nec._ptr(f),
            nec._ptr(self._fe),
            ctypes.c_int(len(self._fe)),
            nec._ptr(self._one12),
        )
        return out

    def pairing_product_is_one(self, pairs) -> bool:
        f = self._final_exp(self.miller_product(pairs))
        return bool(np.array_equal(f, self._one12))

    def pairing_product(self, pairs) -> tuple:
        """Full pairing product mapped to the host oracle's nested tower
        representation (Fq12 = Fq6[w]/(w^2-v), Fq6 = Fq2[v]/(v^3-u)):
        direct coefficient s_i of w^i -> ((s0,s2,s4),(s1,s3,s5)) with
        each s_i an Fq2 pair."""
        out = self._final_exp(self.miller_product(pairs))
        rinv = pow(self._R, self.q - 2, self.q)
        s = []
        for i in range(6):
            c0 = int.from_bytes(
                out[(2 * i) * self.nl : (2 * i + 1) * self.nl].tobytes(),
                "little",
            ) * rinv % self.q
            c1 = int.from_bytes(
                out[(2 * i + 1) * self.nl : (2 * i + 2) * self.nl]
                .tobytes(),
                "little",
            ) * rinv % self.q
            s.append((c0, c1))
        return ((s[0], s[2], s[4]), (s[1], s[3], s[5]))


@functools.lru_cache(maxsize=1)
def bls12() -> Optional[NativeBLS12Pairing]:
    if not nec.available():
        return None
    return NativeBLS12Pairing()


class NativeGenericPairing:
    """MNT4-298 / MNT6-298 Tate pairing via the C engine's generic
    dense-line Miller product (csrc generic_miller_product + ext_pow).

    The full extension is a direct binomial over Fq (the tower generators
    satisfy u = w^2 / v = w^2, so Fq4 = Fq[w]/(w^4-17) and
    Fq6 = Fq[w]/(w^6-5)); the untwisted G2 coordinate components spread
    over several direct positions, captured in a monomial placement table
    derived numerically from the host oracle's untwist map."""

    def __init__(self, curve_name: str):
        assert nec.available()
        from ..ff import host_field as hf
        from ..pairing import host_pairing as hp

        self.curve_name = curve_name
        self.lib = nec._lib()
        cp = P.CURVES[curve_name]
        self.q = cp.q
        self.r = cp.r
        self.k = cp.embedding_degree
        self.fg2_deg = cp.g2_degree
        self.nl = -(-self.q.bit_length() // 64)
        R = 1 << (64 * self.nl)
        self._R = R
        t = hf.towers(curve_name)
        fqk, fq = t["fqk"], t["fq"]
        ctx = hp.ctx(curve_name)

        # direct-basis flattening of the nested tower representation:
        # fqk = BinomialExt(fg2-tower, 2, gen) with gen = w^2, so nested
        # ((a_0..a_{d-1}), (b_0..b_{d-1})) -> direct [a_0, b_0, a_1, ...]
        d = self.fg2_deg

        def flatten(e):
            a, b = e
            if d == 2:
                return [a[0], b[0], a[1], b[1]]
            return [a[0], b[0], a[1], b[1], a[2], b[2]]

        def placement(untwist_c):
            pos, scale = [], []
            for j in range(d):
                basis = tuple(1 if i == j else 0 for i in range(d))
                m = flatten(fqk.mul(ctx.embed_fg2(basis), untwist_c))
                nz = [(i, v) for i, v in enumerate(m) if v != 0]
                assert len(nz) == 1, (
                    f"untwist image of basis {j} is not a monomial: {nz}"
                )
                pos.append(nz[0][0])
                scale.append(nz[0][1])
            return pos, scale

        self._px, sx = placement(ctx._untwist_x)
        self._py, sy = placement(ctx._untwist_y)
        self._sx = np.concatenate(
            [nec._u64s(v * R % self.q, self.nl) for v in sx]
        )
        self._sy = np.concatenate(
            [nec._u64s(v * R % self.q, self.nl) for v in sy]
        )

        # direct-binomial ext context: w^k = nr with nr = gen(fq2/fq3)^2
        # i.e. the base-field non-residue of the tower (17 / 5)
        nr = {"mnt4-298": P.MNT4_298_QNR, "mnt6-298": P.MNT6_298_QNR}[
            curve_name
        ]
        n0inv = (-pow(self.q, -1, 1 << 64)) % (1 << 64)
        self.lib.ext_ctx_size.restype = ctypes.c_long
        self._ek = ctypes.create_string_buffer(self.lib.ext_ctx_size())
        self.lib.ext_init(
            self._ek,
            ctypes.c_int(self.nl),
            nec._ptr(nec._u64s(self.q, self.nl)),
            nec._ptr(nec._u64s(R * R % self.q, self.nl)),
            ctypes.c_uint64(n0inv),
            ctypes.c_int(self.k),
            nec._ptr(nec._u64s(nr * R % self.q, self.nl)),
        )
        self.g1 = nec.NativeCurve(curve_name, g2=False)
        self._one = nec._u64s(R % self.q, self.nl)
        self._onek = np.zeros(self.k * self.nl, dtype=np.uint64)
        self._onek[: self.nl] = self._one
        self._exp_p2 = nec._u64s(
            self.q - 2, -(-(self.q - 2).bit_length() // 64)
        )
        fe = (self.q**self.k - 1) // self.r
        self._fe = nec._u64s(fe, -(-fe.bit_length() // 64))
        bits = bin(self.r)[2:]
        self._rbits = np.frombuffer(
            bytes(int(b) for b in bits), dtype=np.uint8
        ).copy()
        self._fqk, self._flatten = fqk, flatten

    def miller_product(self, pairs) -> np.ndarray:
        live = [
            (p, q) for p, q in pairs if p is not None and q is not None
        ]
        n = len(live)
        out = self._onek.copy()
        if not n:
            return out
        d = self.fg2_deg
        ps = np.zeros((n, 2 * self.nl), dtype=np.uint64)
        qs = np.zeros((n, 2 * d * self.nl), dtype=np.uint64)
        for i, (p, q) in enumerate(live):
            ps[i, : self.nl] = self.g1._elem_to_mont(p[0])
            ps[i, self.nl :] = self.g1._elem_to_mont(p[1])
            x, y = q
            for j in range(d):
                qs[i, j * self.nl : (j + 1) * self.nl] = (
                    self.g1._elem_to_mont(x[j])
                )
                qs[i, (d + j) * self.nl : (d + j + 1) * self.nl] = (
                    self.g1._elem_to_mont(y[j])
                )
        px = (ctypes.c_int * d)(*self._px)
        py = (ctypes.c_int * d)(*self._py)
        self.lib.generic_miller_product(
            self._ek,
            self.g1._ctx,
            nec._ptr(ps),
            nec._ptr(qs),
            None,
            ctypes.c_long(n),
            nec._u8ptr(self._rbits),
            ctypes.c_int(len(self._rbits)),
            ctypes.c_int(d),
            px,
            nec._ptr(self._sx),
            py,
            nec._ptr(self._sy),
            nec._ptr(self._exp_p2),
            ctypes.c_int(len(self._exp_p2)),
            nec._ptr(self._one),
            nec._ptr(out),
        )
        return out

    def _final_exp(self, f):
        out = np.zeros_like(f)
        self.lib.ext_pow(
            self._ek,
            nec._ptr(out),
            nec._ptr(f),
            nec._ptr(self._fe),
            ctypes.c_int(len(self._fe)),
            nec._ptr(self._onek),
        )
        return out

    def pairing_product_is_one(self, pairs) -> bool:
        f = self._final_exp(self.miller_product(pairs))
        return bool(np.array_equal(f, self._onek))

    def pairing_product(self, pairs) -> tuple:
        """Result mapped back to the host nested tower representation."""
        out = self._final_exp(self.miller_product(pairs))
        rinv = pow(self._R, self.q - 2, self.q)
        flat = [
            int.from_bytes(
                out[i * self.nl : (i + 1) * self.nl].tobytes(), "little"
            )
            * rinv
            % self.q
            for i in range(self.k)
        ]
        d = self.fg2_deg
        if d == 2:
            return ((flat[0], flat[2]), (flat[1], flat[3]))
        return ((flat[0], flat[2], flat[4]), (flat[1], flat[3], flat[5]))


@functools.lru_cache(maxsize=None)
def generic(curve_name: str) -> Optional["NativeGenericPairing"]:
    if not nec.available():
        return None
    return NativeGenericPairing(curve_name)
