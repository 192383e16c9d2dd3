# Frozen copy of zecale_tpu_torch/native/ec.py for the benchmark's reference: the build (at a fixed path inside the checkout), what the pairings use, and the fixed-base products of the trusted setup.
"""ctypes bindings for the native EC engine (csrc/ec_engine.c): the
library, its buffers, and a curve context with its Montgomery
conversion, for the pairings of ``native_pairing.py`` and the fixed-base
products of ``setup.py``."""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess

import numpy as np

from . import params as P

_CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
_SRCS = [os.path.join(_CSRC, "ec_engine.c")]
#: the library is built once per checkout, at a fixed path inside it
BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "cache",
    "reference")


def _so_path() -> str:
    h = hashlib.sha256()
    for f in _SRCS + [os.path.join(_CSRC, "fp_core.h")]:
        with open(f, "rb") as fh:
            h.update(fh.read())
    return os.path.join(BUILD_DIR, f"ec_engine-{h.hexdigest()[:16]}.so")


@functools.lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    so = _so_path()
    if not os.path.exists(so):
        os.makedirs(BUILD_DIR, exist_ok=True)
        # build under a private name, then rename: two processes may
        # build the same library at once
        tmp = f"{so}.{os.getpid()}.tmp"
        subprocess.run(
            ["gcc", "-O3", "-fopenmp", "-shared", "-fPIC", "-o", tmp]
            + _SRCS,
            check=True,
            capture_output=True,
        )
        os.replace(tmp, so)
    lib = ctypes.CDLL(so)
    lib.curve_ctx_size.restype = ctypes.c_long
    lib.ext_ctx_size.restype = ctypes.c_long
    return lib


def available() -> bool:
    return _lib() is not None


def _u64s(x: int, nl: int) -> np.ndarray:
    return np.frombuffer(
        int(x).to_bytes(nl * 8, "little"), dtype=np.uint64
    ).copy()


def _u64_to_int(a: np.ndarray) -> int:
    return int.from_bytes(a.tobytes(), "little")


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64))


def _u8ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


class NativeCurve:
    """One curve group (G1 of any curve; G2 where coords are Fq or Fq2)."""

    def __init__(self, curve_name: str, g2: bool = False):
        cp = P.CURVES[curve_name]
        self.curve_name = curve_name
        self.g2 = g2
        self.p = cp.q
        self.r = cp.r
        self.nl = -(-cp.q.bit_length() // 64)
        if g2 and cp.g2_degree == 2:
            self.k = 2
            if curve_name == "bls12-377":
                nr = P.BLS12_377_FQ2_QNR
            elif curve_name == "mnt4-298":
                nr = P.MNT4_298_QNR
            else:
                raise KeyError(curve_name)
        elif g2 and cp.g2_degree == 3:
            assert curve_name == "mnt6-298"
            self.k = 3
            nr = P.MNT6_298_QNR
        elif g2 and cp.g2_degree != 1:
            raise KeyError(f"unsupported G2 tower for {curve_name}")
        else:
            self.k = 1
            nr = 0
        self.ew = self.k * self.nl
        lib = _lib()
        assert lib is not None, "native engine unavailable"
        self.lib = lib
        self._ctx = ctypes.create_string_buffer(lib.curve_ctx_size())
        R = 1 << (64 * self.nl)
        r2 = R * R % self.p
        n0inv = (-pow(self.p, -1, 1 << 64)) % (1 << 64)
        self._R = R
        nr_m = _u64s(nr * R % self.p, self.nl)
        if g2:
            from . import host_curve as hc

            a_host = hc.g2_curve(curve_name).a
        else:
            a_host = cp.a
        if self.k >= 2:
            if isinstance(a_host, tuple):
                a_coeffs = tuple(a_host) + (0,) * (self.k - len(a_host))
            else:
                a_coeffs = (a_host,) + (0,) * (self.k - 1)
            a_m = np.concatenate(
                [_u64s(c * R % self.p, self.nl) for c in a_coeffs]
            )
        else:
            a_m = _u64s((a_host if not isinstance(a_host, tuple) else a_host[0])
                        * R % self.p, self.nl)
        lib.curve_init(
            self._ctx,
            ctypes.c_int(self.nl),
            _ptr(_u64s(self.p, self.nl)),
            _ptr(_u64s(r2, self.nl)),
            ctypes.c_uint64(n0inv),
            ctypes.c_int(self.k),
            _ptr(nr_m),
            _ptr(a_m),
        )
        self._rinv = pow(R, self.p - 2, self.p)
        self.one_m = self._elem_to_mont(
            1 if self.k == 1 else (1,) + (0,) * (self.k - 1)
        )
        # Fermat exponent for inversion in the coordinate field
        inv_exp = self.p ** self.k - 2
        self._inv_exp = _u64s(inv_exp, -(-inv_exp.bit_length() // 64))

    # -- element packing -----------------------------------------------------
    def _elem_to_mont(self, v) -> np.ndarray:
        if self.k == 1:
            return _u64s(v % self.p * self._R % self.p, self.nl)
        return np.concatenate(
            [_u64s(c % self.p * self._R % self.p, self.nl) for c in v]
        )

    def _elem_from_mont(self, a: np.ndarray):
        rinv = self._rinv
        if self.k == 1:
            return _u64_to_int(a[: self.nl]) * rinv % self.p
        return tuple(
            _u64_to_int(a[i * self.nl : (i + 1) * self.nl]) * rinv % self.p
            for i in range(self.k)
        )

    def _jac_to_affine(self, jac: np.ndarray) -> list:
        n = jac.shape[0]
        xy = np.zeros((n, 2 * self.ew), dtype=np.uint64)
        inf = np.zeros(n, dtype=np.uint8)
        self.lib.jac_to_affine_batch(
            self._ctx,
            _ptr(xy),
            _u8ptr(inf),
            _ptr(jac),
            ctypes.c_long(n),
            _ptr(self._inv_exp),
            ctypes.c_int(len(self._inv_exp)),
            _ptr(self.one_m),
        )
        out = []
        for i in range(n):
            if inf[i]:
                out.append(None)
            else:
                out.append(
                    (
                        self._elem_from_mont(xy[i, : self.ew]),
                        self._elem_from_mont(xy[i, self.ew :]),
                    )
                )
        return out

    # -- fixed-base products, for the reference's trusted setup -------------
    def fixed_base_mul_batch(self, scalars, base, c: int = 8):
        """[k_i] * base for all i -> list of host affine points (None for
        the point at infinity)."""
        n = len(scalars)
        sbytes = -(-self.r.bit_length() // 8)
        sb = b"".join(
            int(s % self.r).to_bytes(sbytes, "little") for s in scalars
        )
        sarr = np.frombuffer(sb, dtype=np.uint8).reshape(n, sbytes).copy()
        base_xy = np.concatenate(
            [self._elem_to_mont(base[0]), self._elem_to_mont(base[1])]
        )
        out = np.zeros((n, 3 * self.ew), dtype=np.uint64)
        self.lib.fixed_base_mul_batch(
            self._ctx,
            _ptr(out),
            _u8ptr(sarr),
            ctypes.c_long(sbytes),
            ctypes.c_long(n),
            _ptr(base_xy),
            ctypes.c_int(c),
            _ptr(self.one_m),
        )
        return self._jac_to_affine(out)
