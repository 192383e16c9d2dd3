"""Prime-field tensors: 32-bit-limb Montgomery arithmetic in plain PyTorch.

Ports the device field cores of the JAX package (``ff/fp_jax.py`` FpTPU,
the pack/unpack of ``ff/fp8.py`` and the bound notes of ``ff/fp8q.py``) to
the representation the CUDA kernels use (``csrc/field.cuh``):

  * an element is a row of ``n`` little-endian 32-bit limbs, stored as an
    ``int32`` tensor of shape (..., n) (the kernels read the same bytes as
    ``uint32``);
  * Montgomery form with R = 2^(32 n).  For BLS12-377 Fq (n=12), BW6-761 Fq
    (n=24) and BW6-761 Fr (n=12) this R equals the JAX package's, so
    canonical Montgomery limbs compare bit for bit;
  * every public op takes and returns canonical values in [0, p).

The arithmetic here is the plain version of the kernels' field ops.  Torch
has no general uint64 arithmetic on CUDA, and the column sums of 32x32-bit
products overflow int64, so each limb is split into two 16-bit digits held
in int64: a digit product is < 2^32 and a column of up to 48 of them stays
below 2^38.  Carries are resolved without a sequential limb loop: three
fold passes bring every digit to <= 2^16, then one generate/propagate scan
(``cummax`` over the last carry-deciding position) settles the 0/1 carries
exactly.  Subtraction is done as addition of the 16-bit complement, so no
digit is ever negative.
"""

from __future__ import annotations

import functools
from typing import Sequence

import numpy as np
import torch

from . import host_field as hf

MASK = 0xFFFF
#: rows per chunk of a multiply: bounds the (rows, 2n, 4n) int64 product
#: temporaries to about 1 GB for the widest field (BW6-761 Fq, n = 24)
MUL_CHUNK = 1 << 14


def num_limbs(p: int) -> int:
    return -(-p.bit_length() // 32)


def ints_to_limbs(vals: Sequence[int], n: int) -> np.ndarray:
    """Python ints in [0, 2^(32n)) -> (len, n) int32 limb array."""
    buf = b"".join(int(v).to_bytes(4 * n, "little") for v in vals)
    return np.frombuffer(buf, dtype="<u4").reshape(len(vals), n).view(np.int32)


def limbs_to_ints(arr) -> list:
    """(..., n) int32 limb array or tensor -> flat list of Python ints."""
    if isinstance(arr, torch.Tensor):
        arr = arr.detach().cpu().numpy()
    arr = np.ascontiguousarray(arr, dtype=np.int32)
    n = arr.shape[-1]
    buf = arr.reshape(-1, n).view("<u4").tobytes()
    w = 4 * n
    return [
        int.from_bytes(buf[i * w : (i + 1) * w], "little")
        for i in range(len(buf) // w)
    ]


def _digits(v: int, m: int) -> list:
    return [(v >> (16 * i)) & MASK for i in range(m)]


# ---------------------------------------------------------------------------
# 16-bit digit machinery (int64 tensors, digits along the last axis)
# ---------------------------------------------------------------------------


def _to16(t: torch.Tensor) -> torch.Tensor:
    """(..., n) int32 limbs -> (..., 2n) int64 16-bit digits: each limb
    viewed as its two little-endian int16 halves."""
    return t.contiguous().view(torch.int16).to(torch.int64) & MASK


def _from16(d: torch.Tensor) -> torch.Tensor:
    """(..., 2n) canonical 16-bit digits -> (..., n) int32 limbs."""
    d = (d - ((d >> 15) << 16)).to(torch.int16)
    return d.contiguous().view(torch.int32)


@functools.lru_cache(maxsize=None)
def _positions(k: int, device: str) -> torch.Tensor:
    return torch.arange(1, k + 1, device=device)


def _norm(x: torch.Tensor, folds: int = 3) -> torch.Tensor:
    """Non-negative digit columns -> canonical 16-bit digits of the same
    value mod 2^(16 * width); the carry out of the top column is dropped
    (callers size the width so that it is zero or wanted gone).  Three
    folds take columns < 2^48 to <= 2^16 (< 2^32+2^16, < 2^17, <= 2^16);
    one fold does for columns < 2^17 (sums of two digit rows)."""
    for _ in range(folds):
        c = x >> 16
        x = x & MASK
        x[..., 1:] += c[..., :-1]
    g = x >> 16  # generate: digit is exactly 2^16
    x = x & MASK
    # carry out of column i = g at the last column <= i that decides it
    # (generates, or is not all ones); 1-based so that 0 means none
    stop = (g == 1) | (x != MASK)
    pos = torch.where(stop, _positions(x.shape[-1], str(x.device)), 0)
    last = pos.cummax(-1).values
    cout = torch.nn.functional.pad(g, (1, 0)).gather(-1, last)
    x[..., 1:] += cout[..., :-1]
    return x & MASK


def _conv(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Digit convolution: (..., m) x (..., m) -> (..., 2m) column sums
    (top column zero), as one batched float64 product of a against the
    sliding windows of b.  Exact: digits are < 2^16, so a column is a sum
    of at most 48 products < 2^32, far inside float64's 53 bits."""
    m = a.shape[-1]
    windows = torch.nn.functional.pad(b.double(), (m - 1, m)).unfold(-1, m, 1)
    cols = torch.matmul(windows, a.flip(-1).double().unsqueeze(-1))
    return cols.squeeze(-1).long()


def _toeplitz(v: int, m: int) -> torch.Tensor:
    """(m, 2m) float64 T with a @ T = _conv(a, digits of v)."""
    d = torch.tensor(_digits(v, m), dtype=torch.float64)
    t = torch.zeros(m, 2 * m, dtype=torch.float64)
    for i in range(m):
        t[i, i: i + m] = d
    return t


class Field:
    """One prime field: constants plus batched ops on limb tensors."""

    def __init__(self, p: int):
        self.p = p
        self.n = num_limbs(p)
        self.m = 2 * self.n
        #: trailing shape of one element (``fp2_torch.Fp2``: (2, n))
        self.shape = (self.n,)
        #: the host field of Python ints, for the few host-side steps
        self.host = hf.PrimeField(p)
        self.R = 1 << (32 * self.n)
        self.r_mod_p = self.R % p
        self.r2 = self.R * self.R % p
        #: -p^-1 mod 2^32: the CIOS constant of the CUDA field core
        self.pinv32 = (-pow(p, -1, 1 << 32)) % (1 << 32)
        #: -p^-1 mod R: the full-width REDC constant of the plain version
        self._nprime = (-pow(p, -1, self.R)) % self.R
        self._dev_consts = {}

    def consts(self, device) -> dict:
        device = torch.device(device)
        key = str(device)
        c = self._dev_consts.get(key)
        if c is None:
            t = lambda v, m: torch.tensor(  # noqa: E731
                _digits(v, m), dtype=torch.int64, device=device
            )
            m = self.m
            c = {
                "p": t(self.p, m),
                # 2^(16(m+1)) - p: adding it and dropping the top carry
                # subtracts p from an (m+1)-digit value
                "pc1": t((1 << (16 * (m + 1))) - self.p, m + 1),
                # constant operands of the REDC products as matrices
                "nprime_T": _toeplitz(self._nprime, m).to(device),
                "p_T": _toeplitz(self.p, m).to(device),
                "one": self.pack([self.r_mod_p], device)[0],
                "r2": self.pack([self.r2], device)[0],
                "plain_one": self.pack([1], device)[0],
            }
            self._dev_consts[key] = c
        return c

    # -- packing ------------------------------------------------------------
    def pack(self, vals: Sequence[int], device="cpu") -> torch.Tensor:
        """Ints -> canonical standard-form limbs (no Montgomery)."""
        arr = ints_to_limbs([v % self.p for v in vals], self.n)
        return torch.from_numpy(arr.copy()).to(device)

    def unpack(self, t: torch.Tensor) -> list:
        return limbs_to_ints(t)

    def pack_mont(self, vals: Sequence[int], device="cpu") -> torch.Tensor:
        return self.pack([v * self.R for v in vals], device)

    def unpack_mont(self, t: torch.Tensor) -> list:
        rinv = pow(self.R, -1, self.p)
        return [v * rinv % self.p for v in limbs_to_ints(t)]

    def one_like(self, t: torch.Tensor) -> torch.Tensor:
        return self.consts(t.device)["one"].expand_as(t).clone()

    # -- ring ops -----------------------------------------------------------
    def _cond_sub(self, s: torch.Tensor, c: dict) -> torch.Tensor:
        """(m+1) canonical digits of s in [0, 2p) -> m digits in [0, p).
        s - p mod 2^(16(m+1)) has top digit 0 exactly when s >= p (since
        p < 2^(16m)), and 0xFFFF otherwise."""
        d = _norm(s + c["pc1"], 1)
        ge = d[..., self.m] == 0
        return torch.where(ge.unsqueeze(-1), d, s)[..., : self.m]

    def add(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        c = self.consts(a.device)
        s = torch.nn.functional.pad(_to16(a) + _to16(b), (0, 1))
        return _from16(self._cond_sub(_norm(s, 1), c))

    def sub(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        c = self.consts(a.device)
        # a + (R - b) = a - b + R: the top digit is 1 exactly when a >= b
        s = torch.nn.functional.pad(_to16(a) + (MASK - _to16(b)), (0, 1))
        s[..., 0] += 1
        s = _norm(s, 1)
        ge = s[..., self.m] == 1
        low = s[..., : self.m]
        wrapped = _norm(low + c["p"], 1)  # a - b + p, mod R
        return _from16(torch.where(ge.unsqueeze(-1), low, wrapped))

    def neg(self, a: torch.Tensor) -> torch.Tensor:
        return self.sub(torch.zeros_like(a), a)

    def dbl(self, a: torch.Tensor) -> torch.Tensor:
        return self.add(a, a)

    def mul_small(self, a: torch.Tensor, k: int) -> torch.Tensor:
        """k * a for a small integer k (b3 = 3, -3, 12 in the group law):
        double-and-add, and a field negation for k < 0 (never a negative
        limb multiply)."""
        mag = abs(k)
        assert mag >= 1
        acc = a
        for bit in bin(mag)[3:]:
            acc = self.dbl(acc)
            if bit == "1":
                acc = self.add(acc, a)
        return self.neg(acc) if k < 0 else acc

    def _mont_mul16(self, a16, b16, c):
        m = self.m
        t = _norm(torch.nn.functional.pad(_conv(a16, b16), (0, 1)))
        q = _norm((t[..., :m].double() @ c["nprime_T"])[..., :m].long())
        u = t + torch.nn.functional.pad(
            (q.double() @ c["p_T"]).long(), (0, 1)
        )
        return self._cond_sub(_norm(u)[..., m:], c)

    def mul(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """Montgomery product a*b/R mod p (CIOS in csrc/field.cuh)."""
        a, b = torch.broadcast_tensors(a, b)
        c = self.consts(a.device)
        shape = a.shape
        a = a.reshape(-1, self.n)
        b = b.reshape(-1, self.n)
        outs = [
            _from16(self._mont_mul16(_to16(a[i : i + MUL_CHUNK]),
                                     _to16(b[i : i + MUL_CHUNK]), c))
            for i in range(0, max(1, a.shape[0]), MUL_CHUNK)
        ]
        return torch.cat(outs).reshape(shape)

    def sqr(self, a: torch.Tensor) -> torch.Tensor:
        return self.mul(a, a)

    def to_mont(self, a: torch.Tensor) -> torch.Tensor:
        return self.mul(a, self.consts(a.device)["r2"])

    def from_mont(self, a: torch.Tensor) -> torch.Tensor:
        return self.mul(a, self.consts(a.device)["plain_one"])

    def is_zero(self, a: torch.Tensor) -> torch.Tensor:
        return (a == 0).all(-1)

    def inv_host(self, a: torch.Tensor) -> torch.Tensor:
        """Montgomery inverses of a few elements through Python ints
        (zero maps to zero)."""
        vals = self.unpack_mont(a.reshape(-1, self.n))
        inv = [pow(v, -1, self.p) if v else 0 for v in vals]
        return self.pack_mont(inv, a.device).reshape(a.shape)

    def batch_inverse(self, a: torch.Tensor) -> torch.Tensor:
        """Montgomery's trick over a (k, n) batch: prefix and suffix
        products by log2(k) doubling scans, one inversion of the total on
        the host.  Zeros map to zero."""
        k = a.shape[0]
        zero = self.is_zero(a)
        x = torch.where(zero.unsqueeze(-1), self.one_like(a), a)
        one = self.one_like(x[:1])
        pre, suf = x.clone(), x.clone()
        step = 1
        while step < k:
            pre = torch.cat([pre[:step], self.mul(pre[step:], pre[:-step])])
            suf = torch.cat([self.mul(suf[:-step], suf[step:]), suf[-step:]])
            step *= 2
        tot_inv = self.inv_host(pre[-1:])
        left = torch.cat([one, pre[:-1]])  # prod_{j<i}
        right = torch.cat([suf[1:], one])  # prod_{j>i}
        out = self.mul(self.mul(left, right), tot_inv)
        return torch.where(zero.unsqueeze(-1), torch.zeros_like(out), out)


@functools.lru_cache(maxsize=None)
def field(p: int) -> Field:
    return Field(p)
