"""Quadratic-extension tensors Fq2 = Fq[u] / (u^2 - nr) in plain PyTorch.

Ports ``ff/fp2_jax.py:Fp2TPU`` (19-131), ``ec/msm8.py:Fp28TPU`` (61-157)
and the Fq2 ops of ``ff/fp8q.py:QOps2`` (254) to the representation of the
CUDA field core (``csrc/field2.cuh``): an element is a (..., 2, n) int32
tensor, c0 then c1, each a row of canonical Montgomery limbs of the base
field (``ff/fp_torch.py``).  For BLS12-377 (n = 12, R = 2^384) the limbs
equal the JAX package's bit for bit.

Ops that act on each coefficient alone (add, sub, neg, dbl) are the base
field's own ops on the extra axis.  The product is
Karatsuba: the three base products run as one batched ``Field.mul``.  The
non-residue multiply is a small multiple, -(4x + x) for nr = -5, never a
multiply by a negative limb (the trap recorded at ``ff/fp8q.py:496-501``).
"""

from __future__ import annotations

import functools
from typing import Sequence

import torch

from . import host_field as hf
from . import params as P
from .fp_torch import field


class Fp2:
    """One quadratic extension: constants plus batched ops on
    (..., 2, n) limb tensors.  ``nr`` is the non-residue u^2 as a small
    signed integer."""

    def __init__(self, p: int, nr: int):
        self.base = field(p)
        self.p = p
        self.n = self.base.n
        self.nr = nr
        #: trailing shape of one element
        self.shape = (2, self.n)
        self.host = hf.BinomialExt(hf.PrimeField(p), 2, nr % p)

    def consts(self, device) -> dict:
        c = self.base.consts(device)
        return {"one": torch.stack((c["one"], torch.zeros_like(c["one"])))}

    # -- packing ------------------------------------------------------------
    @staticmethod
    def _flat(vals):
        return [c for v in vals for c in v]

    def _pairs(self, flat):
        return [(flat[2 * i], flat[2 * i + 1]) for i in range(len(flat) // 2)]

    def pack(self, vals: Sequence, device="cpu") -> torch.Tensor:
        """(c0, c1) tuples -> standard-form (k, 2, n) limbs."""
        flat = self.base.pack(self._flat(vals), device)
        return flat.reshape(-1, *self.shape)

    def unpack(self, t: torch.Tensor) -> list:
        return self._pairs(self.base.unpack(t))

    def pack_mont(self, vals: Sequence, device="cpu") -> torch.Tensor:
        return self.base.pack_mont(self._flat(vals), device).reshape(
            -1, *self.shape)

    def unpack_mont(self, t: torch.Tensor) -> list:
        return self._pairs(self.base.unpack_mont(t))

    def one_like(self, t: torch.Tensor) -> torch.Tensor:
        return self.consts(t.device)["one"].expand_as(t).clone()

    # -- ring ops -----------------------------------------------------------
    def add(self, a, b):
        return self.base.add(a, b)

    def sub(self, a, b):
        return self.base.sub(a, b)

    def neg(self, a):
        return self.base.neg(a)

    def dbl(self, a):
        return self.base.dbl(a)

    def mul_nr(self, x: torch.Tensor) -> torch.Tensor:
        """nr * x for base-field elements x (..., n)."""
        return self.base.mul_small(x, self.nr)

    def mul(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """Karatsuba: c0 = a0 b0 + nr a1 b1, c1 = (a0 + a1)(b0 + b1) - a0 b0
        - a1 b1 (csrc/field2.cuh Fq2::mul)."""
        a, b = torch.broadcast_tensors(a, b)
        B = self.base
        a0, a1 = a[..., 0, :], a[..., 1, :]
        b0, b1 = b[..., 0, :], b[..., 1, :]
        t0, t1, s = B.mul(torch.stack((a0, a1, B.add(a0, a1))),
                          torch.stack((b0, b1, B.add(b0, b1))))
        c1 = B.sub(B.sub(s, t0), t1)
        c0 = B.add(t0, self.mul_nr(t1))
        return torch.stack((c0, c1), dim=-2)

    def sqr(self, a):
        return self.mul(a, a)


@functools.lru_cache(maxsize=None)
def bls12_377_fq2() -> Fp2:
    """Fq2 of BLS12-377: u^2 = -5 (``params.BLS12_377_FQ2_QNR = q - 5``)."""
    return Fp2(P.BLS12_377_Q, P.BLS12_377_FQ2_QNR - P.BLS12_377_Q)
