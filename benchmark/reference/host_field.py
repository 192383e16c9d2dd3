# Frozen copy of zecale_tpu_torch/ff/host_field.py for the benchmark's reference.
"""Host-side (pure Python int) finite-field arithmetic.

This is the *control plane* implementation: exact, dependency-free modular
arithmetic used for setup derivations, serialization, witness generation and
as the differential-test oracle for the TPU kernels in
``zecale_tpu.ff.fp_jax`` / ``zecale_tpu.ff.fp8`` (+ the
limb-major Pallas helpers in ``zecale_tpu.ff.fp8t``).

Design: a *field context* object exposes arithmetic over plain-data elements
(int for prime fields, tuples for extension fields).  Avoiding per-element
wrapper objects keeps witness generation cheap and makes elements directly
hashable/serializable.

Extension towers are binomial extensions x^k = nr (k in {2, 3}), which covers
every tower needed by the supported curves:

  BLS12-377: Fq2 = Fq[u]/(u^2+5);  Fq6 = Fq2[v]/(v^3-u);  Fq12 = Fq6[w]/(w^2-v)
  BW6-761:   Fq3 = Fq[v]/(v^3+4);  Fq6 = Fq3[w]/(w^2-v)     (so w^6 = -4)
  MNT4-298:  Fq2 = Fq[u]/(u^2-17); Fq4 = Fq2[w]/(w^2-u)
  MNT6-298:  Fq3 = Fq[v]/(v^3-5);  Fq6 = Fq3[w]/(w^2-v)

(The reference gets the same arithmetic from libff; see SURVEY.md section 2b.)
"""

from __future__ import annotations

import random
from typing import Any, Sequence

Element = Any  # int | tuple


class PrimeField:
    """Fp arithmetic context over a prime modulus ``p``."""

    def __init__(self, p: int):
        self.p = p
        self.degree = 1

    # -- constants ----------------------------------------------------------
    def zero(self) -> int:
        return 0

    def one(self) -> int:
        return 1

    def from_int(self, x: int) -> int:
        return x % self.p

    # -- arithmetic ---------------------------------------------------------
    def add(self, a: int, b: int) -> int:
        return (a + b) % self.p

    def sub(self, a: int, b: int) -> int:
        return (a - b) % self.p

    def neg(self, a: int) -> int:
        return (-a) % self.p

    def mul(self, a: int, b: int) -> int:
        return (a * b) % self.p

    def sqr(self, a: int) -> int:
        return (a * a) % self.p

    def inv(self, a: int) -> int:
        if a % self.p == 0:
            raise ZeroDivisionError("inverse of zero in prime field")
        return pow(a, self.p - 2, self.p)

    def mul_scalar(self, a: int, k: int) -> int:
        return (a * k) % self.p

    def eq(self, a: int, b: int) -> bool:
        return (a - b) % self.p == 0

    def is_zero(self, a: int) -> bool:
        return a % self.p == 0

    def rand(self, rng: random.Random | None = None) -> int:
        rng = rng or random
        return rng.randrange(self.p)

    def pow(self, a: int, e: int) -> int:
        return pow(a, e % (self.p - 1) if e >= self.p else e, self.p)

    # -- embedding ----------------------------------------------------------
    def embed(self, x: int) -> int:
        """Embed a base-prime-field scalar (identity here)."""
        return x % self.p

    def to_list(self, a: int) -> list[int]:
        """Flatten to a list of base-field ints (lexicographic tower order)."""
        return [a % self.p]

    def from_list(self, coeffs: Sequence[int]) -> int:
        assert len(coeffs) == 1
        return coeffs[0] % self.p

    def is_square(self, a: int) -> bool:
        a %= self.p
        return a == 0 or pow(a, (self.p - 1) // 2, self.p) == 1

    def sqrt(self, a: int) -> int:
        """Tonelli-Shanks square root (raises if no root exists)."""
        p = self.p
        a %= p
        if a == 0:
            return 0
        if not self.is_square(a):
            raise ValueError("not a quadratic residue")
        if p % 4 == 3:
            return pow(a, (p + 1) // 4, p)
        # general Tonelli-Shanks
        q, s = p - 1, 0
        while q % 2 == 0:
            q //= 2
            s += 1
        z = 2
        while self.is_square(z):
            z += 1
        m, c, t, r = s, pow(z, q, p), pow(a, q, p), pow(a, (q + 1) // 2, p)
        while t != 1:
            i, t2 = 0, t
            while t2 != 1:
                t2 = t2 * t2 % p
                i += 1
            b = pow(c, 1 << (m - i - 1), p)
            m, c = i, b * b % p
            t, r = t * c % p, r * b % p
        return r


class BinomialExt:
    """Degree-``k`` binomial extension ``base[x]/(x^k - nr)`` for k in {2,3}.

    Elements are tuples of ``k`` base elements, low coefficient first.
    """

    def __init__(self, base, k: int, nr: Element):
        assert k in (2, 3), "only quadratic/cubic steps are used in the towers"
        self.base = base
        self.k = k
        self.nr = nr
        self.degree = base.degree * k

    # -- constants ----------------------------------------------------------
    def zero(self):
        return tuple(self.base.zero() for _ in range(self.k))

    def one(self):
        return (self.base.one(),) + tuple(
            self.base.zero() for _ in range(self.k - 1)
        )

    def from_base(self, a):
        """Lift an element of the immediate base field."""
        return (a,) + tuple(self.base.zero() for _ in range(self.k - 1))

    def from_int(self, x: int):
        return self.from_base(self.base.from_int(x))

    def gen(self):
        """The adjoined root x (x^k = nr)."""
        e = [self.base.zero()] * self.k
        e[1] = self.base.one()
        return tuple(e)

    # -- arithmetic ---------------------------------------------------------
    def add(self, a, b):
        return tuple(self.base.add(x, y) for x, y in zip(a, b))

    def sub(self, a, b):
        return tuple(self.base.sub(x, y) for x, y in zip(a, b))

    def neg(self, a):
        return tuple(self.base.neg(x) for x in a)

    def mul(self, a, b):
        B = self.base
        if self.k == 2:
            a0, a1 = a
            b0, b1 = b
            t0 = B.mul(a0, b0)
            t1 = B.mul(a1, b1)
            # Karatsuba: (a0+a1)(b0+b1) - t0 - t1
            mid = B.sub(B.sub(B.mul(B.add(a0, a1), B.add(b0, b1)), t0), t1)
            return (B.add(t0, B.mul(t1, self.nr)), mid)
        a0, a1, a2 = a
        b0, b1, b2 = b
        t0 = B.mul(a0, b0)
        t1 = B.mul(a1, b1)
        t2 = B.mul(a2, b2)
        # Toom/Karatsuba-style cross terms
        s01 = B.sub(B.sub(B.mul(B.add(a0, a1), B.add(b0, b1)), t0), t1)
        s02 = B.sub(B.sub(B.mul(B.add(a0, a2), B.add(b0, b2)), t0), t2)
        s12 = B.sub(B.sub(B.mul(B.add(a1, a2), B.add(b1, b2)), t1), t2)
        c0 = B.add(t0, B.mul(s12, self.nr))
        c1 = B.add(s01, B.mul(t2, self.nr))
        c2 = B.add(s02, t1)
        return (c0, c1, c2)

    def sqr(self, a):
        return self.mul(a, a)

    def mul_base(self, a, s):
        """Multiply by an element of the immediate base field."""
        return tuple(self.base.mul(x, s) for x in a)

    def mul_scalar(self, a, k: int):
        return tuple(self.base.mul_scalar(x, k) for x in a)

    def inv(self, a):
        B = self.base
        if self.k == 2:
            a0, a1 = a
            # norm = a0^2 - nr a1^2
            norm = B.sub(B.sqr(a0), B.mul(self.nr, B.sqr(a1)))
            ninv = B.inv(norm)
            return (B.mul(a0, ninv), B.neg(B.mul(a1, ninv)))
        a0, a1, a2 = a
        n = self.nr
        t0 = B.sub(B.sqr(a0), B.mul(n, B.mul(a1, a2)))
        t1 = B.sub(B.mul(n, B.sqr(a2)), B.mul(a0, a1))
        t2 = B.sub(B.sqr(a1), B.mul(a0, a2))
        delta = B.add(
            B.mul(a0, t0),
            B.mul(n, B.add(B.mul(a2, t1), B.mul(a1, t2))),
        )
        dinv = B.inv(delta)
        return (B.mul(t0, dinv), B.mul(t1, dinv), B.mul(t2, dinv))

    def eq(self, a, b) -> bool:
        return all(self.base.eq(x, y) for x, y in zip(a, b))

    def is_zero(self, a) -> bool:
        return all(self.base.is_zero(x) for x in a)

    def rand(self, rng: random.Random | None = None):
        return tuple(self.base.rand(rng) for _ in range(self.k))

    def pow(self, a, e: int):
        result = self.one()
        base = a
        while e > 0:
            if e & 1:
                result = self.mul(result, base)
            base = self.sqr(base)
            e >>= 1
        return result

    # -- square roots -------------------------------------------------------
    @property
    def order(self) -> int:
        """Field order q^degree."""
        base_order = (
            self.base.p if isinstance(self.base, PrimeField) else self.base.order
        )
        return base_order**self.k

    def is_square(self, a) -> bool:
        if self.is_zero(a):
            return True
        return self.eq(self.pow(a, (self.order - 1) // 2), self.one())

    def sqrt(self, a):
        """Generic Tonelli-Shanks in the extension field."""
        if self.is_zero(a):
            return self.zero()
        if not self.is_square(a):
            raise ValueError("not a square in extension field")
        o = self.order
        q, s = o - 1, 0
        while q % 2 == 0:
            q //= 2
            s += 1
        # find a non-square deterministically
        rng = random.Random(0xF00D)
        while True:
            z = self.rand(rng)
            if not self.is_zero(z) and not self.is_square(z):
                break
        m, c, t, r0 = s, self.pow(z, q), self.pow(a, q), self.pow(a, (q + 1) // 2)
        while not self.eq(t, self.one()):
            i, t2 = 0, t
            while not self.eq(t2, self.one()):
                t2 = self.sqr(t2)
                i += 1
            b = self.pow(c, 1 << (m - i - 1))
            m, c = i, self.sqr(b)
            t, r0 = self.mul(t, c), self.mul(r0, b)
        return r0

    # -- embedding / flattening --------------------------------------------
    def embed(self, x: int):
        """Embed an integer scalar from the bottom prime field."""
        return self.from_base(self.base.embed(x))

    def to_list(self, a) -> list[int]:
        out: list[int] = []
        for c in a:
            out.extend(self.base.to_list(c))
        return out

    def from_list(self, coeffs: Sequence[int]):
        step = self.degree // self.k
        return tuple(
            self.base.from_list(coeffs[i * step : (i + 1) * step])
            for i in range(self.k)
        )


# ---------------------------------------------------------------------------
# Tower construction per curve
# ---------------------------------------------------------------------------

from . import params as _P  # noqa: E402


class _Towers:
    """Lazily-built field towers for each supported curve."""

    def __init__(self):
        self._cache: dict[str, dict[str, Any]] = {}

    def __call__(self, curve_name: str) -> dict[str, Any]:
        if curve_name in self._cache:
            return self._cache[curve_name]
        t = self._build(curve_name)
        self._cache[curve_name] = t
        return t

    @staticmethod
    def _build(curve_name: str) -> dict[str, Any]:
        c = _P.CURVES[curve_name]
        fq = PrimeField(c.q)
        fr = PrimeField(c.r)
        t: dict[str, Any] = {"fq": fq, "fr": fr}
        if curve_name == "bls12-377":
            fq2 = BinomialExt(fq, 2, _P.BLS12_377_FQ2_QNR)
            fq6 = BinomialExt(fq2, 3, fq2.gen())  # v^3 = u
            fq12 = BinomialExt(fq6, 2, fq6.gen())  # w^2 = v
            t.update(fq2=fq2, fq6=fq6, fq12=fq12, fg2=fq2, fqk=fq12)
        elif curve_name == "bw6-761":
            fq3 = BinomialExt(fq, 3, _P.BW6_761_XI)  # v^3 = -4
            fq6 = BinomialExt(fq3, 2, fq3.gen())  # w^2 = v
            t.update(fq3=fq3, fq6=fq6, fg2=fq, fqk=fq6)
        elif curve_name == "mnt4-298":
            fq2 = BinomialExt(fq, 2, _P.MNT4_298_QNR)
            fq4 = BinomialExt(fq2, 2, fq2.gen())  # w^2 = u
            t.update(fq2=fq2, fq4=fq4, fg2=fq2, fqk=fq4)
        elif curve_name == "mnt6-298":
            fq3 = BinomialExt(fq, 3, _P.MNT6_298_QNR)
            fq6 = BinomialExt(fq3, 2, fq3.gen())  # w^2 = v
            t.update(fq3=fq3, fq6=fq6, fg2=fq3, fqk=fq6)
        else:
            raise KeyError(curve_name)
        return t


towers = _Towers()


def batch_inverse(F, vals):
    """Montgomery batch inversion over any field-ops object: one F.inv +
    3(n-1) muls instead of n inversions.  Zero entries map to zero.

    The device->host point unpacking after setup's fixed-base multiplies
    inverts one Z per point; done naively that is n modular
    exponentiations and dominates trusted-setup wall time."""
    n = len(vals)
    one = F.one()
    prefix = [one] * (n + 1)
    for i, v in enumerate(vals):
        prefix[i + 1] = prefix[i] if F.is_zero(v) else F.mul(prefix[i], v)
    running = F.inv(prefix[n])
    out = [F.zero()] * n
    for i in range(n - 1, -1, -1):
        v = vals[i]
        if not F.is_zero(v):
            out[i] = F.mul(prefix[i], running)
            running = F.mul(running, v)
    return out
