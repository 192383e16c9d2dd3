# Frozen copy of zecale_tpu_torch/ec/host_curve.py for the benchmark's reference; only imports changed.
"""Host-side (pure Python) short-Weierstrass elliptic curve arithmetic.

Generic over any field context from ``zecale_tpu.ff.host_field``.  Points are
affine tuples ``(x, y)`` with ``None`` as the point at infinity; a Jacobian
path is provided for inversion-free bulk work and doubles as the oracle for
the batched JAX Jacobian kernels (zecale_tpu/ec/jac_jax.py).

Replaces what the reference pulls from libff's curve templates (SURVEY.md
section 2b, "libff — curves").
"""

from __future__ import annotations

import random
from typing import Any, Optional, Tuple

from . import host_field as hf
from . import params as P

AffinePoint = Optional[Tuple[Any, Any]]


class WeierstrassCurve:
    """y^2 = x^3 + a x + b over field context ``F``."""

    def __init__(self, F, a, b, order: int | None = None, cofactor: int | None = None):
        self.F = F
        self.a = a
        self.b = b
        self.order = order  # prime subgroup order r (if known)
        self.cofactor = cofactor

    # -- predicates ---------------------------------------------------------
    def is_on_curve(self, pt: AffinePoint) -> bool:
        if pt is None:
            return True
        F = self.F
        x, y = pt
        lhs = F.sqr(y)
        rhs = F.add(F.add(F.mul(F.sqr(x), x), F.mul(self.a, x)), self.b)
        return F.eq(lhs, rhs)

    def in_subgroup(self, pt: AffinePoint) -> bool:
        if pt is None:
            return True
        assert self.order is not None
        # NB: must bypass mul()'s scalar reduction mod the order.
        return self._mul_raw(self.order, pt) is None

    def eq(self, p: AffinePoint, q: AffinePoint) -> bool:
        if p is None or q is None:
            return p is None and q is None
        return self.F.eq(p[0], q[0]) and self.F.eq(p[1], q[1])

    # -- group law ----------------------------------------------------------
    def neg(self, p: AffinePoint) -> AffinePoint:
        if p is None:
            return None
        return (p[0], self.F.neg(p[1]))

    def dbl(self, p: AffinePoint) -> AffinePoint:
        if p is None:
            return None
        F = self.F
        x, y = p
        if F.is_zero(y):
            return None
        lam = F.mul(
            F.add(F.mul_scalar(F.sqr(x), 3), self.a), F.inv(F.add(y, y))
        )
        x3 = F.sub(F.sqr(lam), F.add(x, x))
        y3 = F.sub(F.mul(lam, F.sub(x, x3)), y)
        return (x3, y3)

    def add(self, p: AffinePoint, q: AffinePoint) -> AffinePoint:
        if p is None:
            return q
        if q is None:
            return p
        F = self.F
        x1, y1 = p
        x2, y2 = q
        if F.eq(x1, x2):
            if F.eq(y1, y2):
                return self.dbl(p)
            return None  # P + (-P)
        lam = F.mul(F.sub(y2, y1), F.inv(F.sub(x2, x1)))
        x3 = F.sub(F.sub(F.sqr(lam), x1), x2)
        y3 = F.sub(F.mul(lam, F.sub(x1, x3)), y1)
        return (x3, y3)

    def sub(self, p: AffinePoint, q: AffinePoint) -> AffinePoint:
        return self.add(p, self.neg(q))

    def mul(self, k: int, p: AffinePoint) -> AffinePoint:
        """Scalar multiplication (double-and-add over Jacobian).

        The scalar is reduced mod the subgroup order when known (callers in
        the SNARK layer pass field elements); use _mul_raw for group-order
        questions such as subgroup membership.
        """
        if self.order is not None:
            k %= self.order
        return self._mul_raw(k, p)

    def _mul_raw(self, k: int, p: AffinePoint) -> AffinePoint:
        if k == 0 or p is None:
            return None
        if k < 0:
            return self._mul_raw(-k, self.neg(p))
        R = None
        for bit in bin(k)[2:]:
            R = self.jac_dbl(R)
            if bit == "1":
                R = self.jac_add_mixed(R, p)
        return self.from_jacobian(R)

    def msm(self, scalars, points) -> AffinePoint:
        """Reference multi-scalar multiplication (naive host path)."""
        acc = None
        for k, p in zip(scalars, points):
            if k == 0 or p is None:
                continue
            jp = self.to_jacobian(self.mul(k, p))
            acc = self.jac_add(acc, jp)
        return self.from_jacobian(acc)

    # -- Jacobian coordinates ----------------------------------------------
    # (X, Y, Z) with x = X/Z^2, y = Y/Z^3; None is infinity.
    def to_jacobian(self, p: AffinePoint):
        if p is None:
            return None
        return (p[0], p[1], self.F.one())

    def from_jacobian(self, jp) -> AffinePoint:
        if jp is None:
            return None
        F = self.F
        X, Y, Z = jp
        if F.is_zero(Z):
            return None
        zinv = F.inv(Z)
        zinv2 = F.sqr(zinv)
        return (F.mul(X, zinv2), F.mul(Y, F.mul(zinv2, zinv)))

    def jac_dbl(self, p):
        if p is None:
            return None
        F = self.F
        X1, Y1, Z1 = p
        if F.is_zero(Y1):
            return None
        # dbl-2007-bl (general a)
        XX = F.sqr(X1)
        YY = F.sqr(Y1)
        YYYY = F.sqr(YY)
        ZZ = F.sqr(Z1)
        S = F.mul_scalar(F.sub(F.sub(F.sqr(F.add(X1, YY)), XX), YYYY), 2)
        M = F.add(F.mul_scalar(XX, 3), F.mul(self.a, F.sqr(ZZ)))
        T = F.sub(F.sqr(M), F.mul_scalar(S, 2))
        X3 = T
        Y3 = F.sub(F.mul(M, F.sub(S, T)), F.mul_scalar(YYYY, 8))
        Z3 = F.sub(F.sub(F.sqr(F.add(Y1, Z1)), YY), ZZ)
        return (X3, Y3, Z3)

    def jac_add(self, p, q):
        if p is None:
            return q
        if q is None:
            return p
        F = self.F
        X1, Y1, Z1 = p
        X2, Y2, Z2 = q
        Z1Z1 = F.sqr(Z1)
        Z2Z2 = F.sqr(Z2)
        U1 = F.mul(X1, Z2Z2)
        U2 = F.mul(X2, Z1Z1)
        S1 = F.mul(Y1, F.mul(Z2, Z2Z2))
        S2 = F.mul(Y2, F.mul(Z1, Z1Z1))
        if F.eq(U1, U2):
            if F.eq(S1, S2):
                return self.jac_dbl(p)
            return None
        H = F.sub(U2, U1)
        I = F.sqr(F.mul_scalar(H, 2))
        J = F.mul(H, I)
        rr = F.mul_scalar(F.sub(S2, S1), 2)
        V = F.mul(U1, I)
        X3 = F.sub(F.sub(F.sqr(rr), J), F.mul_scalar(V, 2))
        Y3 = F.sub(F.mul(rr, F.sub(V, X3)), F.mul_scalar(F.mul(S1, J), 2))
        Z3 = F.mul(F.sub(F.sub(F.sqr(F.add(Z1, Z2)), Z1Z1), Z2Z2), H)
        return (X3, Y3, Z3)

    def jac_add_mixed(self, p, q_affine: AffinePoint):
        if q_affine is None:
            return p
        if p is None:
            return self.to_jacobian(q_affine)
        return self.jac_add(p, self.to_jacobian(q_affine))

    # -- point generation ---------------------------------------------------
    def point_from_x(self, x) -> AffinePoint:
        """Return a point with the given x, if one exists (else None)."""
        F = self.F
        rhs = F.add(F.add(F.mul(F.sqr(x), x), F.mul(self.a, x)), self.b)
        try:
            y = F.sqrt(rhs)
        except (ValueError, AttributeError):
            return None
        return (x, y)

    def random_point(self, rng: random.Random | None = None) -> AffinePoint:
        """A random point in the prime-order subgroup (cofactor-cleared)."""
        rng = rng or random
        while True:
            pt = self.point_from_x(self.F.rand(rng))
            if pt is None:
                continue
            if self.cofactor:
                pt = self._mul_raw(self.cofactor, pt)
            if pt is not None:
                return pt


# ---------------------------------------------------------------------------
# Per-curve G1 / G2 construction
# ---------------------------------------------------------------------------


def g1_curve(curve_name: str) -> WeierstrassCurve:
    c = P.CURVES[curve_name]
    t = hf.towers(curve_name)
    fq = t["fq"]
    return WeierstrassCurve(
        fq, fq.from_int(c.a), fq.from_int(c.b), order=c.r,
        cofactor=c.g1_cofactor,
    )


def g2_curve(curve_name: str) -> WeierstrassCurve:
    """The curve that G2 points live on (the twist, in twisted coordinates)."""
    c = P.CURVES[curve_name]
    t = hf.towers(curve_name)
    F = t["fg2"]
    if curve_name == "bls12-377":
        # D-type twist by xi = u: y^2 = x^3 + b/u, b = 1, u^2 = -5
        # 1/u = -u/5  =>  b2 = (0, -(1/5))
        fq = t["fq"]
        b2 = (fq.zero(), fq.neg(fq.inv(fq.from_int(5))))
        return WeierstrassCurve(F, F.zero(), b2, order=c.r,
                                cofactor=c.g2_cofactor)
    if curve_name == "bw6-761":
        # M-type sextic twist over Fq itself: y^2 = x^3 + 4
        return WeierstrassCurve(F, F.zero(), F.from_int(4), order=c.r,
                                cofactor=c.g2_cofactor)
    if curve_name == "mnt4-298":
        # quadratic twist by u: a2 = a * u^2 = a * nr, b2 = b * nr * u
        fq = t["fq"]
        a2 = (fq.mul_scalar(fq.from_int(P.MNT4_298_QNR), c.a), fq.zero())
        b2 = (fq.zero(), fq.mul_scalar(fq.from_int(P.MNT4_298_QNR), c.b))
        return WeierstrassCurve(F, a2, b2, order=c.r, cofactor=c.g2_cofactor)
    if curve_name == "mnt6-298":
        # cubic twist by v: a2 = a * v^2, b2 = b * nr
        fq = t["fq"]
        a2 = (fq.zero(), fq.zero(), fq.from_int(c.a))
        b2 = (
            fq.mul_scalar(fq.from_int(P.MNT6_298_QNR), c.b),
            fq.zero(),
            fq.zero(),
        )
        return WeierstrassCurve(F, a2, b2, order=c.r, cofactor=c.g2_cofactor)
    raise KeyError(curve_name)


# ---------------------------------------------------------------------------
# Generators
# ---------------------------------------------------------------------------

import functools


def _resolve_cofactor(curve: WeierstrassCurve, candidates) -> None:
    """Pick the twist-order cofactor under which cofactor-cleared points land
    in the order-r subgroup (resolves the +-t_e sign ambiguity)."""
    F = curve.F
    for cand in candidates:
        counter = 0
        pt = None
        while pt is None:
            pt = curve.point_from_x(F.from_int(counter)) if getattr(
                F, "degree", 1
            ) == 1 else curve.point_from_x(
                tuple(
                    F.base.from_int((counter >> (16 * i)) & 0xFFFF)
                    for i in range(F.k)
                )
            )
            counter += 1
        cleared = curve._mul_raw(cand, pt)
        if cleared is not None and curve.in_subgroup(cleared):
            curve.cofactor = cand
            return
    raise RuntimeError("no candidate cofactor matched the subgroup order")


def _derive_generator(curve: WeierstrassCurve) -> AffinePoint:
    """Deterministic generator: smallest valid x (coefficients enumerated as
    little-endian integers over the coordinate field), lexicographically
    smaller y, cofactor-cleared.  Used for curves whose reference constants
    are not recorded anywhere in the reference tree (the MNT pair)."""
    F = curve.F
    counter = 0
    while True:
        if getattr(F, "degree", 1) == 1:
            x = F.from_int(counter)
        else:
            # spread the counter over coefficients base-2^16, low first
            coeffs = []
            c = counter
            for _ in range(F.k):
                coeffs.append(c & 0xFFFF)
                c >>= 16
            x = tuple(F.base.from_int(v) for v in coeffs)
        counter += 1
        pt = curve.point_from_x(x)
        if pt is None:
            continue
        x0, y = pt
        y_neg = F.neg(y)
        if F.to_list(y_neg) < F.to_list(y):
            y = y_neg
        pt = (x0, y)
        if curve.cofactor and curve.cofactor != 1:
            # NB: raw multiplication -- the cofactor must NOT be reduced
            # modulo the subgroup order.
            pt = curve._mul_raw(curve.cofactor, pt)
            if pt is None:
                continue
        if curve.order is not None and not curve.in_subgroup(pt):
            continue
        return pt


@functools.lru_cache(maxsize=None)
def generators(curve_name: str):
    """(G1 generator, G2 generator) for the named curve."""
    c = P.CURVES[curve_name]
    g1g = c.g1_generator
    g2g = c.g2_generator
    if g1g is None:
        g1g = _derive_generator(g1_curve(curve_name))
    if g2g is None:
        crv = g2_curve(curve_name)
        if crv.cofactor is None and c.g2_cofactor_candidates:
            _resolve_cofactor(crv, c.g2_cofactor_candidates)
        g2g = _derive_generator(crv)
    return g1g, g2g
