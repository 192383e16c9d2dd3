# Copied from zecale_tpu/gadgets/mnt_pairing_gadget.py (JAX-free); only imports and build paths changed.
"""In-circuit MNT4-298 pairing for the MNT6-298 wrapper circuit.

The alternate-curve analog of pairing_gadget.BLS12PairingGadget (reference:
libsnark's mnt_pairing_params used by ZECALE_CURVE=MNT6 builds,
aggregator_server.cpp:36-41), designed from the pairing algebra:

  * ate pairing e(P, Q) = f_{t-1,Q}(P) ^ ((q^4-1)/r), loop scalar
    T = |t - 1| with t the trace of Frobenius (about 149 bits);
  * G2 on the quadratic twist by u over Fq2 (a2 = a u^2, b2 = b u^3);
    untwist psi(x, y) = (x/u, y u^-2 w), w^2 = u in Fq4 = Fq2[w];
  * line evaluation at P = (xp, yp):
      l(P) = yp + w * (u^-2 (lam x_T - y_T) - u^-1 lam xp)
    with lam the twisted slope in Fq2 -- i.e. an Fq4 element whose c0 is
    the scalar yp and whose c1 is an Fq2 expression;
  * final exponentiation: easy part f^(q^2-1) (conjugation via Frobenius +
    one Fq4 inversion), then a plain square-and-multiply by the ~300-bit
    constant (q^2+1)/r (Fq4 muls are only 9 native muls, so the naive hard
    part costs a few thousand constraints).
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

from ..ec import host_curve as hc
from ..ff import host_field as hf
from ..ff import params as P
from .curve_ops import CurveGadget
from .field_ext import GadgetExt, GadgetFp
from .protoboard import LC, Protoboard

_q = P.MNT4_298_Q
_r = P.MNT4_298_R
_t = P.MNT4_298_T

ATE_LOOP_MNT4 = abs(_t - 1)
ATE_IS_NEG = (_t - 1) < 0
ATE_BITS = bin(ATE_LOOP_MNT4)[2:]

assert (_q**2 + 1) % _r == 0
HARD_EXP = (_q**2 + 1) // _r


@dataclasses.dataclass
class LineCoeffs:
    is_add: bool
    lam: object  # Fq2 gadget elem (twisted slope)
    c: object  # Fq2 gadget elem: lam * x_T - y_T


class MNT4PairingGadget:
    """Same interface as BLS12PairingGadget, for nested MNT4-298."""

    def __init__(self, pb: Protoboard, towers: dict):
        self.pb = pb
        self.fq: GadgetFp = towers["fq"]
        self.fq2: GadgetExt = towers["fq2"]
        self.fqk: GadgetExt = towers["fq4"]
        self.host_g2 = hc.g2_curve("mnt4-298")
        self.g2_gadget = CurveGadget(
            self.fq2, self.host_g2.a, self.host_g2.b
        )
        self.host_fq2 = hf.towers("mnt4-298")["fq2"]
        h2 = self.host_fq2
        fq_host = hf.towers("mnt4-298")["fq"]
        u = h2.gen()
        self._u_inv = h2.inv(u)  # host constants for the line build
        self._u_inv2 = h2.sqr(self._u_inv)

    # ------------------------------------------------------------------
    def _dbl_step(self, T):
        """One G2 doubling with coefficients (general a)."""
        F2, g = self.fq2, self.g2_gadget
        xt, yt = T
        xx = F2.sqr(xt)
        num = F2.add(F2.add(F2.add(xx, xx), xx), F2.constant(self.host_g2.a))
        lam = g._div(num, F2.add(yt, yt))
        c = F2.sub(F2.mul(lam, xt), yt)
        lam2 = F2.sqr(lam)
        x3 = F2.sub(lam2, F2.add(xt, xt))
        y3 = F2.sub(F2.mul(lam, F2.sub(xt, x3)), yt)
        return (x3, y3), LineCoeffs(False, lam, c)

    def _add_step(self, T, Q):
        F2, g = self.fq2, self.g2_gadget
        xt, yt = T
        xq, yq = Q
        lam = g._div(F2.sub(yq, yt), F2.sub(xq, xt))
        c = F2.sub(F2.mul(lam, xt), yt)
        lam2 = F2.sqr(lam)
        x3 = F2.sub(F2.sub(lam2, xt), xq)
        y3 = F2.sub(F2.mul(lam, F2.sub(xt, x3)), yt)
        return (x3, y3), LineCoeffs(True, lam, c)

    def g2_precompute(self, q_pt) -> List[LineCoeffs]:
        coeffs: List[LineCoeffs] = []
        T = q_pt
        for bit in ATE_BITS[1:]:
            T, lc = self._dbl_step(T)
            coeffs.append(lc)
            if bit == "1":
                T, lc = self._add_step(T, q_pt)
                coeffs.append(lc)
        return coeffs

    def g2_precompute_const(self, host_q) -> List[LineCoeffs]:
        H2 = self.host_fq2
        crv = self.host_g2
        coeffs: List[LineCoeffs] = []
        T = host_q
        for bit in ATE_BITS[1:]:
            xt, yt = T
            xx = H2.sqr(xt)
            lam = H2.mul(
                H2.add(H2.add(H2.add(xx, xx), xx), crv.a),
                H2.inv(H2.add(yt, yt)),
            )
            c = H2.sub(H2.mul(lam, xt), yt)
            coeffs.append(
                LineCoeffs(False, self.fq2.constant(lam), self.fq2.constant(c))
            )
            T = crv.dbl(T)
            if bit == "1":
                xt, yt = T
                xq, yq = host_q
                lam = H2.mul(H2.sub(yq, yt), H2.inv(H2.sub(xq, xt)))
                c = H2.sub(H2.mul(lam, xt), yt)
                coeffs.append(
                    LineCoeffs(
                        True, self.fq2.constant(lam), self.fq2.constant(c)
                    )
                )
                T = crv.add(T, host_q)
        return coeffs

    # ------------------------------------------------------------------
    def _line_fq4(self, coeff: LineCoeffs, p_pt):
        """l(P) = yp + w (u^-2 c - u^-1 lam xp) as an Fq4 element."""
        F2, pb = self.fq2, self.pb
        xp, yp = p_pt
        lam_xp = tuple(pb.mul(comp, xp) for comp in coeff.lam)
        c1 = F2.sub(
            F2.mul_constant(coeff.c, self._u_inv2),
            F2.mul_constant(lam_xp, self._u_inv),
        )
        c0 = (yp, LC())  # yp embedded in Fq2
        return (c0, c1)

    def multi_miller(self, pairs: Sequence[Tuple[List[LineCoeffs], Tuple[LC, LC]]]):
        F4 = self.fqk
        f = F4.one()
        idx = 0
        first = True
        for bit in ATE_BITS[1:]:
            if not first:
                f = F4.sqr(f)
            for chain, p_pt in pairs:
                coeff = chain[idx]
                assert not coeff.is_add
                f = F4.mul(f, self._line_fq4(coeff, p_pt))
            idx += 1
            if bit == "1":
                for chain, p_pt in pairs:
                    coeff = chain[idx]
                    assert coeff.is_add
                    f = F4.mul(f, self._line_fq4(coeff, p_pt))
                idx += 1
            first = False
        if ATE_IS_NEG:
            f = F4.inv(f)
        return f

    # ------------------------------------------------------------------
    def final_exponentiation(self, f):
        F4 = self.fqk
        # easy: m = f^(q^2 - 1) = frob^2(f) * f^-1
        f_inv = F4.inv(f)
        m = F4.mul(F4.frobenius(f, 2), f_inv)
        # hard: m^((q^2+1)/r), m is in the cyclotomic subgroup so the
        # inverse-free binary ladder is just square-and-multiply
        acc = m
        for bit in bin(HARD_EXP)[3:]:
            acc = F4.sqr(acc)
            if bit == "1":
                acc = F4.mul(acc, m)
        return acc

    def pairing_product_result(self, pairs):
        return self.final_exponentiation(self.multi_miller(pairs))

    def is_one_bit(self, f) -> LC:
        return self.fqk.is_equal_bit(f, self.fqk.one())
