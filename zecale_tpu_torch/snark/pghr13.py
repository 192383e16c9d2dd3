# Copied from zecale_tpu/snark/pghr13.py (JAX-free); only imports and build paths changed.
"""PGHR13 (Pinocchio / BCTV14) zk-SNARK — the reference's alternate snark
backend (ZECALE_SNARK=PGHR13; libzeth pghr13_snark wrapper, SURVEY.md
section 2b "libsnark — PGHR13").

Fresh implementation of the scheme from its algebra.  Key/proof shapes:

  pk: A_query  (knowledge pairs [rA At_i]1, [alphaA rA At_i]1; public
               entries zeroed -- their coefficients live in vk.IC),
      B_query  ([rB Bt_i]2, [alphaB rB Bt_i]1),
      C_query  ([rC Ct_i]1, [alphaC rC Ct_i]1),
      K_query  ([beta (rA At_i + rB Bt_i + rC Ct_i)]1),
      H_query  ([t^i]1)
      where the coefficient vectors are extended by three ZK slots:
      At[m+1] = Z(t), Bt[m+2] = Z(t), Ct[m+3] = Z(t).
  vk: [alphaA]2, [alphaB]1, [alphaC]2, [gamma]2, [gamma beta]1,
      [gamma beta]2, [rC Z(t)]2, IC = [rA A_i(t)]1 for public i.

  verify (5 pairing checks), acc = IC_0 + sum input_i IC_{i+1}:
    1. e(A,  alphaA_g2)  == e(A',  g2)
    2. e(alphaB_g1,  B)  == e(B',  g2)
    3. e(C,  alphaC_g2)  == e(C',  g2)
    4. e(K,  gamma_g2)   == e(acc + A + C, gamma_beta_g2)
                            * e(gamma_beta_g1, B)
    5. e(acc + A,  B)    == e(H, rC_Z_g2) * e(C, g2)

JSON encoding follows the zeth pghr13 naming: proof keys
{a, a_p, b, b_p, c, c_p, h, k}; vk keys {a, b, c, g, gb1, gb2, z, IC}.
"""

from __future__ import annotations

import dataclasses
import random
from typing import Any, List, Optional, Sequence

from ..ec import host_curve as hc
from ..ff import params as P
from ..pairing import host_pairing as hp
from ..poly.domain_host import domain
from .r1cs import R1CS


@dataclasses.dataclass
class Pghr13Proof:
    a: Any  # G1   [rA A(t)]
    a_p: Any  # G1 [alphaA rA A(t)]
    b: Any  # G2   [rB B(t)]
    b_p: Any  # G1 [alphaB rB B(t)]
    c: Any  # G1   [rC C(t)]
    c_p: Any  # G1 [alphaC rC C(t)]
    h: Any  # G1   [H(t)]
    k: Any  # G1   [beta(...)]


@dataclasses.dataclass
class Pghr13VerificationKey:
    a: Any  # alphaA_g2
    b: Any  # alphaB_g1
    c: Any  # alphaC_g2
    g: Any  # gamma_g2
    gb1: Any  # gamma_beta_g1
    gb2: Any  # gamma_beta_g2
    z: Any  # rC_Z_g2
    ic: List[Any]


@dataclasses.dataclass
class Pghr13ProvingKey:
    a_query: List[Any]  # (g1, g1) pairs
    b_query: List[Any]  # (g2, g1) pairs
    c_query: List[Any]  # (g1, g1) pairs
    k_query: List[Any]
    h_query: List[Any]


@dataclasses.dataclass
class Pghr13KeyPair:
    pk: Pghr13ProvingKey
    vk: Pghr13VerificationKey


class Pghr13:
    name = "PGHR13"

    def __init__(self, curve_name: str):
        self.curve_name = curve_name
        self.params = P.CURVES[curve_name]
        self.ctx = hp.ctx(curve_name)
        self.g1 = self.ctx.g1
        self.g2 = self.ctx.g2
        self.r = self.params.r

    # -- overridable batched group primitives ---------------------------
    def _g1_many(self, scalars: Sequence[int]) -> List:
        g1gen, _ = hc.generators(self.curve_name)
        return [self.g1.mul(k % self.r, g1gen) for k in scalars]

    def _g2_many(self, scalars: Sequence[int]) -> List:
        _, g2gen = hc.generators(self.curve_name)
        return [self.g2.mul(k % self.r, g2gen) for k in scalars]

    def _msm_g1(self, scalars: Sequence[int], pts: Sequence):
        return self.g1.msm(scalars, pts)

    def _msm_g2(self, scalars: Sequence[int], pts: Sequence):
        return self.g2.msm(scalars, pts)

    # ------------------------------------------------------------------
    def generate_setup(
        self, r1cs: R1CS, rng: Optional[random.Random] = None
    ) -> Pghr13KeyPair:
        rng = rng or random.Random()
        r = self.r
        t = rng.randrange(1, r)
        alphaA = rng.randrange(1, r)
        alphaB = rng.randrange(1, r)
        alphaC = rng.randrange(1, r)
        rhoA = rng.randrange(1, r)
        rhoB = rng.randrange(1, r)
        beta = rng.randrange(1, r)
        gamma = rng.randrange(1, r)
        rhoC = rhoA * rhoB % r

        num_vars = r1cs.num_variables
        num_pub = r1cs.num_primary + 1
        a_at, b_at, c_at = r1cs.qap_evaluations(t, r)
        d_size, z_t = r1cs.domain_vanishing(t, r)

        # extended coefficient vectors with the three ZK slots
        At = list(a_at) + [z_t, 0, 0]
        Bt = list(b_at) + [0, z_t, 0]
        Ct = list(c_at) + [0, 0, z_t]
        m = len(At)

        ic = [rhoA * At[i] % r for i in range(num_pub)]
        At_priv = list(At)
        for i in range(num_pub):
            At_priv[i] = 0  # public A coefficients live in vk.IC

        # every setup element is a fixed-base multiple of a generator:
        # batched through _g1_many/_g2_many so Pghr13Native can route
        # them to the C engine's fixed-base ladder
        tp = [1] * (d_size + 1)
        for i in range(1, d_size + 1):
            tp[i] = tp[i - 1] * t % r
        aq0 = self._g1_many([rhoA * v for v in At_priv])
        aq1 = self._g1_many([alphaA * rhoA % r * v for v in At_priv])
        bq0 = self._g2_many([rhoB * v for v in Bt])
        bq1 = self._g1_many([alphaB * rhoB % r * v for v in Bt])
        cq0 = self._g1_many([rhoC * v for v in Ct])
        cq1 = self._g1_many([alphaC * rhoC % r * v for v in Ct])
        k_query = self._g1_many(
            [
                beta * (rhoA * At[i] + rhoB * Bt[i] + rhoC * Ct[i]) % r
                for i in range(m)
            ]
        )
        h_query = self._g1_many(tp)
        a_query = list(zip(aq0, aq1))
        b_query = list(zip(bq0, bq1))
        c_query = list(zip(cq0, cq1))
        g1gen, g2gen = hc.generators(self.curve_name)
        G1 = lambda k: self.g1.mul(k % r, g1gen)  # noqa: E731
        G2 = lambda k: self.g2.mul(k % r, g2gen)  # noqa: E731

        pk = Pghr13ProvingKey(
            a_query=a_query,
            b_query=b_query,
            c_query=c_query,
            k_query=k_query,
            h_query=h_query,
        )
        vk = Pghr13VerificationKey(
            a=G2(alphaA),
            b=G1(alphaB),
            c=G2(alphaC),
            g=G2(gamma),
            gb1=G1(gamma * beta % r),
            gb2=G2(gamma * beta % r),
            z=G2(rhoC * z_t % r),
            ic=[G1(v) for v in ic],
        )
        return Pghr13KeyPair(pk=pk, vk=vk)

    # ------------------------------------------------------------------
    def prove(
        self,
        r1cs: R1CS,
        pk: Pghr13ProvingKey,
        assignment: Sequence[int],
        rng: Optional[random.Random] = None,
    ) -> Pghr13Proof:
        rng = rng or random.Random()
        r = self.r
        d1, d2, d3 = (rng.randrange(r) for _ in range(3))

        # full coefficient vector incl. the ZK slots
        coeffs = [a % r for a in assignment] + [d1, d2, d3]

        # H'(x) = H(x) + d2 A(x) + d1 B(x) + d1 d2 Z(x) - d3
        h = r1cs.h_coefficients(assignment, r)
        d = domain(r1cs.qap_degree, r)
        az, bz, _ = r1cs.abc_evaluations(assignment)
        a_poly = d.ifft(az)
        b_poly = d.ifft(bz)
        hp_coeffs = [0] * (d.size + 1)
        for i, v in enumerate(h):
            hp_coeffs[i] = v
        for i in range(d.size):
            hp_coeffs[i] = (
                hp_coeffs[i] + d2 * a_poly[i] + d1 * b_poly[i]
            ) % r
        # + d1 d2 Z(x) (sparse: (x^n - 1) for basic domains, the coset-union
        # product for extended domains) - d3
        for ze, zc in d.z_coefficients():
            hp_coeffs[ze] = (hp_coeffs[ze] + d1 * d2 % r * zc) % r
        hp_coeffs[0] = (hp_coeffs[0] - d3) % r

        def msm1(queries, idx: int):
            return self._msm_g1(coeffs, [q[idx] for q in queries])

        A = msm1(pk.a_query, 0)
        Ap = msm1(pk.a_query, 1)
        B = self._msm_g2(coeffs, [q[0] for q in pk.b_query])
        Bp = msm1(pk.b_query, 1)
        C = msm1(pk.c_query, 0)
        Cp = msm1(pk.c_query, 1)
        K = self._msm_g1(coeffs, pk.k_query)
        H = self._msm_g1(hp_coeffs, pk.h_query)
        return Pghr13Proof(a=A, a_p=Ap, b=B, b_p=Bp, c=C, c_p=Cp, h=H, k=K)

    # ------------------------------------------------------------------
    def verify(
        self,
        inputs: Sequence[int],
        proof: Pghr13Proof,
        vk: Pghr13VerificationKey,
    ) -> bool:
        if len(inputs) + 1 != len(vk.ic):
            return False
        g1, g2 = self.g1, self.g2
        for pt, crv in (
            (proof.a, g1),
            (proof.a_p, g1),
            (proof.b, g2),
            (proof.b_p, g1),
            (proof.c, g1),
            (proof.c_p, g1),
            (proof.h, g1),
            (proof.k, g1),
        ):
            if not crv.is_on_curve(pt):
                return False
        r = self.r
        acc = vk.ic[0]
        for x, pt in zip(inputs, vk.ic[1:]):
            acc = g1.add(acc, g1.mul(x % r, pt))
        _, g2gen = hc.generators(self.curve_name)
        e = self.ctx
        try:  # native C pairing engine when available (all four curves)
            from ..native import pairing as _np

            npair = {
                "bw6-761": _np.bw6,
                "bls12-377": _np.bls12,
            }.get(self.curve_name, lambda: _np.generic(self.curve_name))()
        except Exception:
            npair = None
        if npair is not None:
            e = npair

        def check(pairs) -> bool:
            return e.pairing_product_is_one(pairs)

        # 1. e(A, alphaA_g2) e(-A', g2) == 1
        if not check([(proof.a, vk.a), (g1.neg(proof.a_p), g2gen)]):
            return False
        # 2. e(alphaB_g1, B) e(-B', g2) == 1
        if not check([(vk.b, proof.b), (g1.neg(proof.b_p), g2gen)]):
            return False
        # 3. e(C, alphaC_g2) e(-C', g2) == 1
        if not check([(proof.c, vk.c), (g1.neg(proof.c_p), g2gen)]):
            return False
        # 4. e(K, gamma_g2) == e(acc + A + C, gamma_beta_g2)
        #                      * e(gamma_beta_g1, B)
        aAC = g1.add(acc, g1.add(proof.a, proof.c))
        if not check(
            [
                (proof.k, vk.g),
                (g1.neg(aAC), vk.gb2),
                (g1.neg(vk.gb1), proof.b),
            ]
        ):
            return False
        # 5. e(acc + A, B) == e(H, rC_Z_g2) * e(C, g2)
        accA = g1.add(acc, proof.a)
        return check(
            [
                (accA, proof.b),
                (g1.neg(proof.h), vk.z),
                (g1.neg(proof.c), g2gen),
            ]
        )


class Pghr13Native(Pghr13):
    """PGHR13 with the C engine (csrc/ec_engine.c) behind setup and
    prove: fixed-base ladders for the key queries, Pippenger MSMs for
    the eight proof elements.  Same keys/proofs/verify as Pghr13 — only
    the group-op backend changes.  Needed for full-recursion parity: a
    PGHR13 *wrapper* over BW6-761 (reference ZECALE_SNARK=PGHR13,
    aggregator_dummy_test.cpp:189-240) proves ~30k-constraint circuits,
    hours in pure-host bigints, seconds natively."""

    def __init__(self, curve_name: str):
        super().__init__(curve_name)
        from ..native import ec as nec

        assert nec.available(), "native engine unavailable"
        self._n1 = nec.NativeCurve(curve_name, g2=False)
        self._n2 = nec.NativeCurve(curve_name, g2=True)

    def _g1_many(self, scalars: Sequence[int]) -> List:
        g1gen, _ = hc.generators(self.curve_name)
        return self._n1.fixed_base_mul_batch(
            [k % self.r for k in scalars], g1gen
        )

    def _g2_many(self, scalars: Sequence[int]) -> List:
        _, g2gen = hc.generators(self.curve_name)
        return self._n2.fixed_base_mul_batch(
            [k % self.r for k in scalars], g2gen
        )

    def _filter(self, scalars, pts):
        out_s, out_p = [], []
        for s, p in zip(scalars, pts):
            if p is None or s % self.r == 0:
                continue
            out_s.append(s % self.r)
            out_p.append(p)
        return out_s, out_p

    def _msm_g1(self, scalars: Sequence[int], pts: Sequence):
        s, p = self._filter(scalars, pts)
        if not p:
            return None
        return self._n1.msm(s, p)

    def _msm_g2(self, scalars: Sequence[int], pts: Sequence):
        s, p = self._filter(scalars, pts)
        if not p:
            return None
        return self._n2.msm(s, p)
