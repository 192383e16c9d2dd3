"""The benchmark's own Groth16 trusted setup, so that the reference judges
the system's proofs under a verification key it computed itself.

Input: a circuit's rank-1 constraints as data (each constraint three
linear combinations of (variable, coefficient) pairs, variable 0 the
constant one, then the primary inputs, then the auxiliary ones).  The
toxic waste tau, alpha, beta, delta is drawn from ``rng``; the QAP is
taken over libfqfft's basic radix-2 domain of size the next power of two
of (constraints + primary inputs + 1), generated by c^((r-1)/n) for c
the least quadratic non-residue, with one hardening row A_i = L_{m+i} for
every public variable i; gamma is fixed to 1, as in the system's keys.
Every fixed-base product runs on the frozen native engine.  Nothing here
imports the system under test.
"""

from __future__ import annotations

import random
from typing import List, Sequence, Tuple

from . import host_curve as hc
from . import native_ec as nec
from . import params as P
from .groth16 import VerificationKey

LinComb = Sequence[Tuple[int, int]]


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p <<= 1
    return p


def _least_qnr(r: int) -> int:
    x = 2
    while pow(x, (r - 1) // 2, r) != r - 1:
        x += 1
    return x


def _batch_inverse(vals: List[int], r: int) -> List[int]:
    prefix = [1] * (len(vals) + 1)
    for i, v in enumerate(vals):
        prefix[i + 1] = prefix[i] * v % r
    inv = pow(prefix[-1], r - 2, r)
    out = [0] * len(vals)
    for i in range(len(vals) - 1, -1, -1):
        out[i] = inv * prefix[i] % r
        inv = inv * vals[i] % r
    return out


def lagrange_at(n: int, tau: int, r: int) -> Tuple[List[int], int]:
    """(L_i(tau) for i < n, Z(tau)) over the radix-2 domain of size n;
    tau is drawn off the domain."""
    assert (r - 1) % n == 0, "the field lacks the domain's 2-adicity"
    omega = pow(_least_qnr(r), (r - 1) // n, r)
    z = (pow(tau, n, r) - 1) % r
    assert z, "tau lies on the domain"
    ws, w = [], 1
    for _ in range(n):
        ws.append(w)
        w = w * omega % r
    inv = _batch_inverse([(tau - w) % r for w in ws], r)
    zn = z * pow(n, r - 2, r) % r
    return [zn * w % r * d % r for w, d in zip(ws, inv)], z


def generate(curve: str, constraints: Sequence[Tuple[LinComb, LinComb,
                                                      LinComb]],
             num_primary: int, num_aux: int, rng: random.Random) -> dict:
    """The keypair of the constraints: {"pk": {alpha_g1, beta_g1, beta_g2,
    delta_g1, delta_g2, a_query, b_g1_query, b_g2_query, l_query,
    h_query}, "vk": VerificationKey}, host affine points (None for the
    point at infinity)."""
    r = P.CURVES[curve].r
    tau, alpha, beta, delta = (rng.randrange(1, r) for _ in range(4))
    delta_inv = pow(delta, r - 2, r)
    nv, npub, m = 1 + num_primary + num_aux, num_primary + 1, len(constraints)
    n = _next_pow2(m + npub)
    lag, z = lagrange_at(n, tau, r)

    at = [[0] * nv for _ in range(3)]
    for row, abc in enumerate(constraints):
        lr = lag[row]
        for side, lc in zip(at, abc):
            for idx, coeff in lc:
                side[idx] = (side[idx] + coeff * lr) % r
    a_at, b_at, c_at = at
    for i in range(npub):
        a_at[i] = (a_at[i] + lag[m + i]) % r

    ic = [(beta * a_at[i] + alpha * b_at[i] + c_at[i]) % r
          for i in range(nv)]
    h, t = [], z * delta_inv % r
    for _ in range(n - 1):
        h.append(t)
        t = t * tau % r

    g1_gen, g2_gen = hc.generators(curve)
    g1 = nec.NativeCurve(curve, g2=False).fixed_base_mul_batch(
        [alpha, beta, delta] + a_at + b_at + ic[:npub]
        + [k * delta_inv % r for k in ic[npub:]] + h, g1_gen)
    g2 = nec.NativeCurve(curve, g2=True).fixed_base_mul_batch(
        [beta, delta] + b_at, g2_gen)
    cuts = [3, 3 + nv, 3 + 2 * nv, 3 + 2 * nv + npub, 3 + 3 * nv]
    a_q, b_q, abc, l_q, h_q = (g1[i:j] for i, j in
                               zip(cuts, cuts[1:] + [len(g1)]))
    pk = {"alpha_g1": g1[0], "beta_g1": g1[1], "beta_g2": g2[0],
          "delta_g1": g1[2], "delta_g2": g2[1], "a_query": a_q,
          "b_g1_query": b_q, "b_g2_query": g2[2:], "l_query": l_q,
          "h_query": h_q}
    return {"pk": pk, "vk": VerificationKey(alpha=g1[0], beta=g2[0],
                                            delta=g2[1], abc=abc)}
