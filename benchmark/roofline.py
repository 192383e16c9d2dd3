"""The benchmark's table of peaks and its count of the least work an MSM
needs, frozen with the benchmark so that every engine is held to the
same count.

Peaks of one NVIDIA H100 SXM at its 700 W limit: HBM3 at 3.35 TB/s
(NVIDIA's data sheet) and 16.7 T int32 multiply-adds a second, the CUDA
programming guide's 64 IMAD per SM per clock x 132 SMs x 1.98 GHz.

An MSM of n points with b-bit scalars over a field of L 32-bit limbs
(G2 of BLS12-377 over Fq2) needs at its best window c, with signed
digits, ceil(b / c) windows, each of n mixed additions into 2^(c-1)
buckets and 2^c full additions to sum them, and b doublings to join the
windows.  A base-field product is 2 L^2 32-bit products, two multiply-
adds each (low and high halves); an addition costs 11 products mixed, 12
full, a doubling 8 (over Fq2 three base products each, plus two Fq2
products for the twist's b3).  Bytes: every point and scalar read once.

Only the work a scalar asks for is counted: a point at infinity or with
scalar 0 costs nothing, one with scalar 1 one mixed addition (its point
read, no scalar), and only the others enter the windows, each with the
field's full bits (a small scalar's high windows are still counted).
"""

from __future__ import annotations

import math

INT32_OPS_PER_S = 132 * 64 * 1.98e9
HBM_BYTES_PER_S = 3.35e12


def limbs(q: int) -> int:
    return -(-q.bit_length() // 32)


def _products(ext: int) -> tuple:
    """(mixed add, full add, doubling) base-field products."""
    if ext == 1:
        return 11, 12, 8
    return 3 * (11 + 2), 3 * (12 + 2), 3 * 9


def msm_ops(n: int, bits: int, q: int, ext: int, ones: int = 0) -> float:
    """int32 multiply-adds of the MSM at its best window: n scalars that
    are neither 0 nor 1, and ``ones`` scalars 1."""
    madd, add, dbl = _products(ext)
    win = 0
    if n:
        win = min(math.ceil(bits / c) * (n * madd + (1 << c) * add)
                  for c in range(1, 25)) + bits * dbl
    return (win + ones * madd) * 4 * limbs(q) ** 2


def msm_bytes(n: int, bits: int, q: int, ext: int, ones: int = 0) -> float:
    return (n + ones) * 2 * ext * limbs(q) * 4 + n * 4 * -(-bits // 32)


def msm_least_s(n: int, bits: int, q: int, ext: int, ones: int = 0
                ) -> float:
    """Least seconds the card could take for the MSM."""
    return max(msm_ops(n, bits, q, ext, ones) / INT32_OPS_PER_S,
               msm_bytes(n, bits, q, ext, ones) / HBM_BYTES_PER_S)


def _split(points, scalars) -> tuple:
    """(scalars neither 0 nor 1, scalars 1) over the points that are not
    at infinity."""
    n = ones = 0
    for p, s in zip(points, scalars):
        if p is None or s == 0:
            continue
        if s == 1:
            ones += 1
        else:
            n += 1
    return n, ones


def groth16_msms(num_primary: int, pk, assignment) -> list:
    """The five MSMs of a Groth16 prove of ``assignment`` (variable 0 the
    constant one) under the proving key ``pk`` -> [(group, n, ones)]: A,
    B in G1 and in G2 over every variable, L over the auxiliary ones, H
    over its query's points, whose scalars (the quotient's coefficients)
    are taken as dense."""
    aux = assignment[num_primary + 1:]
    h = sum(p is not None for p in pk.h_query)
    return [("g1",) + _split(pk.a_query, assignment),
            ("g1",) + _split(pk.b_g1_query, assignment),
            ("g2",) + _split(pk.b_g2_query, assignment),
            ("g1",) + _split(pk.l_query, aux),
            ("g1", h, 0)]
