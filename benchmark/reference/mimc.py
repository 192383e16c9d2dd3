"""MiMC of the reference: the permutation x -> (x + k + c_i)^17 over a
prime field, ceil(bits / log2 17) rounds with round constants from SHA3
of a fixed seed, the Miyaguchi-Preneel compression MP(m, k) = E_k(m) + m
+ k, and the input hash that chains MP over a list (the construction of
upstream Zeth's and Zecale's MiMC gadgets).  Frozen with the benchmark."""

from __future__ import annotations

import functools
import hashlib
import math
from typing import Sequence

SEED = b"clearmatics_mt_seed"
EXPONENT = 17


@functools.lru_cache(maxsize=None)
def round_constants(r: int) -> tuple:
    rounds = math.ceil(r.bit_length() / math.log2(EXPONENT))
    out = [0]
    for i in range(1, rounds):
        h = hashlib.sha3_256(SEED + i.to_bytes(8, "big")).digest()
        out.append(int.from_bytes(h, "big") % r)
    return tuple(out)


def mimc_mp(m: int, k: int, r: int) -> int:
    x = m
    for c in round_constants(r):
        x = pow((x + k + c) % r, EXPONENT, r)
    return ((x + k) % r + m + k) % r


def mimc_hash_inputs(values: Sequence[int], r: int) -> int:
    h = 0
    for v in values:
        h = mimc_mp(v % r, h, r)
    return h
