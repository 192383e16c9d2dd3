"""The port's field tensors (zecale_tpu_torch/ff/fp_torch.py) and the CPU
build of its CUDA field core (csrc/field.cuh) against the reference's host
field oracle.  Tolerance: exact (field elements are integers)."""

import random

import numpy as np
import pytest
import torch

from zecale_tpu.ff import host_field as hf
from zecale_tpu.ff import params as P
from zecale_tpu_torch.ff import fp_torch as ft
from zecale_tpu_torch.utils import build

# One intra-op thread: the suite runs in several worker processes at
# once, and torch's OpenMP threads spinning in each of them slow every
# worker many times over (a 13 s test took 695 s with four workers).
torch.set_num_threads(1)

MODULI = {
    "bls12-377-q": P.BLS12_377_Q,
    "bw6-761-q": P.BW6_761_Q,
    "bw6-761-r": P.BW6_761_R,
    "bls12-377-r": P.BLS12_377_R,
}


def _elems(rng, p, n):
    # the bounds (0, 1, p-1, R mod p, the top limb pattern) + random
    R = 1 << (32 * ft.num_limbs(p))
    return [0, 1, p - 1, p // 2, R % p, (R - 1) % p] + [
        rng.randrange(p) for _ in range(n)
    ]


@pytest.mark.parametrize("name", sorted(MODULI))
def test_field_ops_match_host_field(name):
    p = MODULI[name]
    Fh = hf.PrimeField(p)
    F = ft.field(p)
    rng = np.random.default_rng(1234)
    pyrng = random.Random(int(rng.integers(1 << 30)))
    xs = _elems(pyrng, p, 58)
    ys = list(reversed(xs))
    a, b = F.pack_mont(xs), F.pack_mont(ys)
    assert a.dtype == torch.int32 and a.shape == (len(xs), F.n)
    assert F.unpack_mont(a) == xs
    assert F.unpack(F.from_mont(a)) == xs
    assert F.unpack_mont(F.to_mont(F.pack(xs))) == xs
    pairs = list(zip(xs, ys))
    assert F.unpack_mont(F.add(a, b)) == [Fh.add(x, y) for x, y in pairs]
    assert F.unpack_mont(F.sub(a, b)) == [Fh.sub(x, y) for x, y in pairs]
    assert F.unpack_mont(F.neg(a)) == [Fh.neg(x) for x in xs]
    assert F.unpack_mont(F.mul(a, b)) == [Fh.mul(x, y) for x, y in pairs]
    assert F.unpack_mont(F.sqr(a)) == [Fh.sqr(x) for x in xs]
    for k in (3, -3, 12):
        got = F.unpack_mont(F.mul_small(a, k))
        assert got == [Fh.mul_scalar(x, k) for x in xs]
    # canonical limbs: every output stays below p
    assert all(v < p for v in F.unpack(F.mul(a, b)))


@pytest.mark.parametrize("name", ["bls12-377-q", "bw6-761-q"])
def test_batch_inverse_and_mul_chain(name):
    p = MODULI[name]
    Fh = hf.PrimeField(p)
    F = ft.field(p)
    xs = _elems(random.Random(5), p, 37)
    inv = F.unpack_mont(F.batch_inverse(F.pack_mont(xs)))
    assert inv == [Fh.inv(x) if x else 0 for x in xs]
    # a chain of squarings and additions accumulates no drift
    a = F.pack_mont(xs)
    ref = list(xs)
    one = F.one_like(a)
    for _ in range(5):
        a = F.add(F.sqr(a), one)
        ref = [Fh.add(Fh.sqr(x), 1) for x in ref]
    assert F.unpack_mont(a) == ref


@pytest.mark.parametrize("name", ["bls12-377-q", "bw6-761-q", "bw6-761-r"])
def test_cuda_header_cpu_build_matches_plain_mul(name):
    """csrc/field.cuh built by g++ multiplies exactly as the plain torch
    version does, limb for limb."""
    p = MODULI[name]
    F = ft.field(p)
    xs = _elems(random.Random(9), p, 90)
    a = F.pack_mont(xs)
    b = F.pack_mont(list(reversed(xs)))
    out = torch.empty_like(a)
    pl = np.frombuffer(p.to_bytes(4 * F.n, "little"), dtype="<u4").copy()
    one = np.frombuffer(
        F.r_mod_p.to_bytes(4 * F.n, "little"), dtype="<u4"
    ).copy()
    rc = build.host_check_lib().zt_cpu_fp_mul(
        F.n, out.data_ptr(), a.data_ptr(), b.data_ptr(), a.shape[0],
        pl.ctypes.data, one.ctypes.data, F.pinv32,
    )
    assert rc == 0
    assert torch.equal(out, F.mul(a, b))
