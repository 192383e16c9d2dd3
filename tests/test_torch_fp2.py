"""The port's Fq2 tensors (zecale_tpu_torch/ff/fp2_torch.py) against the
reference's host Fq2 (zecale_tpu/ff/host_field.py) and its JAX Fq2
(ff/fp2_jax.py:Fp2TPU), and the CPU build of the device Fq2 core
(csrc/field2.cuh) against the plain version.  BLS12-377: Fq2 =
Fq[u]/(u^2 + 5), Montgomery R = 2^384 on both sides, so limbs compare bit
for bit.  Tolerance: exact (field elements are integers)."""

import random

import numpy as np
import torch

from zecale_tpu.ff import fp2_jax
from zecale_tpu.ff import host_field as hf
from zecale_tpu.ff import limb as lb
from zecale_tpu.ff import params as P
from zecale_tpu_torch.ec import curve_torch as ct
from zecale_tpu_torch.ff.fp2_torch import bls12_377_fq2
from zecale_tpu_torch.utils import build

# One intra-op thread: the suite runs in several worker processes at
# once, and torch's OpenMP threads spinning in each of them slow every
# worker many times over (a 13 s test took 695 s with four workers).
torch.set_num_threads(1)

Q = P.BLS12_377_Q


def _elems(seed, n):
    """Bounds (0, 1, q-1 in each coefficient) and random elements."""
    rng = random.Random(seed)
    edge = [0, 1, Q - 1, Q // 2, (1 << 384) % Q]
    out = [(a, b) for a in edge for b in edge[:3]]
    return out + [(rng.randrange(Q), rng.randrange(Q)) for _ in range(n)]


def test_fp2_ops_match_host_fq2():
    H = hf.towers("bls12-377")["fq2"]
    F = bls12_377_fq2()
    assert F.nr == -5 and H.nr == P.BLS12_377_FQ2_QNR
    xs = _elems(1, 25)
    ys = list(reversed(xs))
    a, b = F.pack_mont(xs), F.pack_mont(ys)
    assert a.dtype == torch.int32 and a.shape == (len(xs), 2, 12)
    assert F.unpack_mont(a) == xs
    assert F.unpack(F.pack(xs)) == xs
    pairs = list(zip(xs, ys))
    assert F.unpack_mont(F.add(a, b)) == [H.add(x, y) for x, y in pairs]
    assert F.unpack_mont(F.sub(a, b)) == [H.sub(x, y) for x, y in pairs]
    assert F.unpack_mont(F.neg(a)) == [H.neg(x) for x in xs]
    assert F.unpack_mont(F.dbl(a)) == [H.add(x, x) for x in xs]
    assert F.unpack_mont(F.mul(a, b)) == [H.mul(x, y) for x, y in pairs]
    assert F.unpack_mont(F.sqr(a)) == [H.sqr(x) for x in xs]
    # the non-residue multiply of a base element: nr * c0
    nr = F.base.unpack_mont(F.mul_nr(a[:, 0]))
    assert nr == [H.base.mul(x[0], H.nr) for x in xs]
    # u * u = nr, and (1, 0) is the identity of the product
    u = F.pack_mont([(0, 1)])
    assert F.unpack_mont(F.mul(u, u)) == [(Q - 5, 0)]
    one = F.one_like(a)
    assert F.unpack_mont(one[:1]) == [H.one()]
    assert torch.equal(F.mul(a, one), a)
    # canonical limbs: every coefficient stays below q
    assert all(v < Q for v in F.base.unpack(F.mul(a, b)))


def test_fp2_matches_jax_fp2():
    """The same 16 products, sums and differences as the JAX Fq2 core,
    limb for limb (both Montgomery with R = 2^384)."""
    J = fp2_jax.bls12_377_fq2()
    F = bls12_377_fq2()
    rng = np.random.default_rng(7)
    ints = [int.from_bytes(rng.bytes(48), "little") % Q for _ in range(64)]
    xs = [(ints[i], ints[i + 1]) for i in range(0, 32, 2)]
    ys = [(ints[i], ints[i + 1]) for i in range(32, 64, 2)]
    ja, jb = J.pack(xs), J.pack(ys)
    ta, tb = F.pack_mont(xs), F.pack_mont(ys)

    def raw_jax(arr):
        flat = np.asarray(arr).reshape(-1, J.L)
        return lb.batch_from_limbs(flat)

    assert raw_jax(ja) == F.base.unpack(ta)
    for jop, top in ((J.mont_mul, F.mul), (J.add, F.add), (J.sub, F.sub)):
        assert raw_jax(jop(ja, jb)) == F.base.unpack(top(ta, tb))
    assert raw_jax(J.neg(ja)) == F.base.unpack(F.neg(ta))


def test_field2_cuh_cpu_build_matches_plain_mul():
    """csrc/field2.cuh built by g++ multiplies exactly as the plain torch
    version does, limb for limb."""
    F = bls12_377_fq2()
    xs = _elems(9, 40)
    a = F.pack_mont(xs)
    b = F.pack_mont(list(reversed(xs)))
    out = torch.empty_like(a)
    p, one, pinv, _ = ct.kernel_consts(F, ct.b3_of("bls12-377", True))
    rc = build.host_check_lib().zt_cpu_fp_mul(
        2, out.data_ptr(), a.data_ptr(), b.data_ptr(), a.shape[0],
        p.ctypes.data, one.ctypes.data, pinv,
    )
    assert rc == 0
    assert torch.equal(out, F.mul(a, b))
