"""The port's distributed FFT (zecale_tpu_torch/parallel/fft_dist.py) on a
CPU mesh against the JAX package's parallel/fft_dist.py on the conftest's
virtual 8-device JAX mesh (n = 16, BLS12-377 Fr and BW6-761 Fr), and
against the host radix-2 domain for D = 1, 2, 4 and 8 shards.  Values are
field elements, compared as integers.  Tolerance: exact."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zecale_tpu.ff import fp_jax
from zecale_tpu.ff import limb as lb
from zecale_tpu.ff import params as P
from zecale_tpu.parallel import fft_dist as fd_ref
from zecale_tpu.parallel import sharded as sh_ref
from zecale_tpu_torch.ff.fp_torch import field
from zecale_tpu_torch.parallel import fft_dist
from zecale_tpu_torch.parallel.mesh import make_mesh
from zecale_tpu_torch.poly import domain_host, fft_torch

# One intra-op thread: the suite runs in several worker processes at
# once, and torch's OpenMP threads spinning in each of them slow every
# worker many times over.
torch.set_num_threads(1)

FIELDS = {"bls12-377": P.CURVES["bls12-377"].r,
          "bw6-761": P.CURVES["bw6-761"].r}


def _vals(r, n, seed):
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 1 << 62, size=(n, 7), dtype=np.int64)
    return [int(sum(int(w) << (62 * i) for i, w in enumerate(row))) % r
            for row in words]


def _cpu_mesh(D):
    return make_mesh(D, devices=["cpu"] * D)


@pytest.fixture(scope="module")
def jax_mesh():
    assert len(jax.devices()) >= 8, "conftest must provide 8 CPU devices"
    return sh_ref.make_mesh(8)


def test_bitrev_permutation_matches_reference():
    for k in range(11):
        n = 1 << k
        got = fft_dist.bitrev_permutation(n)
        assert got.dtype == np.int32
        assert np.array_equal(got, fd_ref.bitrev_permutation(n)), n


@pytest.mark.parametrize("curve", sorted(FIELDS))
@pytest.mark.parametrize("fn", ["ifft_sharded", "fft_sharded"])
def test_transform_matches_jax(jax_mesh, curve, fn):
    r, n = FIELDS[curve], 16
    vals = _vals(r, n, 3)
    Fj = fp_jax.field(r)
    want = Fj.unpack(getattr(fd_ref, fn)(jax_mesh, Fj.pack(vals), r))
    F = field(r)
    mesh = _cpu_mesh(8)
    got = getattr(fft_dist, fn)(mesh, F.pack_mont(vals), r)
    assert len(got) == 8 and all(g.shape == (2, F.n) for g in got)
    assert F.unpack_mont(mesh.gather(got)) == want


@pytest.mark.parametrize("curve", sorted(FIELDS))
def test_h_pipeline_sharded_matches_jax(jax_mesh, curve):
    r, n = FIELDS[curve], 16
    az, bz, cz = (_vals(r, n, 10 + k) for k in range(3))
    Fj = fp_jax.field(r)
    zi = domain_host.domain(n, r).vanishing_on_coset_inverse()
    zinv_j = jnp.asarray(lb.to_limbs(
        zi * lb.mont_params(r).r_mod_p % r, Fj.L).astype(np.int32))
    want = Fj.unpack(fd_ref.h_pipeline_sharded(
        jax_mesh, r, *(Fj.pack(v) for v in (az, bz, cz)), zinv_j))
    F = field(r)
    mesh = _cpu_mesh(8)
    got = fft_dist.h_pipeline_sharded(
        mesh, r, *(F.pack_mont(v) for v in (az, bz, cz)),
        F.pack_mont([zi])[0])
    assert F.unpack_mont(mesh.gather(got)) == want


@pytest.mark.parametrize("D", [1, 2, 4, 8])
def test_shard_counts_against_the_host_domain(D):
    r, n = FIELDS["bw6-761"], 64
    F = field(r)
    d = domain_host.domain(n, r)
    rev = fft_dist.bitrev_permutation(n)
    mesh = _cpu_mesh(D)
    vals = _vals(r, n, D)
    coeffs = fft_dist.ifft_sharded(mesh, F.pack_mont(vals), r)
    assert len(coeffs) == D
    want = d.ifft(vals)
    assert F.unpack_mont(mesh.gather(coeffs)) == [want[i] for i in rev]
    back = fft_dist.fft_sharded(mesh, coeffs, r)
    assert F.unpack_mont(mesh.gather(back)) == vals
    # the QAP division, bit-reversed, against the host pipeline
    az, bz, cz = (_vals(r, n, 20 + D + k) for k in range(3))
    zi = d.vanishing_on_coset_inverse()
    a_e, b_e, c_e = (d.coset_fft(d.ifft(v)) for v in (az, bz, cz))
    h = d.coset_ifft([(a * b - c) * zi % r for a, b, c in zip(a_e, b_e,
                                                               c_e)])
    got = fft_dist.h_pipeline_sharded(
        mesh, r, *(F.pack_mont(v) for v in (az, bz, cz)))
    assert F.unpack_mont(mesh.gather(got)) == [h[i] for i in rev]
    # and the single-device pipeline, bit for bit
    single = fft_torch.h_pipeline(*(F.pack_mont(v) for v in (az, bz, cz)), r)
    assert torch.equal(mesh.gather(got), single[torch.from_numpy(
        rev.astype(np.int64))])


def test_plans_hold_only_the_shards_slice():
    r, n, D = FIELDS["bls12-377"], 64, 4
    F = field(r)
    lt, ct, sinv = fft_dist._plan_np(n, D, r, False)
    assert [len(t) for t in lt] == [1, 2, 4, 8]
    assert [len(t) for t in ct] == [16, 32]
    for g in range(D):
        local, cross, s = fft_dist.plan_arrays(n, D, r, False, g, "cpu")
        assert [c.shape[0] for c in cross] == [n // D] * 2
        assert F.unpack_mont(s.unsqueeze(0)) == [pow(n, r - 2, r)]
    with pytest.raises(ValueError):
        fft_dist._plan_np(48, 4, r, False)
