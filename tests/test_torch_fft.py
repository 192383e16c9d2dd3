"""The port's QAP division (zecale_tpu_torch/poly/fft_torch.py) against the
reference's jitted pipeline poly/fft_tpu.py:h_pipeline_jit and the host
radix-2 domain, over BW6-761 Fr.  Both sides use R = 2^384, so Montgomery
limbs compare bit for bit.  Tolerance: exact."""

import torch

import numpy as np
import pytest

from zecale_tpu.ff import fp_jax
from zecale_tpu.ff import params as P
from zecale_tpu.poly import domain_host, fft_tpu
from zecale_tpu_torch.ff.fp_torch import field
from zecale_tpu_torch.poly import fft_torch

# One intra-op thread: the suite runs in several worker processes at
# once, and torch's OpenMP threads spinning in each of them slow every
# worker many times over (a 13 s test took 695 s with four workers).
torch.set_num_threads(1)

R_FR = P.BW6_761_R


def _vals(n, seed):
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 1 << 62, size=(n, 7), dtype=np.int64)
    return [int(sum(int(w) << (62 * i) for i, w in enumerate(row))) % R_FR
            for row in words]


@pytest.mark.parametrize("n", [16, 1024])
def test_h_pipeline_matches_jax(n):
    F = field(R_FR)
    Fj = fp_jax.field(R_FR)
    az, bz, cz = (_vals(n, n + k) for k in range(3))
    want = Fj.unpack(fft_tpu.h_pipeline_jit(n, R_FR)(
        *(Fj.pack(v) for v in (az, bz, cz))))
    got = fft_torch.h_pipeline(*(F.pack_mont(v) for v in (az, bz, cz)),
                               R_FR)
    assert F.unpack_mont(got) == want


@pytest.mark.parametrize("n", [16, 128])
def test_fft_and_cosets_match_host_domain(n):
    F = field(R_FR)
    d = domain_host.domain(n, R_FR)
    vals = _vals(n, 99)
    x = F.pack_mont(vals)
    assert F.unpack_mont(fft_torch.fft(x, R_FR)) == d.fft(vals)
    assert F.unpack_mont(fft_torch.fft(x, R_FR, inverse=True)) == d.ifft(
        vals)
    assert F.unpack_mont(fft_torch.coset_fft(x, R_FR)) == d.coset_fft(vals)
    assert F.unpack_mont(fft_torch.coset_ifft(x, R_FR)) == d.coset_ifft(
        vals)


def test_extended_domain_refused():
    with pytest.raises(ValueError):
        fft_torch.h_pipeline(*([field(P.MNT6_298_R).pack_mont([0])
                                .expand(1 << 18, -1)] * 3), P.MNT6_298_R)
