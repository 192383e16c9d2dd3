"""Radix-2 FFT and the QAP division over a scalar field, in plain PyTorch.

Ports ``poly/fft_tpu.py`` (``fft`` 85, ``coset_fft`` 138, ``coset_ifft``
147, ``h_pipeline_jit`` 164, ``qap_polys_pipeline_jit`` 208).  The
reference is plain XLA there, not Pallas, so here it is plain torch ops
on the device: an iterative
butterfly network over Montgomery limb tensors (``ff/fp_torch.py``), one
vectorised butterfly of n/2 products per stage, twiddles and coset scales
computed on the host once per (size, field, device).

Strictly radix-2: BLS12-377 and BW6-761 scalar fields have 2-adicity 46
and 47, and extended (coset-union) domains are refused (KNOWN_GAPS #9).
"""

from __future__ import annotations

import functools

import torch

from ..ff.fp_torch import field
from . import domain_host


def _radix2(n: int, r: int):
    d = domain_host.domain(n, r)
    if getattr(d, "C", 1) != 1 or d.size != n:
        raise ValueError(
            f"FFT of size {n} needs an extended domain; the port is "
            "radix-2 only"
        )
    return d


@functools.lru_cache(maxsize=None)
def _plan(n: int, r: int, inverse: bool, device: str):
    """Bit-reversal permutation, per-stage twiddles (Montgomery) and, for
    the inverse, n^-1 (Montgomery), on ``device``."""
    d = _radix2(n, r)
    F = field(r)
    omega = d.omega_inv if inverse else d.omega
    bits = n.bit_length() - 1
    rev = torch.tensor(
        [int(format(i, f"0{bits}b")[::-1], 2) if bits else 0
         for i in range(n)],
        device=device,
    )
    tws = []
    for s in range(bits):
        half = 1 << s
        w = pow(omega, n // (2 * half), r)
        vals, cur = [], 1
        for _ in range(half):
            vals.append(cur)
            cur = cur * w % r
        tws.append(F.pack_mont(vals, device))
    sinv = F.pack_mont([pow(n, r - 2, r)], device)[0]
    return rev, tws, sinv


@functools.lru_cache(maxsize=None)
def _coset_scale(n: int, r: int, inverse: bool, device: str):
    d = _radix2(n, r)
    g = d.coset_shift
    if inverse:
        g = pow(g, r - 2, r)
    vals, cur = [], 1
    for _ in range(n):
        vals.append(cur)
        cur = cur * g % r
    return field(r).pack_mont(vals, device)


def fft(values: torch.Tensor, r: int, inverse: bool = False) -> torch.Tensor:
    """In-domain FFT (or inverse) of (n, L) Montgomery values."""
    F = field(r)
    n = values.shape[0]
    rev, tws, sinv = _plan(n, r, inverse, str(values.device))
    a = values[rev]
    for s, tw in enumerate(tws):
        half = 1 << s
        blocks = a.reshape(n // (2 * half), 2 * half, F.n)
        u = blocks[:, :half]
        tv = F.mul(blocks[:, half:], tw.unsqueeze(0))
        a = torch.cat([F.add(u, tv), F.sub(u, tv)], dim=1).reshape(n, F.n)
    if inverse:
        a = F.mul(a, sinv)
    return a


def coset_fft(coeffs: torch.Tensor, r: int) -> torch.Tensor:
    F = field(r)
    scale = _coset_scale(coeffs.shape[0], r, False, str(coeffs.device))
    return fft(F.mul(coeffs, scale), r)


def coset_ifft(evals: torch.Tensor, r: int) -> torch.Tensor:
    F = field(r)
    scale = _coset_scale(evals.shape[0], r, True, str(evals.device))
    return F.mul(fft(evals, r, inverse=True), scale)


def qap_polys_pipeline(az: torch.Tensor, bz: torch.Tensor, cz: torch.Tensor,
                       r: int) -> tuple:
    """QAP division: (Az, Bz, Cz) evaluations on the domain ->
    (H, A, B), the coefficients of H = (A*B - C) / Z and of A and B (the
    first inverse FFTs, which the PGHR13 prover's zero-knowledge shift
    needs), all (n, L) Montgomery."""
    F = field(r)
    n = az.shape[0]
    d = _radix2(n, r)
    zinv = F.pack_mont([d.vanishing_on_coset_inverse()], az.device)[0]
    a_c, b_c, c_c = (fft(v, r, inverse=True) for v in (az, bz, cz))
    a_e, b_e, c_e = (coset_fft(v, r) for v in (a_c, b_c, c_c))
    h_e = F.mul(F.sub(F.mul(a_e, b_e), c_e), zinv)
    return coset_ifft(h_e, r), a_c, b_c


def h_pipeline(az: torch.Tensor, bz: torch.Tensor, cz: torch.Tensor,
               r: int) -> torch.Tensor:
    """QAP division: (Az, Bz, Cz) evaluations on the domain ->
    coefficients of H = (A*B - C) / Z, all (n, L) Montgomery."""
    return qap_polys_pipeline(az, bz, cz, r)[0]
