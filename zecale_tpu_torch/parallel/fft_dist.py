"""Distributed radix-2 FFT with explicit cross-shard butterfly exchanges.

Ports ``parallel/fft_dist.py`` (the hypercube FFT) onto ``parallel/mesh.py``:

  * the element axis is sharded over the mesh; the butterfly stages whose
    span lies inside a shard run as local reshape-butterflies
    (``_local_butterfly_dit`` 118, ``_local_butterfly_dif`` 135);
  * the log2(D) stages whose span crosses shards exchange each shard with
    its XOR partner (``mesh.exchange``, the reference's ``ppermute``) and
    combine locally (``_cross_stage`` 151);
  * no bit reversal at run time: the inverse transform is decimation in
    frequency (natural input -> bit-reversed output), the forward one
    decimation in time (bit-reversed input -> natural output), so the QAP
    pipeline's intermediate products live in bit-reversed order and every
    index-dependent constant (coset scales, the H query's point order) is
    permuted once on the host.

The field arithmetic is ``ff/fp_torch.py``'s Montgomery, as in
``poly/fft_torch.py``.  A shard is an (..., S, L) tensor of Montgomery
limbs (S = n / D); leading axes ride along as a batch, which is how the
QAP pipeline's three coset evaluations run as one body (294-305).  The
reference's per-shard bodies see one shard; here they take the list of
this process's shards, since an exchange is a collective over all of them.

The plans (``_plan_np`` 50) are built from running products, not one
``pow`` per position, and cached per (n, D, r) on the host and per
(shard, device) on the device: each shard holds the local twiddles (one
stage's ``half`` values, broadcast over its blocks where the reference
tiles them) and only its own slice of each cross table.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..ff.fp_torch import field
from ..poly import domain_host


def bitrev_permutation(n: int) -> np.ndarray:
    """rev[i] = i with its log2(n) bits reversed (int32)."""
    bits = n.bit_length() - 1
    i = np.arange(n, dtype=np.int64)
    rev = np.zeros(n, dtype=np.int64)
    for b in range(bits):
        rev |= ((i >> b) & 1) << (bits - 1 - b)
    return rev.astype(np.int32)


def _powers(w: int, k: int, r: int) -> list:
    out, cur = [], 1
    for _ in range(k):
        out.append(cur)
        cur = cur * w % r
    return out


@functools.lru_cache(maxsize=None)
def _plan_np(n: int, D: int, r: int, inverse: bool):
    """Host plan of an n-point transform over D shards, as ints:
    (local_tw, cross_tw, sinv).  local_tw[s]: the 2^s twiddles w^j of
    local stage half = 2^s; cross_tw[k]: the ``half`` powers w^j of the
    cross stage with half = S 2^k, from which each shard cuts its slice
    (position i takes w^(i mod half), on the u side as on the v side);
    sinv: 1/n."""
    if n % D or D & (D - 1) or n & (n - 1):
        raise ValueError(f"fft_dist: n = {n} over D = {D} shards (powers "
                         "of two, D dividing n)")
    S = n // D
    d = domain_host.domain(n, r)
    if getattr(d, "C", 1) != 1 or d.size != n:
        raise ValueError(f"fft_dist: size {n} needs an extended domain")
    omega = d.omega_inv if inverse else d.omega
    stages = []
    for s in range(n.bit_length() - 1):
        half = 1 << s
        stages.append(_powers(pow(omega, n // (2 * half), r), half, r))
    local_bits = S.bit_length() - 1
    return stages[:local_bits], stages[local_bits:], pow(n, r - 2, r)


@functools.lru_cache(maxsize=None)
def plan_arrays(n: int, D: int, r: int, inverse: bool, shard: int,
                device: str):
    """Shard ``shard``'s plan on ``device``, Montgomery limbs: the local
    twiddles [(2^s, L)], its slices of the cross tables [(S, L)] and 1/n
    (L,)."""
    F = field(r)
    lt, ct, sinv = _plan_np(n, D, r, inverse)
    S = n // D
    cross = []
    for k, pw in enumerate(ct):
        half = S << k
        lo = (shard * S) % half
        cross.append(F.pack_mont(pw[lo: lo + S], device))
    return ([F.pack_mont(t, device) for t in lt], cross,
            F.pack_mont([sinv], device)[0])


def _plans(mesh, n: int, r: int, inverse: bool) -> list:
    return [plan_arrays(n, mesh.size, r, inverse, g, str(d))
            for g, d in zip(mesh.shard_ids(), mesh.devices)]


# ---------------------------------------------------------------------------
# per-shard stage bodies
# ---------------------------------------------------------------------------


def _halves(x: torch.Tensor, half: int):
    """(..., S, L) -> the u and v halves (..., S / 2h, h, L) of its blocks
    of 2h."""
    S, L = x.shape[-2:]
    blocks = x.reshape(*x.shape[:-2], S // (2 * half), 2 * half, L)
    return blocks[..., :half, :], blocks[..., half:, :]


def _local_butterfly_dit(F, x, tw, half: int):
    """u' = u + w v, v' = u - w v inside each block of 2 half."""
    u, v = _halves(x, half)
    tv = F.mul(v, tw)
    return torch.cat([F.add(u, tv), F.sub(u, tv)], dim=-2).reshape(x.shape)


def _local_butterfly_dif(F, x, tw, half: int):
    """u' = u + v, v' = (u - v) w inside each block of 2 half."""
    u, v = _halves(x, half)
    return torch.cat([F.add(u, v), F.mul(F.sub(u, v), tw)],
                     dim=-2).reshape(x.shape)


def _cross_stage(F, mesh, xs: list, tws: list, dist: int, dit: bool) -> list:
    """One cross-shard stage: every shard takes its XOR partner at
    ``dist`` shards (half // S); whole shards are u side ((g & dist) ==
    0) or v side.  DIT: u' = u + w v, v' = u - w v; DIF: u' = u + v,
    v' = (u - v) w, each shard computing only its own side."""
    out = []
    for g, x, p, tw in zip(mesh.shard_ids(), xs, mesh.exchange(xs, dist),
                           tws):
        u_side = (g & dist) == 0
        if dit:
            out.append(F.add(x, F.mul(p, tw)) if u_side
                       else F.sub(p, F.mul(x, tw)))
        else:
            out.append(F.add(x, p) if u_side else F.mul(F.sub(p, x), tw))
    return out


def ifft_dif_local(F, mesh, xs: list, plans: list) -> list:
    """Inverse FFT, natural input -> bit-reversed output, over this
    process's shards.  Stages run from the largest span (cross-shard)
    down to 1."""
    n_cross = len(plans[0][1])
    for k in range(n_cross - 1, -1, -1):
        xs = _cross_stage(F, mesh, xs, [p[1][k] for p in plans], 1 << k,
                          dit=False)
    for s in range(len(plans[0][0]) - 1, -1, -1):
        xs = [_local_butterfly_dif(F, x, p[0][s], 1 << s)
              for x, p in zip(xs, plans)]
    return [F.mul(x, p[2]) for x, p in zip(xs, plans)]


def fft_dit_local(F, mesh, xs: list, plans: list) -> list:
    """Forward FFT, bit-reversed input -> natural output, over this
    process's shards."""
    for s in range(len(plans[0][0])):
        xs = [_local_butterfly_dit(F, x, p[0][s], 1 << s)
              for x, p in zip(xs, plans)]
    for k in range(len(plans[0][1])):
        xs = _cross_stage(F, mesh, xs, [p[1][k] for p in plans], 1 << k,
                          dit=True)
    return xs


# ---------------------------------------------------------------------------
# public sharded entry points
# ---------------------------------------------------------------------------


def _size(mesh, xs: list) -> int:
    return xs[0].shape[-2] * mesh.size


def ifft_sharded(mesh, values, r: int) -> list:
    """(n, L) Montgomery values in natural order (a global tensor, or this
    process's shards) -> the coefficients in bit-reversed order, as this
    process's shards.  ``fft_sharded`` takes them back."""
    xs = mesh.shard(values)
    return ifft_dif_local(field(r), mesh, xs, _plans(mesh, _size(mesh, xs),
                                                     r, True))


def fft_sharded(mesh, coeffs_bitrev, r: int) -> list:
    """Coefficients in bit-reversed order -> evaluations in natural order,
    as this process's shards."""
    xs = mesh.shard(coeffs_bitrev)
    return fft_dit_local(field(r), mesh, xs, _plans(mesh, _size(mesh, xs),
                                                    r, False))


@functools.lru_cache(maxsize=None)
def _coset_scales_np(n: int, r: int):
    """(fwd, inv) coset scales g^i and g^-i as ints in bit-reversed order."""
    g = domain_host.domain(n, r).coset_shift
    rev = bitrev_permutation(n)
    fwd = _powers(g, n, r)
    inv = _powers(pow(g, r - 2, r), n, r)
    return [fwd[i] for i in rev], [inv[i] for i in rev]


@functools.lru_cache(maxsize=None)
def _coset_scales_rev(n: int, r: int, D: int, shard: int, device: str):
    """Shard ``shard``'s slices of the bit-reversed coset scales
    (Montgomery, (S, L) each) on ``device``."""
    F = field(r)
    S = n // D
    fwd, inv = _coset_scales_np(n, r)
    lo = shard * S
    return (F.pack_mont(fwd[lo: lo + S], device),
            F.pack_mont(inv[lo: lo + S], device))


def h_pipeline_sharded(mesh, r: int, az, bz, cz, zinv_mont=None) -> list:
    """Distributed QAP division: Az, Bz, Cz (Montgomery evaluations,
    natural order; global tensors or this process's shards) -> the
    coefficients of H = (A B - C) / Z in bit-reversed order, as this
    process's shards.  The caller takes H against a bit-reverse-permuted
    H query.  The three coset evaluations run as one batched body.
    ``zinv_mont``: 1 / Z on the coset, (L,) Montgomery (None: from the
    domain)."""
    F = field(r)
    abc = [torch.stack(t) for t in zip(*(mesh.shard(v)
                                         for v in (az, bz, cz)))]
    n = _size(mesh, abc)
    if zinv_mont is None:
        zinv_mont = F.pack_mont(
            [domain_host.domain(n, r).vanishing_on_coset_inverse()])[0]
    ip, fp = _plans(mesh, n, r, True), _plans(mesh, n, r, False)
    scales = [_coset_scales_rev(n, r, mesh.size, g, str(d))
              for g, d in zip(mesh.shard_ids(), mesh.devices)]
    coeffs = ifft_dif_local(F, mesh, abc, ip)  # bit-reversed
    evals = fft_dit_local(F, mesh, [F.mul(x, s[0])
                                    for x, s in zip(coeffs, scales)], fp)
    h_e = [F.mul(F.sub(F.mul(e[0], e[1]), e[2]), zinv_mont.to(e.device))
           for e in evals]
    h_c = ifft_dif_local(F, mesh, h_e, ip)  # bit-reversed
    return [F.mul(h, s[1]) for h, s in zip(h_c, scales)]
