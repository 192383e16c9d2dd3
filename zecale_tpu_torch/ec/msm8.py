"""The msm8 engine: sort, log-depth pairwise combining, weighted scans.

Ports ``ec/msm8.py:msm8_core`` (472-600) and ``msm8_jit`` (625) -- the
``ZECALE_USE_MSM8`` route of the reference prover -- with every group
operation on the kernels of ``ec/proj_curve.py``: K2 ``proj_add`` and K3
``proj_dbl_chain`` (``csrc/fast_kernels.cu``).  The steps, as in the reference:

  1. balanced signed c-bit digits (``msm.signed_digits``, the port of
     ``signed_digits_from_limbs8``);
  2. one ``torch.sort`` of composite keys window * (K + 2) + bucket over
     all W windows at once, zero digits and points at infinity keyed last
     (``_build_sorted_affine`` 435); y is negated at the source width n and
     picked after the gather;
  3. pairwise same-bucket combining: every round adds each even-rank entry
     of a bucket run to its odd-rank neighbour in one K2 launch and
     compacts the survivors (``_pair_flags`` 338, ``_compact_indices`` 327,
     ``_combine_round`` 398); the unrolled rounds shrink to the widths of
     ``_round_schedule`` (299), then the tail repeats at the last width
     until every bucket holds one entry -- one ``torch.any`` per round, read
     on the host, where the reference ran a ``lax.while_loop``;
  4. dense bucket extraction with ``torch.searchsorted``;
  5. the weighted sum sum_b b B_b of every window by two scans, host loops
     of one stacked K2 launch per step (530-585), then G = 64 times the
     scan total by one K3 chain of log2 G;
  6. the Horner fold over windows: a K3 chain of c, then a K2 add, per
     window (587-597), and one host conversion of the result to affine.

Window chunking (``msm8_jit``'s ``w_range`` 625, ``msm8_streamed_jit``
679, ``msm8_chunked_host`` 741): the sorted working set holds one row per
(window, point), so a range of w of the W windows bounds the peak by w n
rows instead of W n.  ``msm8_window_range`` makes one range's partial,
``msm8_streamed`` folds the partials of ``chunks`` ranges on the device and
``msm8_chunked_host`` on the host; ``msm8(chunks=k)`` takes the streamed
route, which ``Groth16Torch.prove`` picks by the reference's rule
(``snark/groth16_torch.py:msm8_chunks``).
"""

from __future__ import annotations

import torch

from ..ff import params as P
from . import host_curve as hc
from . import msm
from .proj_curve import ProjCurve

#: key of an entry that takes part in no bucket (zero digit, infinity)
SENT = 0x7FFFFFFF


def default_window(n: int) -> int:
    """Window bits by point count (msm8.default_window): balances the W n
    accumulation adds against the ~W 2^(c-1) tail and weighted scans.
    Below 2^6 points 4 bits, as ``msm.default_window``: there the cost is
    the weighted scans over 2^(c-1) buckets, not the W n entries."""
    if n <= 1 << 6:
        return 4
    if n <= 1 << 10:
        return 7
    if n <= 1 << 13:
        return 9
    if n <= 1 << 16:
        return 11
    if n <= 1 << 19:
        return 13
    return 15


def _round_schedule(n: int, K: int, max_unroll: int = 6) -> list:
    """Widths of the unrolled combining rounds: after round t every bucket
    holds <= ceil(n / 2^t) entries and the compacted array <= ceil(n / 2^t)
    + K live ones; stop when a round would no longer shrink it."""
    sizes = []
    t = 0
    while t < max_unroll:
        nxt = -(-n // (1 << (t + 1))) + K + 1
        if nxt >= (sizes[-1] if sizes else n):
            break
        sizes.append(nxt)
        t += 1
    return sizes


def _pair_flags(keys: torch.Tensor):
    """(can_pair, keep) over sorted keys: rank in the bucket run from a
    cummax over run starts; even ranks survive, and pair with the next
    entry when it is in the same run."""
    s = keys.shape[0]
    iota = torch.arange(s, device=keys.device)
    prev = torch.cat([keys.new_tensor([-9]), keys[:-1]])
    first = torch.cummax(torch.where(keys != prev, iota, 0), 0).values
    even = ((iota - first) & 1) == 0
    nxt = torch.cat([keys[1:], keys.new_tensor([-7])])
    live = keys != SENT
    return even & (nxt == keys) & live, even & live


def _compact_indices(keep: torch.Tensor, out_size: int):
    """Indices of the first ``out_size`` kept entries, and their validity."""
    csum = torch.cumsum(keep, 0)
    j = torch.arange(1, out_size + 1, device=keep.device)
    g = torch.searchsorted(csum, j, side="left")
    return g.clamp(max=keep.shape[0] - 1), j <= csum[-1]


def _combine_round(crv: ProjCurve, keys, pts, out_size: int):
    """One pairwise same-bucket round: out_size entries, the sum of each
    even-rank entry and its pair (identity where there is none)."""
    can_pair, keep = _pair_flags(keys)
    g, valid = _compact_indices(keep, out_size)
    new_keys = torch.where(valid, keys[g], SENT)
    p1 = crv.mask(pts[g], valid)
    p2 = crv.mask(pts[(g + 1).clamp(max=keys.shape[0] - 1)],
                  can_pair[g] & valid)
    return new_keys, crv.add(p1, p2)


def _build_sorted(crv: ProjCurve, buckets, signs, xy, inf, c: int):
    """Digits -> (sorted composite keys (W n,), matching signed projective
    points): key = window * (K + 2) + bucket, SENT for zero digits and
    points at infinity (identity points)."""
    W, n = buckets.shape
    stride = (1 << (c - 1)) + 2
    wids = torch.arange(W, device=xy.device).unsqueeze(1)
    key = torch.where(inf.unsqueeze(0) | (buckets == 0), SENT,
                      wids * stride + buckets)
    keys, order = torch.sort(key.reshape(-1))
    src = order % n
    neg = (signs.reshape(-1)[order] > 0) & (keys != SENT)
    # negate y at the source width n, gather (x, y, -y) rows once, pick
    xyn = torch.cat([xy, crv.F.neg(xy[:, 1:2])], dim=1)[src]
    neg = neg.view(-1, *[1] * len(crv.F.shape))
    y = torch.where(neg, xyn[:, 2], xyn[:, 1])
    aff = torch.stack([xyn[:, 0], y], dim=1)
    return keys, crv.from_affine(aff, keys == SENT)


def _stacked_add(crv: ProjCurve, parts_a: list, parts_b: list) -> list:
    """The independent adds a_i + b_i of one scan step as one K2 launch."""
    sizes = [a.shape[0] for a in parts_a]
    out = crv.add(torch.cat(parts_a), torch.cat(parts_b))
    return list(torch.split(out, sizes))


def msm8_core(crv: ProjCurve, buckets, signs, xy, inf, c: int):
    """(W, n) bucket indices and signs + affine points -> the MSM as one
    projective point (1, 3, *F.shape) on the device."""
    return fold_windows(
        crv, window_sums(crv, buckets, signs, xy, inf, c).unsqueeze(0), c)


def window_sums(crv: ProjCurve, buckets, signs, xy, inf, c: int):
    """Steps 1-5: the W window sums sum_b b B_b as (W, 3, *F.shape)
    projective points on the device."""
    W, n = buckets.shape
    K = 1 << (c - 1)
    stride = K + 2
    dev = xy.device
    keys, pts = _build_sorted(crv, buckets, signs, xy, inf, c)

    for s_next in _round_schedule(W * n, W * K):
        keys, pts = _combine_round(crv, keys, pts, s_next)
    w_tail = keys.shape[0]
    while bool(((keys[:-1] == keys[1:]) & (keys[:-1] != SENT)).any()):
        keys, pts = _combine_round(crv, keys, pts, w_tail)

    # dense buckets in (M, G, W) layout: bucket b = hi * G + g + 1
    G = min(K, 64)
    M = K // G
    bk = torch.arange(1, K + 1, device=dev).unsqueeze(1)
    ids = (bk + torch.arange(W, device=dev).unsqueeze(0) * stride).reshape(-1)
    pos = torch.searchsorted(keys, ids, side="left")
    posc = pos.clamp(max=keys.shape[0] - 1)
    hit = (pos < keys.shape[0]) & (keys[posc] == ids)
    bpts = crv.mask(pts[posc], hit).reshape(M, G, W, *pts.shape[1:])

    # scan 1, chunks high to low, per (g, w): wacc += run; run += B[hi]
    # -> wacc = sum_hi hi B[hi, g], run = C_g = sum_hi B[hi, g]
    run = wacc = crv.identity_like(bpts[0])
    for hi in range(M - 1, -1, -1):
        wacc, run = _stacked_add(crv, [wacc, run], [run, bpts[hi]])

    # scan 2, in-chunk index high to low, per w:
    # acc2 += run2; run2 += C_g; wtot += wacc_g
    run2 = acc2 = wtot = crv.identity_like(run[0])
    for g in range(G - 1, -1, -1):
        acc2, run2, wtot = _stacked_add(
            crv, [acc2, run2, wtot], [run2, run[g], wacc[g]])
    # window sums: sum_b b B_b = acc2 + run2 + G wtot
    return crv.add(crv.add(acc2, run2),
                   crv.dbl_chain(wtot, G.bit_length() - 1))


def fold_windows(crv: ProjCurve, partials, c: int):
    """Step 6, the Horner over windows, most significant first, of
    (B, W, 3, *F.shape) window sums of B MSMs: a K3 chain of c and a K2
    add of B points a window -> (B, 3, *F.shape)."""
    acc = crv.identity_like(partials[:, 0])
    for w in range(partials.shape[1] - 1, -1, -1):
        acc = crv.add(crv.dbl_chain(acc, c), partials[:, w])
    return acc


def window_range(planes, lo: int, w: int):
    """Windows [lo, lo + w) of (W, n) digit planes, zero windows past W:
    a tail range keeps the width w and its padding adds nothing
    (``msm8_jit``'s pad and slice, 664-675)."""
    W, n = planes.shape
    pad = max(0, lo + w - W)
    if pad:
        planes = torch.cat([planes, planes.new_zeros(pad, n)])
    return planes[lo : lo + w]


def msm8_window_range(crv: ProjCurve, buckets, signs, xy, inf, c: int,
                      lo: int, w: int):
    """sum over windows lo <= j < lo + w of 2^(c (j - lo)) S_j, S_j the
    window sums of (W, n) digits: the partial of one chunk, a projective
    point (1, 3, *F.shape); its sorted rows are w n, not W n."""
    return msm8_core(crv, window_range(buckets, lo, w),
                     window_range(signs, lo, w), xy, inf, c)


def _setup(curve_name: str, g2: bool, scal, xy, inf, c: int):
    """Checks the shapes -> (curve, window bits, (W, n) buckets, signs,
    contiguous points)."""
    n = xy.shape[0]
    if scal.shape[0] != n or inf.shape[0] != n:
        raise ValueError("msm8: scalars, points and mask differ in length")
    c = c or default_window(n)
    buckets, signs = msm.signed_digits(
        scal, P.CURVES[curve_name].r.bit_length(), c)
    return ProjCurve(curve_name, g2), c, buckets, signs, xy.contiguous()


def chunk_width(W: int, chunks: int) -> int:
    """Windows a chunk: per = ceil(W / chunks); the planes are padded to
    chunks * per windows, and chunks wholly in the padding add nothing."""
    if chunks < 1:
        raise ValueError(f"msm8: {chunks} chunks")
    return -(-W // chunks)


def msm8_streamed(curve_name: str, g2: bool, scal, xy, inf, c: int,
                  chunks: int):
    """``msm8`` in ``chunks`` window ranges (``msm8_streamed_jit`` 679):
    the digits made once, each range's partial made in turn (its sorted
    rows freed before the next range starts), and the partials folded on
    the device, most significant first: acc = 2^(c per) acc + part, one K3
    chain and one K2 add a chunk.  -> host affine point (None for the
    identity)."""
    crv, c, buckets, signs, xy = _setup(curve_name, g2, scal, xy, inf, c)
    per = chunk_width(buckets.shape[0], chunks)
    acc = crv.identity_like(xy[:1])
    for lo in reversed(range(0, buckets.shape[0], per)):
        part = msm8_window_range(crv, buckets, signs, xy, inf, c, lo, per)
        acc = crv.add(crv.dbl_chain(acc, c * per), part)
    return crv.to_affine_host(acc)[0]


def msm8_chunked_host(curve_name: str, g2: bool, scal, xy, inf, c: int,
                      chunks: int):
    """``msm8`` in ``chunks`` window ranges combined on the host
    (``msm8_chunked_host`` 741): each partial to the host, scaled there by
    2^(c lo) and summed.  -> host affine point (None for the identity)."""
    crv, c, buckets, signs, xy = _setup(curve_name, g2, scal, xy, inf, c)
    host = hc.g2_curve(curve_name) if g2 else hc.g1_curve(curve_name)
    per = chunk_width(buckets.shape[0], chunks)
    total = None
    for lo in range(0, buckets.shape[0], per):
        part = crv.to_affine_host(
            msm8_window_range(crv, buckets, signs, xy, inf, c, lo, per))[0]
        if part is not None:
            for _ in range(c * lo):
                part = host.dbl(part)
        total = host.add(total, part)
    return total


def msm8(curve_name: str, g2: bool, scal, xy, inf, c: int = 0,
         chunks: int = 1):
    """sum_i scal[i] * P_i -> host affine point (None for the identity),
    with the arguments of ``msm.msm``: (n, nl) int32 standard-form scalar
    limbs, (n, 2, *F.shape) affine Montgomery points, (n,) infinity mask,
    all on one device.  ``chunks`` > 1 takes ``msm8_streamed``."""
    if chunks > 1:
        return msm8_streamed(curve_name, g2, scal, xy, inf, c, chunks)
    crv, c, buckets, signs, xy = _setup(curve_name, g2, scal, xy, inf, c)
    acc = msm8_core(crv, buckets, signs, xy, inf, c)
    return crv.to_affine_host(acc)[0]
