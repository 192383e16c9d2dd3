"""Pippenger multi-scalar multiplication over a = 0 curves on the card.

Ports the MSM engine of ``ec/msm4.py`` (plan 175, signed digits
``msm8.signed_digits_from_limbs8`` 258, keys and counts 313/331, the bucket
reduce 543/655, ``weighted_horner`` 717, ``finalize_projective`` 816) with a
design for the GPU rather than a translation:

  1. signed c-bit digits from the standard-form 32-bit scalar limbs (plain
     torch on the device);
  2. one ``torch.sort`` of the global bucket ids gives every bucket's run
     of entries (point index << 1 | sign); ``bincount`` gives the counts.
     There is no padded bucket matrix, no capacity, and so none of the
     overflow layers, sub-lane calibration or per-window-group dispatch
     that msm4 needs for the TPU's fixed shapes;
  3. the bucket sums come from the hand-written kernel ``bucket_reduce``
     (``csrc/fast_kernels.cu`` zt_bucket_reduce, on the fast field core):
     runs are cut into segments of at most ``SEG`` entries, TPI threads a
     segment (TPI from ``utils/build.py:SUM_TPI`` by form and the
     launch's entries), and the segment partials of a bucket are summed
     by further launches until one partial is left;
  4. the weighted sum sum_b b*B_b of each window is rewritten as
     sum_k 2^k * (sum of the buckets whose index has bit k set): those
     subset sums are more segment sums for the same kernel (W*c of them,
     about K/2 buckets each), so the card does all the group operations;
  5. the W*c subset sums (a few hundred points) go to the host, which
     normalises them and runs the Horner fold over bit positions c*w + k
     with the host curve's Jacobian law (Python ints), returning an affine
     point.  ``msm_projective`` folds them on the device instead (K3 and
     K2), for the sharded msm4 of ``parallel/sharded.py``.

The kernel's wrapper takes its plain version ``bucket_reduce_ref`` only for
tensors on the CPU; for CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

import collections

import torch

from ..ec import host_curve as hc
from ..ff import params as P
from . import curve_torch as ct
from . import proj_curve as pc

#: most entries one segment of the kernel sums: long runs (bit-heavy
#: witness scalars put ~half the points into bucket 1 of window 0) are
#: split so that no segment serialises the MSM
SEG = 32


def default_window(n: int) -> int:
    """Window bits by point count: msm4.default_window4's table, plus 4
    bits for tiny MSMs, whose cost is the c*W subset sums, not the n*W
    bucket entries."""
    if n <= 1 << 6:
        return 4
    if n <= 1 << 10:
        return 6
    if n <= 1 << 14:
        return 8
    if n <= 1 << 16:
        return 10
    return 11


def num_windows(nbits: int, c: int) -> int:
    """Windows for nbits-bit scalars with one bit of headroom for the carry
    out of the top balanced digit."""
    return -(-(nbits + 1) // c)


# ---------------------------------------------------------------------------
# K1: the bucket reduce
# ---------------------------------------------------------------------------


def bucket_reduce_ref(pts, ent, seg, F, b3, affine: bool):
    """Plain version of the kernel: segment s sums the points named by
    ent[seg[s]:seg[s+1]] (entry = index << 1 | negate) from (0:1:0), one
    entry per step across all segments still running."""
    nseg = seg.numel() - 1
    acc = ct.identity(F, (nseg,), pts.device)
    if nseg <= 0:
        return acc
    lo = seg[:-1].long()
    lens = seg[1:].long() - lo
    for j in range(int(lens.max())):
        rows = (lens > j).nonzero().squeeze(-1)
        e = ent[lo[rows] + j].long()
        q = pts[e >> 1]
        neg = (e & 1).bool().view(-1, *[1] * len(F.shape))
        y = torch.where(neg, F.neg(q[:, 1]), q[:, 1])
        q = torch.cat([q[:, :1], y.unsqueeze(1), q[:, 2:]], dim=1)
        a = acc[rows]
        acc[rows] = (
            ct.proj_add_mixed(F, a, q, b3) if affine
            else ct.proj_add(F, a, q, b3)
        )
    return acc


def bucket_reduce(pts, ent, seg, F, b3, affine: bool):
    """Segment sums of points: (nseg, 3, *F.shape) int32 projective
    partials.

    ``pts``: (k, 2, *F.shape) affine or (k, 3, *F.shape) projective int32
    Montgomery rows over Fq or Fq2; ``ent``: int32 entries (point index <<
    1 | negate); ``seg``: (nseg + 1,) int32 offsets into ``ent``.  CPU
    tensors take the plain version; CUDA tensors launch
    ``csrc/fast_kernels.cu`` zt_bucket_reduce in the field's form."""
    return bucket_reduce_tpi(pts, ent, seg, F, b3, affine, None)


def bucket_reduce_tpi(pts, ent, seg, F, b3, affine: bool, tpi):
    """``bucket_reduce`` with K1's threads per segment set to ``tpi``
    (None: the SUM_TPI table's pick for the launch's entries)."""
    if pts.device.type == "cpu":
        return bucket_reduce_ref(pts, ent, seg, F, b3, affine)
    if pts.device.type != "cuda":
        raise ValueError(f"bucket_reduce: unsupported device {pts.device}")
    out = launch_reduce(pts, ent, seg, F, b3, affine, tpi)
    if out.numel():
        bucket_reduce.launches += 1
        bucket_reduce.launches_by_form[ct.form_of(F)] += 1
    return out


def launch_reduce(pts, ent, seg, F, b3, affine: bool, tpi):
    """The segment sums by K1 (``csrc/fast_kernels.cu`` zt_bucket_reduce)
    with ``tpi`` threads a segment (None: the SUM_TPI table's pick for the
    launch's entries, ``ent.numel()``).
    Raise unless the inputs are contiguous int32 on one device and F is
    the field the form was built for, or on a CUDA error."""
    from ..utils.build import sum_tpi

    for name, t in (("ent", ent), ("seg", seg)):
        if (t.device != pts.device or t.dtype != torch.int32
                or not t.is_contiguous()):
            raise ValueError(
                f"bucket_reduce: {name} must be contiguous int32 on "
                f"{pts.device}, got {t.dtype} on {t.device}"
            )
    pc.check_points("bucket_reduce", F, pts, width=2 if affine else 3)
    form = pc.fast_form("bucket_reduce", F)
    pts = pc.aligned(pts)
    nseg = seg.numel() - 1
    out = torch.empty((max(nseg, 0), 3, *F.shape), dtype=torch.int32,
                      device=pts.device)
    if nseg > 0:
        if tpi is None:
            tpi = sum_tpi("bucket_reduce", form, ent.numel())
        pc.launch_fast("bucket_reduce", "zt_bucket_reduce", (form, tpi), out,
                       pts.data_ptr(), ent.data_ptr(), seg.data_ptr(), nseg,
                       out.data_ptr(), int(affine),
                       ct.kernel_consts(F, b3)[3].ctypes.data)
    return out


#: kernel launches since the counts were last reset, in all and per field
#: form ("fq12", "fq24", "fq2")
bucket_reduce.launches = 0
bucket_reduce.launches_by_form = collections.Counter()


def segments(counts: torch.Tensor, n_ent: int):
    """Runs of ``counts[i]`` consecutive entries cut into segments of at
    most SEG: (seg offsets (nseg + 1,) int32, chunks per run)."""
    dev = counts.device
    nch = (counts + SEG - 1) // SEG
    total = int(nch.sum())
    run_start = torch.cumsum(counts, 0) - counts
    first = torch.cumsum(nch, 0) - nch
    owner = torch.repeat_interleave(
        torch.arange(counts.numel(), device=dev), nch
    )
    j = torch.arange(total, device=dev) - first[owner]
    lo = run_start[owner] + j * SEG
    seg = torch.cat([lo, lo.new_tensor([n_ent])]).to(torch.int32)
    return seg, nch


def reduce_runs(pts, ent, counts, F, b3, affine: bool):
    """Sums of consecutive runs of ``ent`` (run i has counts[i] entries):
    (len(counts), 3, *F.shape) projective, identity for empty runs.  Runs are cut
    into segments of at most SEG entries; the segment partials of each run
    are summed by further launches until one partial per run is left."""
    nruns = counts.numel()
    dev = pts.device
    while True:
        seg, nch = segments(counts, ent.numel())
        if seg.numel() == 1:
            return ct.identity(F, (nruns,), dev)
        part = bucket_reduce(pts, ent, seg, F, b3, affine)
        if int(nch.max()) <= 1:
            break
        pts, affine, counts = part, False, nch
        ent = torch.arange(part.shape[0], device=dev, dtype=torch.int32) * 2
    out = ct.identity(F, (nruns,), dev)
    out[nch == 1] = part
    return out


# ---------------------------------------------------------------------------
# MSM
# ---------------------------------------------------------------------------


def signed_digits(scal: torch.Tensor, nbits: int, c: int):
    """(n, nl) int32 standard-form scalar limbs -> (W, n) int64 bucket
    indices |d| and (W, n) int64 signs (1 = subtract the point).

    Balanced digits in [-2^(c-1), 2^(c-1)], a +1 carry into the next window
    where a raw digit exceeds 2^(c-1) (msm8.signed_digits_from_limbs8)."""
    n = scal.shape[0]
    x = torch.nn.functional.pad(scal.to(torch.int64) & 0xFFFFFFFF, (0, 1))
    W = num_windows(nbits, c)
    half, full = 1 << (c - 1), 1 << c
    carry = torch.zeros(n, dtype=torch.int64, device=scal.device)
    buckets, signs = [], []
    for w in range(W):
        k, sh = divmod(c * w, 32)
        raw = ((x[:, k] >> sh) | (x[:, k + 1] << (32 - sh))) & (full - 1)
        d = raw + carry
        over = d > half
        carry = over.long()
        d = torch.where(over, d - full, d)
        signs.append((d < 0).long())
        buckets.append(d.abs())
    return torch.stack(buckets), torch.stack(signs)


def bucket_entries(scal, inf, nbits: int, c: int):
    """Entries (point index << 1 | sign, int32) sorted by global bucket
    w*K + |d| - 1, and the (W*K,) count of each bucket; zero digits and
    points at infinity make no entry."""
    K = 1 << (c - 1)
    buckets, signs = signed_digits(scal, nbits, c)
    valid = (buckets != 0) & ~inf.unsqueeze(0)
    wi, pi = valid.nonzero(as_tuple=True)
    gb, order = torch.sort(wi * K + buckets[wi, pi] - 1, stable=True)
    ent = (pi * 2 + signs[wi, pi])[order].to(torch.int32)
    counts = torch.bincount(gb, minlength=buckets.shape[0] * K)
    return ent, counts


def subset_entries(W: int, c: int, dev):
    """Entries and run lengths of the W*c subset sums S[w, k] = sum of the
    buckets B[w, b], b in 1..2^(c-1), whose index b has bit k set: run
    w*c + k names the bucket rows w*K + b - 1 (K = 2^(c-1))."""
    K = 1 << (c - 1)
    bvals = torch.arange(1, K + 1, device=dev)
    sel = [((bvals >> k) & 1).nonzero().squeeze(-1) for k in range(c)]
    ent = torch.cat(
        [(w * K + s) * 2 for w in range(W) for s in sel]
    ).to(torch.int32)
    counts = torch.tensor(
        [s.numel() for _ in range(W) for s in sel], device=dev
    )
    return ent, counts


def host_curve(curve_name: str, g2: bool):
    return hc.g2_curve(curve_name) if g2 else hc.g1_curve(curve_name)


def subset_sums(curve_name: str, g2: bool, scal, xy, inf, c: int):
    """Steps 1-4: the W*c subset sums S[w, k], run w*c + k, as
    (W*c, 3, *F.shape) projective points on the device; the MSM is
    sum_j 2^j S_j over j = c*w + k.  Arguments as ``msm``'s."""
    F = ct.coord_field(curve_name, g2)
    b3 = ct.b3_of(curve_name, g2)
    n = xy.shape[0]
    if scal.shape[0] != n or inf.shape[0] != n:
        raise ValueError("msm: scalars, points and mask differ in length")
    nbits = P.CURVES[curve_name].r.bit_length()
    W = num_windows(nbits, c)
    ent, counts = bucket_entries(scal, inf, nbits, c)
    sums = reduce_runs(xy.contiguous(), ent, counts, F, b3, affine=True)
    ent2, counts2 = subset_entries(W, c, xy.device)
    return reduce_runs(sums, ent2, counts2, F, b3, affine=False)


def fold_subsets(crv: pc.ProjCurve, subs, c: int):
    """(B, W*c, 3, *F.shape) subset sums of B MSMs -> their B projective
    points (B, 3, *F.shape), on the device: a Horner over k = c-1 .. 0 for
    all windows at once (one K3 doubling and one K2 add of B W points a
    step), then over the windows, most significant first (a K3 chain of c
    and a K2 add of B points a window), as ``msm8_core`` folds its window
    sums."""
    s = subs.reshape(subs.shape[0], -1, c, *subs.shape[2:])
    t = s[:, :, c - 1]
    for k in range(c - 2, -1, -1):
        t = crv.add(crv.dbl(t), s[:, :, k])
    acc = t[:, -1]
    for w in range(t.shape[1] - 2, -1, -1):
        acc = crv.add(crv.dbl_chain(acc, c), t[:, w])
    return acc


def msm_projective(curve_name: str, g2: bool, scal, xy, inf, c: int = 0):
    """The MSM as one projective point (1, 3, *F.shape) on the device: the
    subset sums folded there (``fold_subsets``), where ``msm`` folds them
    on the host.  The device partial that ``msm4_sharded`` combines.
    Arguments as ``msm``'s."""
    c = c or default_window(xy.shape[0])
    subs = subset_sums(curve_name, g2, scal, xy, inf, c)
    return fold_subsets(pc.ProjCurve(curve_name, g2), subs.unsqueeze(0), c)


def msm(curve_name: str, g2: bool, scal, xy, inf, c: int = 0):
    """sum_i scal[i] * P_i -> host affine point (None for the identity).

    ``scal``: (n, nl) int32 standard-form limbs of scalars < r; ``xy``:
    (n, 2, *F.shape) int32 affine Montgomery points over the group's
    coordinate field (``curve_torch.coord_field``: (n, 2, 2, 12) for
    BLS12-377 G2); ``inf``: (n,) bool mask of points at infinity.  All
    three on one device."""
    F = ct.coord_field(curve_name, g2)
    subs = subset_sums(curve_name, g2, scal, xy, inf,
                       c or default_window(xy.shape[0]))

    # Horner over bit positions j = c*w + k on the host, in Jacobian
    # coordinates: one field inversion in all instead of one per step
    g = host_curve(curve_name, g2)
    acc = None
    for pt in reversed(ct.to_affine_host(F, subs)):
        acc = g.jac_add_mixed(g.jac_dbl(acc), pt)
    return g.from_jacobian(acc)
