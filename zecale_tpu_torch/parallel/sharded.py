"""Sharding of the prover's MSMs and FFTs over a mesh.

Ports ``parallel/sharded.py``: the point (or element) axis is sharded over
``parallel/mesh.py``; each shard runs a single-device engine on its slice
with the engine's kernels, and the partial points are all-gathered and
combined on the device by the reference's trees.  Each function takes the
global tensors (or this process's shards) as the reference's
``shard_map`` functions take sharded arrays, and returns its point
replicated: every process holds it, on its first device.  The MSMs return
one Jacobian point (3, *F.shape), Z = 0 at infinity, as the reference's
do; ``point_to_host`` gives the host affine point.  Each shard makes its
window (or subset) sums alone; the shards of one device then fold them
into their partial points together, one launch a fold step for all of
them (``_fold_local``), where the reference's shards, one a chip, fold
side by side.

  * ``msm_sharded`` (59): the jac engine, ``msm_jac.msm_pippenger``'s
    steps (K4, K5, K6) a shard, the partials summed by
    ``JacCurve.tree_reduce`` (K4);
  * ``fft_sharded`` (82): natural -> natural; the reference leaves its
    collectives to GSPMD, here a gather, the single-device
    ``fft_torch.fft`` and a re-shard (``fft_dist`` has the distributed
    network);
  * ``msm8_sharded`` (95): ``msm8_core``'s steps (K2, K3) a shard,
    projective partials tree-reduced by K2 as
    ``msm8._axis0_tree_reduce`` (413) does, then converted to Jacobian
    once;
  * ``msm4_sharded`` (153): the device partial of ``msm.msm_projective``
    (K1 subset sums, then the fold by K3 and K2) a shard, the partials
    summed by K2 in the tree of 196-211;
  * ``prove_core_sharded8`` (235) and ``prove_core_sharded`` (274): the
    QAP division and the H MSM, the prover's heart.
"""

from __future__ import annotations

import torch

from ..ec import curve_torch as ct
from ..ec import msm, msm8, msm_jac
from ..ec.proj_curve import ProjCurve
from ..ff import params as P
from ..ff.fp_torch import field
from ..poly import fft_torch
from . import fft_dist
from .mesh import Mesh


def _points(mesh, xy, inf) -> list:
    return list(zip(mesh.shard(xy), mesh.shard(inf)))


def _fold_local(mesh, parts: list, fold) -> list:
    """``fold`` of each local shard's window sums, the shards of one
    device stacked into one batch: each fold step is one launch for all
    of them.  -> one partial point a shard, in shard order."""
    out = [None] * len(parts)
    by_device = {}
    for i, d in enumerate(mesh.devices):
        by_device.setdefault(str(d), []).append(i)
    for idx in by_device.values():
        folded = fold(torch.stack([parts[i] for i in idx]))
        for j, i in enumerate(idx):
            out[i] = folded[j]
    return out


def point_to_host(curve_name: str, g2: bool, pt):
    """A Jacobian point (3, *F.shape) -> host affine (None at infinity)."""
    return ct.jac_to_affine_host(ct.coord_field(curve_name, g2),
                                 pt.reshape(1, *pt.shape))[0]


def msm_sharded(curve_name: str, mesh: Mesh, digits, xy, inf, c: int,
                g2: bool = False):
    """Distributed jac MSM: ``digits`` (W, n) unsigned c-bit digits, most
    significant window first (``msm_jac.scalar_digit_planes``), sharded
    along n; ``xy`` (n, 2, *F.shape) affine points and ``inf`` (n,) their
    infinity mask, sharded along n."""
    crv = msm_jac.curve(curve_name, g2)
    sums = [msm_jac.window_partials(crv, d.contiguous(), x.contiguous(), i, c)
            for d, (x, i) in zip(mesh.shard(digits, axis=1),
                                 _points(mesh, xy, inf))]
    parts = _fold_local(mesh, sums,
                        lambda t: msm_jac.fold_windows(crv, t, c))
    return crv.tree_reduce(mesh.all_gather(parts)[0])


def fft_sharded(mesh: Mesh, values, r: int, inverse: bool = False) -> list:
    """(n, L) Montgomery values, sharded -> their FFT (or inverse) in
    natural order, as this process's shards."""
    return mesh.shard(fft_torch.fft(mesh.gather(mesh.shard(values)), r,
                                    inverse=inverse))


def _pairs_tree(crv: ProjCurve, g):
    """Sum of (D, 3, *F) by neighbour pairs, the odd tail carried up
    (``msm8._axis0_tree_reduce``)."""
    while g.shape[0] > 1:
        n, half = g.shape[0], g.shape[0] // 2
        s = crv.add(g[0: 2 * half: 2], g[1: 2 * half: 2])
        g = torch.cat([s, g[2 * half:]]) if n % 2 else s
    return g[0]


def _halves_tree(crv: ProjCurve, g):
    """Sum of (D, 3, *F) by halves, first + second, the odd tail carried
    up (``msm4_sharded`` 196-211)."""
    while g.shape[0] > 1:
        n, half = g.shape[0], g.shape[0] // 2
        s = crv.add(g[:half], g[half: 2 * half])
        g = torch.cat([s, g[2 * half:]]) if n % 2 else s
    return g[0]


def msm8_sharded(curve_name: str, mesh: Mesh, scal, xy, inf, c: int,
                 g2: bool = False):
    """Distributed msm8: ``scal`` (n, nl) standard-form scalar limbs,
    ``xy``, ``inf`` as ``msm_sharded``'s, all sharded along n; each shard
    runs ``msm8_core`` (unchunked) on its slice."""
    crv = ProjCurve(curve_name, g2)
    nbits = P.CURVES[curve_name].r.bit_length()
    sums = []
    for s, (x, i) in zip(mesh.shard(scal), _points(mesh, xy, inf)):
        buckets, signs = msm.signed_digits(s, nbits, c)
        sums.append(msm8.window_sums(crv, buckets, signs, x.contiguous(), i,
                                     c))
    parts = _fold_local(mesh, sums, lambda t: msm8.fold_windows(crv, t, c))
    return crv.to_jacobian(_pairs_tree(crv, mesh.all_gather(parts)[0]))


def msm4_sharded(curve_name: str, mesh: Mesh, scal, xy, inf,
                 g2: bool = False, c: int = 0):
    """Distributed msm4, arguments as ``msm8_sharded``'s; ``c`` = 0 takes
    ``msm.default_window`` of a shard's n / D points, as the reference's
    per-shard plan does.  n must divide into the mesh (the reference's
    assert, 171).  The reference's ``calib`` (per-window sub-lane
    envelopes of its padded bucket matrix) has no counterpart: the port's
    msm4 builds no such matrix."""
    n = xy.shape[0] if torch.is_tensor(xy) else xy[0].shape[0] * mesh.size
    if n % mesh.size:
        raise ValueError(f"msm4_sharded: {n} points do not divide into "
                         f"{mesh.size} shards")
    c = c or msm.default_window(n // mesh.size)
    crv = ProjCurve(curve_name, g2)
    subs = [msm.subset_sums(curve_name, g2, s, x, i, c)
            for s, (x, i) in zip(mesh.shard(scal), _points(mesh, xy, inf))]
    parts = _fold_local(mesh, subs, lambda t: msm.fold_subsets(crv, t, c))
    return crv.to_jacobian(_halves_tree(crv, mesh.all_gather(parts)[0]))


def prove_core_sharded8(curve_name: str, mesh: Mesh, az, bz, cz, zinv_mont,
                        h_points_rev: dict, c: int):
    """The distributed prover heart: the QAP division by the distributed
    FFT (``fft_dist.h_pipeline_sharded``), H to standard form on the
    device, and ``msm8_sharded`` against ``h_points_rev`` ({"xy", "inf"}:
    the H query permuted by ``fft_dist.bitrev_permutation(n)``, to match
    H's bit-reversed order).  -> (H's coefficients in bit-reversed order,
    Montgomery, as this process's shards; the MSM's Jacobian point)."""
    Fr = field(P.CURVES[curve_name].r)
    h = fft_dist.h_pipeline_sharded(mesh, Fr.p, az, bz, cz, zinv_mont)
    out = msm8_sharded(curve_name, mesh, [Fr.from_mont(x) for x in h],
                       h_points_rev["xy"], h_points_rev["inf"], c)
    return h, out


def prove_core_sharded(curve_name: str, mesh: Mesh, az, bz, cz, zinv_mont,
                       h_digits, h_points: dict, c: int):
    """The GSPMD prover heart: the QAP division on the gathered
    evaluations (``poly/fft_torch.py``'s transforms with the given
    ``zinv_mont``), H re-sharded in natural order, and ``msm_sharded`` of
    ``h_digits`` against ``h_points`` ({"xy", "inf"}).  -> (H's
    coefficients, Montgomery, as this process's shards; the MSM's Jacobian
    point)."""
    r = P.CURVES[curve_name].r
    F = field(r)
    a, b, cc = (mesh.gather(mesh.shard(v)) for v in (az, bz, cz))
    a_e, b_e, c_e = (fft_torch.coset_fft(fft_torch.fft(v, r, inverse=True),
                                         r) for v in (a, b, cc))
    h_e = F.mul(F.sub(F.mul(a_e, b_e), c_e), zinv_mont.to(a_e.device))
    h = mesh.shard(fft_torch.coset_ifft(h_e, r))
    return h, msm_sharded(curve_name, mesh, h_digits, h_points["xy"],
                          h_points["inf"], c)
