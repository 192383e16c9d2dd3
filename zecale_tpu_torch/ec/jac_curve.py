"""The Jacobian engine's curve object, with its group law on the card.

Ports ``ec/curve_jax.py:JacCurve`` (188) and its kernel-backed subset
``ec/ec_pallas.py:PallasG1Curve`` (654): the unified Jacobian law of a = 0
curves, whose ``add``, ``dbl``, ``dbl_chain`` and ``add_affine_affine`` run
as hand-written kernels and whose element-wise glue (mask, select,
infinity, the lift of affine points, the tree and bit-serial sums) is plain
torch.

  * K4 ``jac_add`` (``csrc/fast_kernels.cu`` zt_jac_add) replaces
    ``_KernelFamily.jac_add`` (473-493): B independent pairs, canonical
    outputs, on the fast field core (compile-time moduli, TPI threads per
    point, TPI from ``utils/build.py:ADD_TPI`` by kernel, form and batch
    size);
  * K5 ``jac_dbl_chain`` (``csrc/fast_kernels.cu`` zt_jac_dbl_chain)
    replaces ``_KernelFamily.jac_dbl`` (495) and ``jac_dbl_chain`` (514):
    2^k P by k doublings in one launch, on the fast field core, one warp
    a point (TPI from ``utils/build.py:DBL_TPI``, as K3's);
  * K6 ``aff_add`` (``csrc/fast_kernels.cu`` zt_aff_add) replaces
    ``_KernelFamily.aff_add`` (543-569): affine + affine with per-point
    infinity flags, a Jacobian result, on the fast field core (TPI from
    ``utils/build.py:SUM_TPI`` by form and batch size).

``add_mixed`` runs as K4 on the lifted affine point (Z = 1, or Z = 0 where
it is at infinity): madd-2007-bl equals add-2007-bl at Z2 = 1 in every
branch, so the triple is the reference's.  All three kernels exist in three
forms, by the group's coordinate field: BLS12-377 Fq (12 limbs), BW6-761 Fq
(24 limbs, G1 and G2) and BLS12-377 Fq2.  Points are int32 tensors
(..., 3, *F.shape); affine points (..., 2, *F.shape) with a (...,) bool
infinity mask.  A wrapper takes its plain version (``curve_torch.jac_add``,
k times ``curve_torch.jac_dbl``, ``curve_torch.aff_add``) only for tensors
on the CPU; on a CUDA tensor it launches its kernel or raises.  Each keeps
a count of its launches.
"""

from __future__ import annotations

import collections
import math

import torch

from ..ff import params as P
from . import curve_torch as ct
from .proj_curve import (aligned, check_points, fast_form, launch_add,
                         launch_dbl, launch_fast)


def _count(fn, F) -> None:
    fn.launches += 1
    fn.launches_by_form[ct.form_of(F)] += 1


def jac_add(F, p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """p + q for equal-shape Jacobian batches (K4)."""
    return jac_add_tpi(F, p, q, None)


def jac_add_tpi(F, p: torch.Tensor, q: torch.Tensor, tpi) -> torch.Tensor:
    """``jac_add`` with K4's threads per point set to ``tpi`` (None: the
    ADD_TPI table's)."""
    if p.device.type == "cpu":
        return ct.jac_add(F, p, q)
    if p.device.type != "cuda":
        raise ValueError(f"jac_add: unsupported device {p.device}")
    out = launch_add("jac_add", "zt_jac_add", F, tpi, p, q)
    if out.numel():
        _count(jac_add, F)
    return out


def jac_dbl_chain(F, p: torch.Tensor, k: int) -> torch.Tensor:
    """2^k p (k >= 1 doublings, K5)."""
    return jac_dbl_chain_tpi(F, p, k, None)


def jac_dbl_chain_tpi(F, p: torch.Tensor, k: int, tpi) -> torch.Tensor:
    """``jac_dbl_chain`` with K5's lanes a product set to ``tpi`` (None:
    the DBL_TPI table's)."""
    if k < 1:
        raise ValueError(f"jac_dbl_chain: k = {k} < 1")
    if p.device.type == "cpu":
        for _ in range(k):
            p = ct.jac_dbl(F, p)
        return p
    if p.device.type != "cuda":
        raise ValueError(f"jac_dbl_chain: unsupported device {p.device}")
    out = launch_dbl("jac_dbl_chain", "zt_jac_dbl_chain", F, tpi, p, k)
    if out.numel():
        _count(jac_dbl_chain, F)
    return out


def aff_add(F, a: torch.Tensor, a_inf: torch.Tensor, b: torch.Tensor,
            b_inf: torch.Tensor) -> torch.Tensor:
    """a + b for equal-shape affine batches with infinity masks, as
    Jacobian points (K6)."""
    return aff_add_tpi(F, a, a_inf, b, b_inf, None)


def aff_add_tpi(F, a: torch.Tensor, a_inf: torch.Tensor, b: torch.Tensor,
                b_inf: torch.Tensor, tpi) -> torch.Tensor:
    """``aff_add`` with K6's threads per point set to ``tpi`` (None: the
    SUM_TPI table's)."""
    if a.device.type == "cpu":
        return ct.aff_add(F, a, a_inf, b, b_inf)
    if a.device.type != "cuda":
        raise ValueError(f"aff_add: unsupported device {a.device}")
    out = launch_aff(F, a, a_inf, b, b_inf, tpi)
    if out.numel():
        _count(aff_add, F)
    return out


def launch_aff(F, a, a_inf, b, b_inf, tpi) -> torch.Tensor:
    """a + b by K6 (``csrc/fast_kernels.cu`` zt_aff_add) with ``tpi``
    threads a point (None: the SUM_TPI table's pick for the batch).  Raise
    unless the shapes match, the inputs are contiguous on one device and F
    is the field the form was built for, or on a CUDA error."""
    from ..utils.build import sum_tpi

    lead = a.shape[: a.dim() - 1 - len(F.shape)]
    if b.shape != a.shape or a_inf.shape != lead or b_inf.shape != lead:
        raise ValueError(f"aff_add: shapes {tuple(a.shape)}, "
                         f"{tuple(b.shape)}, masks {tuple(a_inf.shape)}, "
                         f"{tuple(b_inf.shape)} do not match")
    check_points("aff_add", F, a, b, width=2)
    for m in (a_inf, b_inf):
        if (m.dtype != torch.bool or m.device != a.device
                or not m.is_contiguous()):
            raise ValueError("aff_add: masks must be contiguous bool on "
                             f"{a.device}, got {m.dtype} on {m.device}")
    form = fast_form("aff_add", F)
    a, b = aligned(a), aligned(b)
    out = torch.empty(*lead, 3, *F.shape, dtype=torch.int32, device=a.device)
    n = math.prod(lead)
    if n:
        if tpi is None:
            tpi = sum_tpi("aff_add", form, n)
        launch_fast("aff_add", "zt_aff_add", (form, tpi), out, a.data_ptr(),
                    a_inf.data_ptr(), b.data_ptr(), b_inf.data_ptr(),
                    out.data_ptr(), n)
    return out


#: kernel launches since the counts were last reset, in all and per form
for _fn in (jac_add, jac_dbl_chain, aff_add):
    _fn.launches = 0
    _fn.launches_by_form = collections.Counter()
del _fn


class JacCurve:
    """The group G1 or G2 of an a = 0 curve with the unified Jacobian law;
    points are (..., 3, *F.shape) int32 tensors, Z = 0 at infinity."""

    def __init__(self, curve_name: str, g2: bool):
        if P.CURVES[curve_name].a != 0:
            raise ValueError(f"{curve_name}: the Jacobian law needs a = 0")
        self.curve_name = curve_name
        self.g2 = g2
        self.F = ct.coord_field(curve_name, g2)
        self._cd = len(self.F.shape)

    # -- kernel-backed ops ------------------------------------------------
    def add(self, p, q):
        return jac_add(self.F, p.contiguous(), q.contiguous())

    def dbl(self, p):
        return self.dbl_chain(p, 1)

    def dbl_chain(self, p, k: int):
        if k == 0:
            return p
        return jac_dbl_chain(self.F, p.contiguous(), k)

    def add_affine_affine(self, a, a_inf, b, b_inf):
        return aff_add(self.F, a.contiguous(), a_inf.contiguous(),
                       b.contiguous(), b_inf.contiguous())

    def add_mixed(self, p, q_xy, q_inf):
        """P + Q for affine Q: K4 on the lifted Q."""
        return self.add(p, self.lift(q_xy, q_inf))

    # -- glue -------------------------------------------------------------
    def _bcast(self, mask):
        """(...,) bool -> broadcastable against (..., 3, *F.shape)."""
        return mask.view(*mask.shape, *[1] * (1 + self._cd))

    def lift(self, xy, inf):
        """Affine (..., 2, *F.shape) + (...,) infinity mask -> Jacobian
        (x, y, 1), (x, y, 0) where ``inf``."""
        return ct.jac_from_affine(self.F, xy, inf)

    def infinity_like(self, pt):
        return torch.zeros_like(pt)

    def mask(self, pt, keep):
        """Infinity where ``keep`` is False: Z set to 0, X and Y kept, as
        the reference masks."""
        ax = -1 - self._cd
        z = torch.where(self._bcast(keep), pt.narrow(ax, 2, 1), 0)
        xy = pt.narrow(ax, 0, 2).expand(*z.shape[:ax], 2, *self.F.shape)
        return torch.cat([xy, z], dim=ax)

    def select(self, cond, if_true, if_false):
        return torch.where(self._bcast(cond), if_true, if_false)

    def tree_reduce(self, pts):
        """Sum along the axis before the coordinates by the reference's
        pairwise tree (even + odd neighbours, an odd tail carried up): one
        K4 launch per level across every leading index."""
        v = pts.movedim(-2 - self._cd, 0)
        n = v.shape[0]
        while n > 1:
            half = n // 2
            summed = self.add(v[0: 2 * half: 2], v[1: 2 * half: 2])
            v = torch.cat([summed, v[2 * half:]]) if n % 2 else summed
            n = v.shape[0]
        return v[0]

    def msm(self, bits, pts):
        """sum_i s_i P_i, bit-serial as ``JacCurve.msm`` (430): acc = 2 acc
        + tree sum of the points whose bit is set, MSB first.  ``bits``:
        (nb, ..., N) with 0/1 entries; ``pts``: (..., N, 3, *F.shape).  The
        nb trees do not depend on acc, so they are summed together, one K4
        launch per level for all bits (nb times the points in memory)."""
        trees = self.tree_reduce(self.mask(pts.unsqueeze(0), bits > 0))
        acc = trees[0]  # 2 * O + T_0 = T_0 exactly, as in the reference
        for t in trees[1:]:
            acc = self.add(self.dbl(acc), t)
        return acc

    def to_affine_host(self, pts) -> list:
        flat = pts.reshape(-1, 3, *self.F.shape)
        return ct.jac_to_affine_host(self.F, flat)
