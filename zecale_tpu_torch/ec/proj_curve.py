"""The msm8 engine's curve object, with its group law on the card.

Ports ``ec/ec_pallas.py:PallasProjCurve`` (745-792) and the glue of
``ec/curve_jax.py:ProjCurve`` (49): a complete-RCB projective curve whose
``add``, ``dbl`` and ``dbl_chain`` run as hand-written kernels and whose
element-wise glue (mask, select, identity, from_affine) is plain torch.

  * K2 ``proj_add`` (``csrc/fast_kernels.cu`` zt_proj_add) replaces
    ``_KernelFamily.proj_add`` (573-594): B independent pairs, canonical
    outputs, on the fast field core (compile-time moduli, TPI threads per
    point, TPI from ``utils/build.py:ADD_TPI`` by kernel, form and batch
    size);
  * K3 ``proj_dbl_chain`` (``csrc/fast_kernels.cu`` zt_proj_dbl_chain)
    replaces ``_KernelFamily.proj_dbl_chain`` (596-619): 2^k P by k
    doublings in one launch, on the fast field core, one warp a point
    with the products of each step side by side (TPI lanes a product, from
    ``utils/build.py:DBL_TPI`` by kernel, form and batch size).

Both exist in three forms, by the group's coordinate field: BLS12-377 Fq
(12 limbs), BW6-761 Fq (24 limbs, G1 and G2) and BLS12-377 Fq2.  Points are
int32 tensors (..., 3, *F.shape), as in ``ec/curve_torch.py``.  A wrapper
takes its plain version (``curve_torch.proj_add``, k times
``curve_torch.proj_dbl``) only for tensors on the CPU; on a CUDA tensor it
launches its kernel or raises.  Each keeps a count of its launches.
"""

from __future__ import annotations

import collections
import math

import torch

from ..ff import params as P
from . import curve_torch as ct

#: the prime each kernel form is built for (fast_kernels.cu fixes it at
#: compile time)
FORM_PRIME = {"fq12": P.CURVES["bls12-377"].q, "fq24": P.CURVES["bw6-761"].q,
              "fq2": P.CURVES["bls12-377"].q}


def check_points(name: str, F, *ts, width: int = 3) -> None:
    """Raise unless every tensor is a contiguous int32 batch of points of
    ``width`` coordinates over F, all on one device."""
    for t in ts:
        if (t.device != ts[0].device or t.dtype != torch.int32
                or not t.is_contiguous()
                or tuple(t.shape[-1 - len(F.shape):]) != (width, *F.shape)):
            raise ValueError(
                f"{name}: points must be contiguous int32 (..., {width}, "
                f"{', '.join(map(str, F.shape))}) on one device, got "
                f"{t.dtype} {tuple(t.shape)} on {t.device}")


def fast_form(name: str, F) -> str:
    """The kernel form of F for the fast-core kernels, which fix their
    prime at compile time; raise unless F is the field it was built for."""
    form = ct.form_of(F)
    base = getattr(F, "base", F)
    if base.p != FORM_PRIME.get(form) or getattr(F, "nr", -5) != -5:
        raise ValueError(f"{name}: the {form} kernels are built for another "
                         "field")
    return form


def launch_fast(name: str, sym: str, key: tuple, out, *args) -> None:
    """Launch the fast-core kernel ``sym`` of variant ``key`` (form, TPI)
    on the current stream; raise if it is not built or on a CUDA error."""
    from ..utils.build import cuda_kernels

    fn = cuda_kernels().get((sym, key))
    if fn is None:
        raise ValueError(f"{name}: no {key[0]} variant with {key[1]} threads "
                         "per point is built")
    # the launcher launches on the current device: make it the tensors'
    # (a mesh puts shards on several cards of one process)
    with torch.cuda.device(out.device):
        rc = fn(*args, torch.cuda.current_stream(out.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")


def aligned(t: torch.Tensor) -> torch.Tensor:
    """t, or a copy where it does not start on 16 bytes: the fast kernels
    read 8- and 16-byte pieces of each row."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def launch_add(name: str, sym: str, F, tpi, p, q,
               b3=None) -> torch.Tensor:
    """p + q by the fast-core kernel ``sym`` (K2 zt_proj_add with b3, K4
    zt_jac_add without) with ``tpi`` threads per point (None: the
    ADD_TPI table's pick for the batch).  Raise unless F is the field the
    form was built for, or on a CUDA error."""
    from ..utils.build import add_tpi

    if p.shape != q.shape:
        raise ValueError(f"{name}: shapes {tuple(p.shape)} and "
                         f"{tuple(q.shape)} differ")
    check_points(name, F, p, q)
    form = fast_form(name, F)
    p, q = aligned(p), aligned(q)
    out = torch.empty_like(p)
    n = p.numel() // (3 * math.prod(F.shape))
    if n:
        if tpi is None:
            tpi = add_tpi(name, form, n)
        args = [p.data_ptr(), q.data_ptr(), out.data_ptr(), n]
        if b3 is not None:
            args.append(ct.kernel_consts(F, b3)[3].ctypes.data)
        launch_fast(name, sym, (form, tpi), out, *args)
    return out


def launch_dbl(name: str, sym: str, F, tpi, p, k: int,
               b3=None) -> torch.Tensor:
    """2^k p by the fast-core kernel ``sym`` (K3 zt_proj_dbl_chain with
    b3, K5 zt_jac_dbl_chain without) with ``tpi`` lanes a product (None:
    the DBL_TPI table's pick for the batch).  Raise unless F is the field
    the form was built for, or on a CUDA error."""
    from ..utils.build import dbl_tpi

    check_points(name, F, p)
    form = fast_form(name, F)
    p = aligned(p)
    out = torch.empty_like(p)
    n = p.numel() // (3 * math.prod(F.shape))
    if n:
        if tpi is None:
            tpi = dbl_tpi(name, form, n)
        args = [p.data_ptr(), out.data_ptr(), n, k]
        if b3 is not None:
            args.append(ct.kernel_consts(F, b3)[3].ctypes.data)
        launch_fast(name, sym, (form, tpi), out, *args)
    return out


def proj_add(F, p: torch.Tensor, q: torch.Tensor, b3) -> torch.Tensor:
    """p + q for equal-shape point batches (complete RCB add)."""
    return proj_add_tpi(F, p, q, b3, None)


def proj_add_tpi(F, p: torch.Tensor, q: torch.Tensor, b3,
                 tpi) -> torch.Tensor:
    """``proj_add`` with K2's threads per point set to ``tpi`` (None: the
    ADD_TPI table's)."""
    if p.device.type == "cpu":
        return ct.proj_add(F, p, q, b3)
    if p.device.type != "cuda":
        raise ValueError(f"proj_add: unsupported device {p.device}")
    out = launch_add("proj_add", "zt_proj_add", F, tpi, p, q, b3=b3)
    if out.numel():
        proj_add.launches += 1
        proj_add.launches_by_form[ct.form_of(F)] += 1
    return out


def proj_dbl_chain(F, p: torch.Tensor, k: int, b3) -> torch.Tensor:
    """2^k p (k >= 1 complete RCB doublings)."""
    return proj_dbl_chain_tpi(F, p, k, b3, None)


def proj_dbl_chain_tpi(F, p: torch.Tensor, k: int, b3,
                       tpi) -> torch.Tensor:
    """``proj_dbl_chain`` with K3's lanes a product set to ``tpi`` (None:
    the DBL_TPI table's)."""
    if k < 1:
        raise ValueError(f"proj_dbl_chain: k = {k} < 1")
    if p.device.type == "cpu":
        for _ in range(k):
            p = ct.proj_dbl(F, p, b3)
        return p
    if p.device.type != "cuda":
        raise ValueError(f"proj_dbl_chain: unsupported device {p.device}")
    out = launch_dbl("proj_dbl_chain", "zt_proj_dbl_chain", F, tpi, p, k,
                     b3=b3)
    if out.numel():
        proj_dbl_chain.launches += 1
        proj_dbl_chain.launches_by_form[ct.form_of(F)] += 1
    return out


#: kernel launches since the counts were last reset, in all and per form
proj_add.launches = 0
proj_add.launches_by_form = collections.Counter()
proj_dbl_chain.launches = 0
proj_dbl_chain.launches_by_form = collections.Counter()


class ProjCurve:
    """The group G1 or G2 of an a = 0 curve with the complete RCB law;
    points are (..., 3, *F.shape) int32 tensors, identity (0:1:0)."""

    def __init__(self, curve_name: str, g2: bool):
        self.curve_name = curve_name
        self.g2 = g2
        self.F = ct.coord_field(curve_name, g2)
        self.b3 = ct.b3_of(curve_name, g2)
        self._cdims = len(self.F.shape)

    # -- kernel-backed ops ------------------------------------------------
    def add(self, p, q):
        return proj_add(self.F, p.contiguous(), q.contiguous(), self.b3)

    def dbl(self, p):
        return self.dbl_chain(p, 1)

    def dbl_chain(self, p, k: int):
        if k == 0:
            return p
        return proj_dbl_chain(self.F, p.contiguous(), k, self.b3)

    # -- glue -------------------------------------------------------------
    def _bcast(self, mask):
        """(...,) bool -> broadcastable against (..., 3, *F.shape)."""
        return mask.view(*mask.shape, *[1] * (1 + self._cdims))

    def identity_like(self, pt):
        return ct.identity(self.F, pt.shape[: -1 - self._cdims], pt.device)

    def mask(self, pt, keep):
        """Identity-out the points where ``keep`` is False (all three
        coordinates: the complete law needs points on the curve)."""
        return torch.where(self._bcast(keep), pt, self.identity_like(pt))

    def select(self, cond, if_true, if_false):
        return torch.where(self._bcast(cond), if_true, if_false)

    def from_affine(self, xy, inf):
        """(..., 2, *F.shape) affine + (...,) infinity mask -> projective
        (identity where ``inf``)."""
        lead = xy.shape[: xy.dim() - 1 - self._cdims]
        one = self.F.consts(xy.device)["one"].expand(*lead, 1, *self.F.shape)
        pt = torch.cat([xy, one], dim=-1 - self._cdims)
        return self.mask(pt, ~inf)

    def to_jacobian(self, pt):
        """(X:Y:Z) -> Jacobian (X Z, Y Z^2, Z) (``ProjCurve.to_jacobian``,
        ``curve_jax.py:93``): the identity (0:1:0) gets Z = 0, Jacobian
        infinity."""
        x, y, z = pt.unbind(-1 - self._cdims)
        return torch.stack([self.F.mul(x, z),
                            self.F.mul(y, self.F.sqr(z)), z],
                           dim=-1 - self._cdims)

    def to_affine_host(self, pts) -> list:
        flat = pts.reshape(-1, 3, *self.F.shape)
        return ct.to_affine_host(self.F, flat)
