"""Complete projective group law for a = 0 curves in plain PyTorch.

Ports ``ec/curve_jax.py:ProjCurve`` (49) and the lazy-form bodies
``ff/fp8q.py:proj_add_q`` (470) and ``proj_dbl_q`` (538): the complete
Renes-Costello-Batina formulas (RCB16 algorithms 7, 8 and 9) over canonical
Montgomery field tensors.  These are the plain versions of the functions in
``csrc/curve.cuh``; they compute the same canonical coordinates, so kernel
and plain outputs compare bit for bit.

The coordinate field F is ``ff/fp_torch.Field`` (elements (..., n)) or
``ff/fp2_torch.Fp2`` (elements (..., 2, n), BLS12-377 G2); ``F.shape`` is
the trailing shape of one element.  Points are int32 tensors of shape
(..., 3, *F.shape) for projective (X:Y:Z) with identity (0:1:0), and
(..., 2, *F.shape) for affine (x, y).  b3 = 3b is a small signed integer
over Fq -- 3 (BLS12-377 G1), -3 (BW6-761 G1), 12 (BW6-761 G2) -- applied as
``F.mul_small``, never a negative limb multiply (the trap
``fp8q.py:496-501`` records); over Fq2 it is the twist constant (c0, c1) =
(0, -3/5), a full Fq2 product.

It also holds the plain versions of the unified Jacobian law
(``ec/curve_jax.py:JacCurve`` 188; ``jac_add``, ``jac_dbl``, ``aff_add``),
the twins of ``jac_add``, ``jac_dbl`` and ``aff_add`` in
``csrc/curve.cuh``: Jacobian points are (..., 3, *F.shape) too, with
x = X/Z^2, y = Y/Z^3 and Z = 0 at infinity, whatever X and Y hold there.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..ff import host_field as hf
from ..ff import params as P
from ..ff.fp2_torch import bls12_377_fq2
from ..ff.fp_torch import Field, field


def b3_of(curve_name: str, g2: bool):
    """3b of the group's curve: a small int over Fq, the (c0, c1) tuple of
    the twist constant for BLS12-377 G2 (y^2 = x^3 + 1/u, u^2 = -5)."""
    cp = P.CURVES[curve_name]
    if cp.a != 0:
        raise ValueError(f"{curve_name}: the RCB a=0 law needs a = 0")
    if g2 and cp.g2_degree != 1:
        if curve_name != "bls12-377":
            raise NotImplementedError(f"{curve_name} G2 is not ported")
        return (0, (-3 * pow(5, -1, cp.q)) % cp.q)
    b = 4 if g2 else cp.b  # BW6-761 M-twist: y^2 = x^3 + 4
    return {1: 3, cp.q - 1: -3, 4: 12}[b]


def base_field(curve_name: str) -> Field:
    return field(P.CURVES[curve_name].q)


def coord_field(curve_name: str, g2: bool):
    """The field of the group's coordinates: Fq, or Fq2 for BLS12-377 G2."""
    if g2 and P.CURVES[curve_name].g2_degree == 2:
        b3_of(curve_name, g2)  # refuses what is not ported
        return bls12_377_fq2()
    return base_field(curve_name)


def form_of(F) -> str:
    """The kernels' build form of a coordinate field (``utils/build.py``
    FORMS): "fq12", "fq24" or "fq2"."""
    return "fq2" if len(F.shape) == 2 else f"fq{F.n}"


@functools.lru_cache(maxsize=None)
def kernel_consts(F, b3) -> tuple:
    """The constants a kernel launcher takes, as host numpy arrays: the
    base prime and R mod p (uint32 limbs), -p^-1 mod 2^32, and the b3
    bytes (an int32, or the twist constant's 2 x n Montgomery limbs)."""
    base = getattr(F, "base", F)
    p = np.frombuffer(base.p.to_bytes(4 * base.n, "little"), dtype="<u4")
    one = np.frombuffer(base.r_mod_p.to_bytes(4 * base.n, "little"),
                        dtype="<u4")
    if isinstance(b3, int):
        b3_buf = np.array([b3], dtype=np.int32)
    else:
        b3_buf = F.pack_mont([b3]).numpy()
    return p.copy(), one.copy(), base.pinv32, np.ascontiguousarray(b3_buf)


@functools.lru_cache(maxsize=None)
def _b3_tensor(F, b3, device: str) -> torch.Tensor:
    return F.pack_mont([b3], device)[0]


def _mul_b3(F, t: torch.Tensor, b3) -> torch.Tensor:
    if isinstance(b3, int):
        return F.mul_small(t, b3)
    return F.mul(t, _b3_tensor(F, b3, str(t.device)))


def identity(F, shape, device) -> torch.Tensor:
    out = torch.zeros(*shape, 3, *F.shape, dtype=torch.int32, device=device)
    out.select(-1 - len(F.shape), 1).copy_(
        F.consts(device)["one"].expand(*shape, *F.shape))
    return out


def _xyz(F, pt):
    return pt.unbind(-1 - len(F.shape))


def _finish(F, t0, t1, t2, t3, t4, y3, b3):
    """Shared tail of algorithms 7 and 8, from the three cross terms."""
    t0 = F.add(F.add(t0, t0), t0)
    t2 = _mul_b3(F, t2, b3)
    z3 = F.add(t1, t2)
    t1 = F.sub(t1, t2)
    y3 = _mul_b3(F, y3, b3)
    x3 = F.sub(F.mul(t3, t1), F.mul(t4, y3))
    y3 = F.add(F.mul(t1, z3), F.mul(y3, t0))
    z3 = F.add(F.mul(z3, t4), F.mul(t0, t3))
    return torch.stack((x3, y3, z3), dim=-1 - len(F.shape))


def proj_add(F, p: torch.Tensor, q: torch.Tensor, b3):
    """p + q, RCB16 algorithm 7 (complete)."""
    x1, y1, z1 = _xyz(F, p)
    x2, y2, z2 = _xyz(F, q)
    t0 = F.mul(x1, x2)
    t1 = F.mul(y1, y2)
    t2 = F.mul(z1, z2)
    t3 = F.sub(F.mul(F.add(x1, y1), F.add(x2, y2)), F.add(t0, t1))
    t4 = F.sub(F.mul(F.add(y1, z1), F.add(y2, z2)), F.add(t1, t2))
    y3 = F.sub(F.mul(F.add(x1, z1), F.add(x2, z2)), F.add(t0, t2))
    return _finish(F, t0, t1, t2, t3, t4, y3, b3)


def proj_add_mixed(F, p: torch.Tensor, q_aff: torch.Tensor, b3):
    """p + (x, y, 1), RCB16 algorithm 8: equal to ``proj_add`` with Z2 = 1.
    q must not be the identity."""
    x1, y1, z1 = _xyz(F, p)
    x2, y2 = _xyz(F, q_aff)
    t0 = F.mul(x1, x2)
    t1 = F.mul(y1, y2)
    t3 = F.sub(F.mul(F.add(x1, y1), F.add(x2, y2)), F.add(t0, t1))
    t4 = F.add(F.mul(y2, z1), y1)
    y3 = F.add(F.mul(x2, z1), x1)
    return _finish(F, t0, t1, z1, t3, t4, y3, b3)


def proj_dbl(F, p: torch.Tensor, b3):
    """2p, RCB16 algorithm 9 (complete)."""
    x, y, z = _xyz(F, p)
    t0 = F.mul(y, y)
    z3 = F.dbl(F.dbl(F.dbl(t0)))
    t1 = F.mul(y, z)
    t2 = _mul_b3(F, F.mul(z, z), b3)
    x3 = F.mul(t2, z3)
    y3 = F.add(t0, t2)
    z3 = F.mul(t1, z3)
    t2 = F.add(F.dbl(t2), t2)
    t0 = F.sub(t0, t2)
    y3 = F.add(x3, F.mul(t0, y3))
    x3 = F.dbl(F.mul(t0, F.mul(x, y)))
    return torch.stack((x3, y3, z3), dim=-1 - len(F.shape))


def is_zero(F, t: torch.Tensor) -> torch.Tensor:
    """(..., *F.shape) -> (...,) bool: the element is 0."""
    return (t == 0).flatten(-len(F.shape)).all(-1)


def jac_from_affine(F, xy: torch.Tensor, inf: torch.Tensor) -> torch.Tensor:
    """(..., 2, *F.shape) affine + (...,) infinity mask -> Jacobian
    (x, y, 1), or (x, y, 0) where ``inf``: the lift of ``JacCurve``'s mixed
    adds, which keep x and y of a point at infinity as they are."""
    one = F.consts(xy.device)["one"].expand(*inf.shape, *F.shape)
    z = torch.where(inf.view(*inf.shape, *[1] * len(F.shape)), 0, one)
    return torch.cat([xy, z.unsqueeze(-1 - len(F.shape))],
                     dim=-1 - len(F.shape))


def jac_dbl(F, p: torch.Tensor) -> torch.Tensor:
    """2P, dbl-2009-l (a = 0); Z = 0 stays Z = 0."""
    x, y, z = _xyz(F, p)
    a = F.mul(x, x)
    b = F.mul(y, y)
    c = F.mul(b, b)
    xb = F.add(x, b)
    d = F.dbl(F.sub(F.sub(F.mul(xb, xb), a), c))
    e = F.add(F.dbl(a), a)
    x3 = F.sub(F.mul(e, e), F.dbl(d))
    y3 = F.sub(F.mul(e, F.sub(d, x3)), F.dbl(F.dbl(F.dbl(c))))
    z3 = F.dbl(F.mul(y, z))
    return torch.stack((x3, y3, z3), dim=-1 - len(F.shape))


def _bc(F, mask: torch.Tensor) -> torch.Tensor:
    """(...,) bool -> broadcastable against (..., k, *F.shape)."""
    return mask.view(*mask.shape, *[1] * (1 + len(F.shape)))


def _on_rows(F, out, rows, fn, *args):
    """``out`` with the rows where ``rows`` holds replaced by fn(*args) of
    those rows: the plain versions compute a case's formulas only where it
    applies, as a kernel thread branches."""
    idx = rows.reshape(-1).nonzero().squeeze(1)
    if idx.numel():
        flat = out.reshape(-1, *out.shape[rows.dim():]).clone()
        flat[idx] = fn(F, *(a.reshape(-1, *a.shape[rows.dim():])[idx]
                            for a in args))
        out = flat.reshape(out.shape)
    return out


def _jac_add_finite(F, p, q):
    """add-2007-bl, or dbl-2009-l where P = Q, for finite P and Q; Z3 = 0
    where P = -Q, X3 and Y3 as the generic formulas leave them."""
    x1, y1, z1 = _xyz(F, p)
    x2, y2, z2 = _xyz(F, q)
    z1z1 = F.mul(z1, z1)
    z2z2 = F.mul(z2, z2)
    u1 = F.mul(x1, z2z2)
    u2 = F.mul(x2, z1z1)
    s1 = F.mul(y1, F.mul(z2, z2z2))
    s2 = F.mul(y2, F.mul(z1, z1z1))
    h = F.sub(u2, u1)
    r = F.sub(s2, s1)
    h2 = F.dbl(h)
    i = F.mul(h2, h2)
    j = F.mul(h, i)
    r2 = F.dbl(r)
    v = F.mul(u1, i)
    x3 = F.sub(F.sub(F.mul(r2, r2), j), F.dbl(v))
    y3 = F.sub(F.mul(r2, F.sub(v, x3)), F.dbl(F.mul(s1, j)))
    zs = F.add(z1, z2)
    z3 = F.mul(F.sub(F.sub(F.mul(zs, zs), z1z1), z2z2), h)
    out = torch.stack((x3, y3, z3), dim=-1 - len(F.shape))
    return _on_rows(F, out, is_zero(F, h) & is_zero(F, r), jac_dbl, p)


def jac_add(F, p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Unified P + Q (``JacCurve.add``): add-2007-bl, dbl-2009-l where
    P = Q, Z3 = 0 where P = -Q (X3, Y3 as the generic formulas leave them),
    Q's triple where P is at infinity and P's where Q is."""
    p_inf = is_zero(F, p.select(-1 - len(F.shape), 2))
    q_inf = is_zero(F, q.select(-1 - len(F.shape), 2))
    out = torch.where(_bc(F, p_inf), q, p)
    return _on_rows(F, out, ~p_inf & ~q_inf, _jac_add_finite, p, q)


def _aff_add_finite(F, a, b):
    """mmadd-2007-bl, or the doubling of (x1, y1, 1) where P = Q (which
    is mdbl-2007-bl's values); Z3 = 2H = 0 where P = -Q."""
    x1, y1 = _xyz(F, a)
    x2, y2 = _xyz(F, b)
    h = F.sub(x2, x1)
    ry = F.sub(y2, y1)
    i = F.dbl(F.dbl(F.mul(h, h)))
    j = F.mul(h, i)
    r = F.dbl(ry)
    v = F.mul(x1, i)
    x3 = F.sub(F.sub(F.mul(r, r), j), F.dbl(v))
    y3 = F.sub(F.mul(r, F.sub(v, x3)), F.dbl(F.mul(y1, j)))
    out = torch.stack((x3, y3, F.dbl(h)), dim=-1 - len(F.shape))
    finite = torch.zeros(out.shape[:-1 - len(F.shape)], dtype=torch.bool,
                         device=a.device)
    return _on_rows(F, out, is_zero(F, h) & is_zero(F, ry), jac_dbl,
                    jac_from_affine(F, a, finite))


def aff_add(F, a: torch.Tensor, a_inf: torch.Tensor, b: torch.Tensor,
            b_inf: torch.Tensor) -> torch.Tensor:
    """Affine + affine -> Jacobian (``JacCurve.add_affine_affine``): the
    lifted other operand where one is at infinity (x and y kept as they
    are), else ``_aff_add_finite``."""
    out = torch.where(_bc(F, a_inf), jac_from_affine(F, b, b_inf),
                      jac_from_affine(F, a, a_inf))
    return _on_rows(F, out, ~a_inf & ~b_inf, _aff_add_finite, a, b)


def to_affine_host(F, pts: torch.Tensor) -> list:
    """(k, 3, *F.shape) projective tensor -> host affine points (ints, or
    (c0, c1) tuples over Fq2; None for the identity), through one batched
    host inversion of the Z coordinates (a Fermat inversion per point
    costs about a second per BW6-761 MSM)."""
    H = F.host
    xs, ys, zs = (F.unpack_mont(c) for c in _xyz(F, pts))
    out = []
    for x, y, z, zi in zip(xs, ys, zs, hf.batch_inverse(H, zs)):
        out.append(None if H.is_zero(z) else (H.mul(x, zi), H.mul(y, zi)))
    return out


def jac_to_affine_host(F, pts: torch.Tensor) -> list:
    """(k, 3, *F.shape) Jacobian tensor -> host affine points (None where
    Z = 0), with one batched host inversion of the Z coordinates
    (``msm_tpu._jac_to_affine_batch``)."""
    H = F.host
    xs, ys, zs = (F.unpack_mont(c) for c in _xyz(F, pts))
    out = []
    for x, y, z, zi in zip(xs, ys, zs, hf.batch_inverse(H, zs)):
        if H.is_zero(z):
            out.append(None)
            continue
        zi2 = H.sqr(zi)
        out.append((H.mul(x, zi2), H.mul(y, H.mul(zi2, zi))))
    return out


def pack_affine(F, pts, device) -> tuple:
    """Host affine points (or None) -> ((k, 2, *F.shape) Montgomery tensor,
    (k,) bool infinity mask); the identity packs as (0, 0)."""
    zero = F.host.zero()
    flat = []
    for pt in pts:
        flat.extend((zero, zero) if pt is None else pt)
    xy = F.pack_mont(flat, device).reshape(len(pts), 2, *F.shape)
    inf = torch.tensor([pt is None for pt in pts], dtype=torch.bool)
    return xy, inf.to(device)
