"""The Jacobian MSM engine and the batched fixed-base multiply of the setup.

Ports ``ec/msm_tpu.py`` (the ``use_msm8=False`` MSM of
``snark/groth16_tpu.py`` and the trusted setup's scalar multiplication)
with ``JacCurve.msm_pippenger`` (``ec/curve_jax.py:561``, with
``_segment_tile_reduce`` 453 and ``_segment_tile_reduce_mixed`` 510) onto
the kernels of ``ec/jac_curve.py``: K4 ``jac_add``, K5 ``jac_dbl_chain``
and K6 ``aff_add`` (``csrc/fast_kernels.cu``).  It is named for its group
law; "tpu" named the reference's chip.

The Pippenger MSM keeps the reference's algorithm and constants:

  1. unsigned c-bit digits, most significant window first, the top window
     partial (``scalar_digit_planes``), here computed on the device from the
     32-bit scalar limbs;
  2. per window, a stable sort of the points by digit; zero digits join the
     infinity mask;
  3. while more than 512 entries remain: a tiled segmented scan (tiles of
     64 entries, 8 below 4096), each tile's running sum restarted at the
     start of every digit run; the first round adds affine points, the
     later ones Jacobian partials; the run ends are kept, sorted to the
     front and the array cut to max(512, tiles + 2^c + 2) (the reference's
     ``keep_len``), padding with sentinel digits 2^c to a whole tile;
  4. the surviving (digit, partial) pairs of each window summed as a c-bit
     bit-serial MSM (``JacCurve.msm``);
  5. the Horner fold over windows: c doublings (one K5 launch) and one K4
     add per window.

Where the reference ran one window under ``jax.vmap`` (``curve_jax.py:647``),
the windows are a leading axis here: every scan step is one launch across
all windows and tiles, and nothing is read back to the host between
launches.  The first scan step of a tile adds to nothing (the lifted point
itself) and, in the affine round, its second step adds two affine points:
that step runs as K6, which equals ``add_mixed`` of the lifted first point
in every branch.  The fixed-base multiply starts its window scan the same
way.
"""

from __future__ import annotations

import functools

import torch

from ..ff import host_field as hf
from ..ff import params as P
from ..ff.fp_torch import field
from . import curve_torch as ct
from . import host_curve as hc
from .jac_curve import JacCurve

#: window bits of the Pippenger MSM (``msm_tpu.MSM_WINDOW_C``)
MSM_WINDOW_C = 8
#: window bits of the fixed-base table (``msm_tpu.FIXED_BASE_WINDOW_C``)
FIXED_BASE_WINDOW_C = 5
#: lanes per fixed-base chunk (``TpuSnarkBase.BATCH_MUL_CHUNK``)
BATCH_MUL_CHUNK = 16384
#: a window's entries below which the tiled rounds stop
FINAL_WIDTH = 512


@functools.lru_cache(maxsize=None)
def curve(curve_name: str, g2: bool) -> JacCurve:
    return JacCurve(curve_name, g2)


def num_windows(nbits: int, c: int) -> int:
    return -(-nbits // c)


def scalar_digit_planes(scal: torch.Tensor, nbits: int, c: int):
    """(n, nl) int32 standard-form scalar limbs -> (W, n) int64 unsigned
    c-bit digits, most significant window first; window 0 holds the top
    nbits - c (W - 1) bits (``msm_tpu.scalar_digit_planes`` 134)."""
    if not 1 <= c <= 32:
        raise ValueError(f"scalar_digit_planes: c = {c} not in [1, 32]")
    W = num_windows(nbits, c)
    x = torch.nn.functional.pad(scal.to(torch.int64) & 0xFFFFFFFF, (0, 1))
    sh = c * torch.arange(W - 1, -1, -1, device=scal.device)
    k, o = sh // 32, sh % 32
    lo = x[:, k] >> o
    hi = x[:, k + 1] << (32 - o)
    return ((lo | hi) & ((1 << c) - 1)).T.contiguous()


def scalar_bit_planes(scal: torch.Tensor, nbits: int):
    """(nbits, n) 0/1 planes, MSB first (``msm_tpu.scalar_bit_planes``)."""
    return scalar_digit_planes(scal, nbits, 1)


# ---------------------------------------------------------------------------
# Pippenger
# ---------------------------------------------------------------------------


def _take(t: torch.Tensor, order: torch.Tensor) -> torch.Tensor:
    """Row gather per window: t (W, m, ...), order (W, m) -> t[w, order[w]]."""
    W, m = order.shape
    base = torch.arange(W, device=order.device).unsqueeze(1) * t.shape[1]
    return t.reshape(W * t.shape[1], *t.shape[2:])[(order + base).reshape(-1)
                                                   ].reshape(W, m,
                                                             *t.shape[2:])


def _run_flags(d: torch.Tensor, tile: int):
    """(start, is_end) flags of the digit runs of (W, m) sorted digits, cut
    at tile boundaries, as (W, T, tile) bool."""
    W, m = d.shape
    prev = torch.cat([d.new_full((W, 1), -1), d[:, :-1]], 1)
    nxt = torch.cat([d[:, 1:], d.new_full((W, 1), -2)], 1)
    start = (d != prev).view(W, m // tile, tile).clone()
    start[:, :, 0] = True
    is_end = (d != nxt).view(W, m // tile, tile).clone()
    is_end[:, :, -1] = True
    return start, is_end


def _compact(crv: JacCurve, d, scans, is_end, sentinel: int):
    """Keep the run ends, sorted to the front by digit (stable)."""
    W, m = d.shape
    keep = is_end.reshape(W, m)
    out_d = torch.where(keep, d, sentinel)
    out_p = crv.mask(scans, keep)
    out_d, order = torch.sort(out_d, dim=1, stable=True)
    return out_d, _take(out_p, order)


def _tile_reduce_mixed(crv: JacCurve, d, xy, inf, tile: int, sentinel: int):
    """First round over affine points (``_segment_tile_reduce_mixed``):
    (W, m) digits, (W, m, 2, *F) points, (W, m) infinity -> (digits,
    Jacobian partials), run ends first."""
    W, m = d.shape
    T = m // tile
    start, is_end = _run_flags(d, tile)
    # scan axis first, so that each step's operands are contiguous
    q = xy.reshape(W, T, tile, *xy.shape[2:]).movedim(2, 0).contiguous()
    qi = inf.reshape(W, T, tile).movedim(2, 0).contiguous()
    s = start.movedim(2, 0)
    scans = torch.empty(tile, W, T, 3, *crv.F.shape, dtype=torch.int32,
                        device=d.device)
    run = crv.lift(q[0], qi[0])  # O + q_0, the reference's first step
    scans[0] = run
    if tile > 1:
        run = crv.add_affine_affine(q[0], qi[0] | s[1], q[1], qi[1])
        scans[1] = run
    for k in range(2, tile):
        run = crv.add_mixed(crv.mask(run, ~s[k]), q[k], qi[k])
        scans[k] = run
    scans = scans.movedim(0, 2).reshape(W, m, 3, *crv.F.shape)
    return _compact(crv, d, scans, is_end, sentinel)


def _tile_reduce(crv: JacCurve, d, pts, tile: int, sentinel: int):
    """A later round over Jacobian partials (``_segment_tile_reduce``)."""
    W, m = d.shape
    T = m // tile
    start, is_end = _run_flags(d, tile)
    p = pts.reshape(W, T, tile, *pts.shape[2:]).movedim(2, 0).contiguous()
    s = start.movedim(2, 0)
    scans = torch.empty_like(p)
    run = p[0]  # O + p_0 = p_0 exactly
    scans[0] = run
    for k in range(1, tile):
        run = crv.add(crv.mask(run, ~s[k]), p[k])
        scans[k] = run
    scans = scans.movedim(0, 2).reshape(W, m, 3, *crv.F.shape)
    return _compact(crv, d, scans, is_end, sentinel)


def _pad(t: torch.Tensor, pad: int, value) -> torch.Tensor:
    fill = t.new_full((t.shape[0], pad, *t.shape[2:]), value)
    return torch.cat([t, fill], 1)


def msm_pippenger(crv: JacCurve, digits, xy, inf, c: int):
    """sum_i s_i P_i (``JacCurve.msm_pippenger``): (W, n) unsigned digits,
    most significant window first; (n, 2, *F.shape) affine points with an
    (n,) infinity mask -> one Jacobian point (3, *F.shape) on the device."""
    W, n = digits.shape
    sentinel = 1 << c
    d, order = torch.sort(digits, dim=1, stable=True)
    axy = xy[order]
    ainf = inf[order] | (d == 0)
    p = None  # Jacobian partials after the first round
    m = n
    while m > FINAL_WIDTH:
        tile = 64 if m >= 4096 else 8
        if m % tile:
            pad = -(-m // tile) * tile - m
            d = _pad(d, pad, sentinel)
            if p is None:
                axy, ainf = _pad(axy, pad, 0), _pad(ainf, pad, True)
            else:
                p = _pad(p, pad, 0)
            m += pad
        if p is None:
            d, p = _tile_reduce_mixed(crv, d, axy, ainf, tile, sentinel)
        else:
            d, p = _tile_reduce(crv, d, p, tile, sentinel)
        keep_len = min(m, max(FINAL_WIDTH, m // tile + sentinel + 2))
        d, p = d[:, :keep_len], p[:, :keep_len]
        if keep_len == m:
            break
        m = keep_len
    if p is None:
        p = crv.lift(axy, ainf)
    d = torch.where(d >= sentinel, 0, d)
    bits = torch.stack([(d >> (c - 1 - b)) & 1 for b in range(c)])
    partials = crv.msm(bits, p)  # (W, 3, *F.shape)
    # Horner over windows, most significant first; the reference's first
    # step, 2^c O + partial_0, is partial_0 exactly
    acc = partials[:1]
    for w in range(1, W):
        acc = crv.add(crv.dbl_chain(acc, c), partials[w: w + 1])
    return acc[0]


def msm(curve_name: str, g2: bool, scal, xy, inf, c: int = MSM_WINDOW_C):
    """sum_i scal[i] * P_i -> host affine point (None for the identity),
    with the arguments of ``msm.msm``: (n, nl) int32 standard-form scalar
    limbs, (n, 2, *F.shape) affine Montgomery points, (n,) infinity mask,
    all on one device."""
    n = xy.shape[0]
    if scal.shape[0] != n or inf.shape[0] != n:
        raise ValueError("msm_jac: scalars, points and mask differ in length")
    crv = curve(curve_name, g2)
    digits = scalar_digit_planes(
        scal, P.CURVES[curve_name].r.bit_length(), c)
    acc = msm_pippenger(crv, digits, xy.contiguous(), inf, c)
    return crv.to_affine_host(acc)[0]


def _pack_host(curve_name: str, g2: bool, scalars, points, device):
    r = P.CURVES[curve_name].r
    F = curve(curve_name, g2).F
    xy, inf = ct.pack_affine(F, list(points), device)
    return field(r).pack([s % r for s in scalars], device), xy, inf


def msm_g1_pippenger(curve_name: str, scalars, points, c: int = MSM_WINDOW_C,
                     device=None):
    """Host ints and affine points -> host affine sum
    (``msm_tpu.msm_g1_pippenger`` 285)."""
    from ..utils.device import resolve

    scal, xy, inf = _pack_host(curve_name, False, scalars, points,
                               resolve(device))
    return msm(curve_name, False, scal, xy, inf, c)


def msm_g2_pippenger(curve_name: str, scalars, points, c: int = MSM_WINDOW_C,
                     device=None):
    """As ``msm_g1_pippenger`` in G2 (``msm_tpu.msm_g2_pippenger`` 294)."""
    from ..utils.device import resolve

    scal, xy, inf = _pack_host(curve_name, True, scalars, points,
                               resolve(device))
    return msm(curve_name, True, scal, xy, inf, c)


def _msm_bits(curve_name: str, g2: bool, scalars, points, device):
    from ..utils.device import resolve

    crv = curve(curve_name, g2)
    scal, xy, inf = _pack_host(curve_name, g2, scalars, points,
                               resolve(device))
    bits = scalar_bit_planes(scal, P.CURVES[curve_name].r.bit_length())
    return crv.to_affine_host(crv.msm(bits, crv.lift(xy, inf)))[0]


def msm_g1(curve_name: str, scalars, points, device=None):
    """Bit-serial MSM (``msm_tpu.msm_g1`` 113): r.bit_length() planes, each
    a tree sum of the points, so it holds that many times the points."""
    return _msm_bits(curve_name, False, scalars, points, device)


def msm_g2(curve_name: str, scalars, points, device=None):
    """As ``msm_g1`` in G2 (``msm_tpu.msm_g2`` 121)."""
    return _msm_bits(curve_name, True, scalars, points, device)


# ---------------------------------------------------------------------------
# fixed-base scalar multiplication (the trusted setup)
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def fixed_base_host_table(curve_name: str, g2: bool, base, c: int) -> list:
    """rows[j][d] = d 2^(jc) base as host affine points (None at d = 0),
    row 0 the least significant window (``_fixed_base_host_table`` 172).
    Built in Jacobian coordinates and converted with one batched
    inversion: an affine add per entry costs a field inversion, seconds
    for a BW6-761 table."""
    crv = hc.g2_curve(curve_name) if g2 else hc.g1_curve(curve_name)
    H = crv.F
    rows = []
    p = crv.to_jacobian(base)
    for _ in range(num_windows(P.CURVES[curve_name].r.bit_length(), c)):
        row = [None, p]
        for _d in range(2, 1 << c):
            row.append(crv.jac_add(row[-1], p))
        rows.append(row)
        for _ in range(c):
            p = crv.jac_dbl(p)
    flat = [pt for row in rows for pt in row]
    zinv = hf.batch_inverse(H, [H.zero() if pt is None else pt[2]
                                for pt in flat])
    aff = []
    for pt, zi in zip(flat, zinv):
        if pt is None:
            aff.append(None)
            continue
        zi2 = H.sqr(zi)
        aff.append((H.mul(pt[0], zi2), H.mul(pt[1], H.mul(zi2, zi))))
    D = 1 << c
    return [aff[j * D: (j + 1) * D] for j in range(len(rows))]


@functools.lru_cache(maxsize=8)
def fixed_base_device_table(curve_name: str, g2: bool, base, c: int,
                            device: str):
    """((W, 2^c, 2, *F.shape) affine table, (W, 2^c) infinity mask) on the
    device (``_fixed_base_device_table`` 192)."""
    rows = fixed_base_host_table(curve_name, g2, base, c)
    F = curve(curve_name, g2).F
    xy, inf = ct.pack_affine(F, [pt for row in rows for pt in row], device)
    W, D = len(rows), 1 << c
    return xy.reshape(W, D, 2, *F.shape), inf.reshape(W, D)


def fixed_base(crv: JacCurve, digits, txy, tinf):
    """(W, N) digits, least significant window first, against the window
    table -> (N, 3, *F.shape) Jacobian points (``fixed_base_jit`` 218: one
    mixed add per window from infinity).  The first window is the lifted
    table point and the second one K6 add; the rest are K4 launches."""
    W = digits.shape[0]
    acc = crv.lift(txy[0][digits[0]], tinf[0][digits[0]])
    if W > 1:
        acc = crv.add_affine_affine(txy[0][digits[0]], tinf[0][digits[0]],
                                    txy[1][digits[1]], tinf[1][digits[1]])
    for j in range(2, W):
        acc = crv.add_mixed(acc, txy[j][digits[j]], tinf[j][digits[j]])
    return acc


def fixed_base_mul_batch(curve_name: str, g2: bool, scal, base,
                         c: int = FIXED_BASE_WINDOW_C):
    """[k_i] base for the (N, nl) standard-form scalar limbs ``scal`` on
    their device -> (N, 3, *F.shape) Jacobian points
    (``fixed_base_mul_batch`` 246)."""
    digits = scalar_digit_planes(
        scal, P.CURVES[curve_name].r.bit_length(), c).flip(0)
    txy, tinf = fixed_base_device_table(curve_name, g2, base, c,
                                        str(scal.device))
    return fixed_base(curve(curve_name, g2), digits, txy, tinf)


def batch_mul(curve_name: str, g2: bool, bits, base_batch):
    """Per-lane double-and-add (``batch_mul_jit`` 262): (nb, N) bits, MSB
    first, and (N, 3, *F.shape) Jacobian bases -> [k_i] base_i."""
    crv = curve(curve_name, g2)
    acc = crv.infinity_like(base_batch)
    for row in bits:
        acc = crv.dbl(acc)
        acc = crv.select(row > 0, crv.add(acc, base_batch), acc)
    return acc
