"""The port's complete a=0 group law (zecale_tpu_torch/ec/curve_torch.py)
against the reference's lazy Pallas-kernel bodies ff/fp8q.py:proj_add_q /
proj_dbl_q, run as tests/test_fp8q.py runs them, and against the host
curve for the BW6-761 G2 twist (b3 = 12).  Tolerance: exact -- canonical
projective coordinates must be equal, not only the affine points."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zecale_tpu.ec import host_curve as hc
from zecale_tpu.ff import fp8, fp8q
from zecale_tpu.ff import params as P
from zecale_tpu_torch.ec import curve_torch as ct

# One intra-op thread: the suite runs in several worker processes at
# once, and torch's OpenMP threads spinning in each of them slow every
# worker many times over (a 13 s test took 695 s with four workers).
torch.set_num_threads(1)


def _multiples(crv, gen, k):
    pts, pt = [], gen
    for _ in range(k):
        pts.append(pt)
        pt = crv.dbl(pt)
    return pts


def _proj_ints(points):
    """Host affine points (or None) -> (x, y, z) int lists, z = 1 / 0."""
    xs = [0 if q is None else q[0] for q in points]
    ys = [1 if q is None else q[1] for q in points]
    zs = [0 if q is None else 1 for q in points]
    return xs, ys, zs


def _pack_torch(F, points):
    xs, ys, zs = _proj_ints(points)
    return torch.stack(
        [F.pack_mont(xs), F.pack_mont(ys), F.pack_mont(zs)], dim=1
    )


def _canon_torch(F, t):
    """(k, 3, n) tensor -> canonical Montgomery ints per coordinate."""
    return [F.unpack(t[:, i, :]) for i in range(3)]


@pytest.mark.parametrize("curve,b3", [("bls12-377", 3), ("bw6-761", -3)])
def test_rcb_add_dbl_match_lazy_reference(curve, b3):
    cp = P.CURVES[curve]
    F8 = fp8.field8(cp.q)
    tc = dict(F8.tc)
    tc.update(fp8q.make_qconsts(F8))
    Q = fp8q.QOps(tc)
    crv = hc.g1_curve(curve)
    pts = _multiples(crv, hc.generators(curve)[0], 6)
    lhs = [pts[0], pts[1], None, pts[2], pts[3], pts[5]]
    rhs = [pts[1], pts[1], pts[4], None, crv.neg(pts[3]), pts[5]]

    def pack8(points):
        xs, ys, zs = _proj_ints(points)
        pk = lambda vs: jnp.asarray(np.asarray(F8.pack(vs, mont=True))).T
        return {"x": pk(xs), "y": pk(ys), "z": pk(zs)}

    def canon8(pd):
        # lazy outputs lie in [0, 4p): reduce to canonical Montgomery ints
        out = []
        for k in ("x", "y", "z"):
            rows = np.asarray(pd[k]).T.astype(np.int64)
            out.append([
                int.from_bytes(bytes(int(b) for b in row), "little") % cp.q
                for row in rows
            ])
        return out

    F = ct.base_field(curve)
    assert ct.b3_of(curve, False) == b3
    a, b = _pack_torch(F, lhs), _pack_torch(F, rhs)

    got = _canon_torch(F, ct.proj_add(F, a, b, b3))
    assert got == canon8(fp8q.proj_add_q(Q, pack8(lhs), pack8(rhs), b3))
    got = _canon_torch(F, ct.proj_dbl(F, a, b3))
    assert got == canon8(fp8q.proj_dbl_q(Q, pack8(lhs), b3))

    # the mixed add (affine q, never the identity) equals the full add
    keep = [i for i, q in enumerate(rhs) if q is not None]
    mixed = ct.proj_add_mixed(F, a[keep], b[keep][:, :2, :], b3)
    assert torch.equal(mixed, ct.proj_add(F, a[keep], b[keep], b3))
    want = [crv.add(lhs[i], rhs[i]) for i in keep]
    assert ct.to_affine_host(F, mixed) == want


def test_rcb_b3_12_bw6_g2_matches_host():
    curve = "bw6-761"
    b3 = ct.b3_of(curve, True)
    assert b3 == 12
    crv = hc.g2_curve(curve)
    pts = _multiples(crv, hc.generators(curve)[1], 5)
    lhs = [pts[0], pts[1], None, pts[2], pts[3]]
    rhs = [pts[1], pts[1], pts[4], None, crv.neg(pts[3])]
    F = ct.base_field(curve)
    a, b = _pack_torch(F, lhs), _pack_torch(F, rhs)
    want = [crv.add(p, q) for p, q in zip(lhs, rhs)]
    assert ct.to_affine_host(F, ct.proj_add(F, a, b, b3)) == want
    assert ct.to_affine_host(F, ct.proj_dbl(F, a, b3)) == [
        crv.dbl(p) for p in lhs
    ]
    keep = [0, 1, 2, 4]
    mixed = ct.proj_add_mixed(F, a[keep], b[keep][:, :2, :], b3)
    assert ct.to_affine_host(F, mixed) == [want[i] for i in keep]


def test_b3_of_refuses_extension_field_g2():
    """BLS12-377 G2 (Fq2) now has its twist constant b3 = (0, -3/5); the
    extension-field G2 groups of the MNT curves (a != 0) are still
    refused, as is their G1."""
    q = P.BLS12_377_Q
    b3 = ct.b3_of("bls12-377", True)
    assert b3 == (0, (-3 * pow(5, q - 2, q)) % q)
    assert b3[1] * -5 % q == 3  # b3 * u = c1 u^2 = 3b with b = 1: b3 = 3/u
    assert ct.b3_of("bls12-377", False) == 3
    for curve in ("mnt4-298", "mnt6-298"):
        for g2 in (False, True):
            with pytest.raises(ValueError):
                ct.b3_of(curve, g2)
