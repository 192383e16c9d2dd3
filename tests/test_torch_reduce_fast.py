"""The redesigned bucket reduce and affine add (zecale_tpu_torch/csrc/
fast_kernels.cu: K1 bucket_reduce and K6 aff_add on the fast field core,
TPI lanes a segment or a point, the warp's shuffles and votes naming all
of it) and the wrappers' TPI table.

Here, without a card: the CPU build of the kernels' device code
(csrc/host_check.cpp zt_cpu_fast_reduce and zt_cpu_fast_aff_add; the 32
lanes of a warp run as coroutines that exchange words in the order a
warp's shuffles and votes would) against the plain PyTorch versions
(ec/msm.py bucket_reduce_ref, ec/curve_torch.py aff_add), in every form
and built TPI, and at Fq 12 and Fq 24 K1's sums against a fold of the JAX
package's jnp complete projective add (ec/msm8.py g1_pcurve8).  K1 cases,
as chip_smoke.py's: empty segments, single points of either sign, P+P,
P+(-P)+Q, a repeated point, random lengths up to msm.SEG, and a block in
which every warp at every TPI mixes segments of 0, 1 and 32 entries (the
warp's one trip count and the select); affine inputs by the mixed add,
then the partials as projective inputs by the full add; b3 = 3 (BLS12-377
G1), -3 (BW6-761 G1), 12 (BW6-761 G2) and the Fq2 twist constant.  K6
cases: each infinity flag (with nonzero x, y), P = Q, P = -Q, distinct
points, a warp that mixes a P = Q point with generic ones and one all at
infinity, and a batch that leaves the last warp part full.  On a card
(`cuda` marker): every built TPI of both kernels, and the wrappers' pick,
against the plain versions.  Tolerance: exact -- limbs must be equal.

The JAX references are imported inside the test that uses them, so that
the file collects on the card's machine, which has no JAX."""

import random

import numpy as np
import pytest
import torch

from zecale_tpu.ec import host_curve as hc
from zecale_tpu_torch.ec import curve_torch as ct
from zecale_tpu_torch.ec import jac_curve as jc
from zecale_tpu_torch.ec import msm
from zecale_tpu_torch.ff import fp_torch as ft
from zecale_tpu_torch.ff import params as P
from zecale_tpu_torch.utils import build

# One intra-op thread: the suite runs in several worker processes at
# once, and torch's OpenMP threads spinning in each of them slow every
# worker many times over (a 13 s test took 695 s with four workers).
torch.set_num_threads(1)

#: one group per kernel form: fq12, fq24, fq2
FORMS = {"fq12": ("bls12-377", False), "fq24": ("bw6-761", False),
         "fq2": ("bls12-377", True)}
CODE = {"fq12": 12, "fq24": 24, "fq2": 2}
CASES = [(form, t) for form in FORMS for t in build.ADD_TPIS[form]]
D = 24  # distinct points the segments draw on


def _host(curve, g2):
    return hc.g2_curve(curve) if g2 else hc.g1_curve(curve)


def _points(curve, g2, n):
    crv = _host(curve, g2)
    gen = hc.generators(curve)[1 if g2 else 0]
    pts, p = [], gen
    for _ in range(n):
        pts.append(p)
        p = crv.add(crv.dbl(p), gen)
    return pts


def _segments(seed):
    """Entry lists: first a block of 8 whose every warp at every TPI holds
    segments of 0, 1 and 32 entries (lengths 0, 1, 32, random, twice), then
    the crafted kinds."""
    rng = random.Random(seed)

    def ent():
        return 2 * rng.randrange(D) + rng.randrange(2)

    segs = []
    for _ in range(2):
        segs += [[], [ent()], [ent() for _ in range(msm.SEG)],
                 [ent() for _ in range(rng.randrange(2, msm.SEG))]]
    for i in range(18):
        a, b = rng.randrange(D), rng.randrange(D)
        segs.append([
            [], [ent()], [2 * a, 2 * a], [2 * a, 2 * a + 1, 2 * b],
            [2 * a] * rng.randrange(2, 9),
            [ent() for _ in range(rng.randrange(1, msm.SEG + 1))],
        ][i % 6])
    return segs


def _k1_inputs(curve, g2, seed):
    """(F, host points, affine rows, ent, seg, segments) for the affine
    case, then (partials' entries, offsets) for the projective one: the
    partials summed in segments of 0, 1, 4, 7 and 14, some negated."""
    F = ct.coord_field(curve, g2)
    pts = _points(curve, g2, D)
    xy, _ = ct.pack_affine(F, pts, "cpu")
    segs = _segments(seed)
    ent = torch.tensor([e for s in segs for e in s], dtype=torch.int32)
    seg = torch.tensor(np.cumsum([0] + [len(s) for s in segs]),
                       dtype=torch.int32)
    n = len(segs)
    e2 = torch.arange(n, dtype=torch.int32) * 2 + (
        torch.arange(n) % 3 == 0).int()
    s2 = torch.tensor([0, 0, 1, 5, 12, n], dtype=torch.int32)
    return F, pts, xy, ent, seg, segs, e2, s2


def _fast_reduce(form, tpi, F, pts, ent, seg, b3, affine):
    out = torch.empty((seg.numel() - 1, 3, *F.shape), dtype=torch.int32)
    rc = build.host_check_lib().zt_cpu_fast_reduce(
        CODE[form], tpi, int(affine), pts.data_ptr(), ent.data_ptr(),
        seg.data_ptr(), seg.numel() - 1, out.data_ptr(),
        ct.kernel_consts(F, b3)[3].ctypes.data)
    assert rc == 0
    return out


def _check_k1(form, tpi, curve, g2, seed):
    """Both input forms of K1's CPU build equal the plain version; the
    affine partials are the host curve's segment sums."""
    b3 = ct.b3_of(curve, g2)
    F, pts, xy, ent, seg, segs, e2, s2 = _k1_inputs(curve, g2, seed)
    want = msm.bucket_reduce_ref(xy, ent, seg, F, b3, True)
    got = _fast_reduce(form, tpi, F, xy, ent, seg, b3, True)
    assert torch.equal(got, want)
    crv = _host(curve, g2)
    for s, pt in zip(segs, ct.to_affine_host(F, got)):
        acc = None
        for e in s:
            q = pts[e >> 1]
            acc = crv.add(acc, crv.neg(q) if e & 1 else q)
        assert pt == acc
    want2 = msm.bucket_reduce_ref(got, e2, s2, F, b3, False)
    assert torch.equal(_fast_reduce(form, tpi, F, got, e2, s2, b3, False),
                       want2)


@pytest.mark.parametrize("form,tpi", CASES)
def test_fast_k1_cpu_build_matches_plain(form, tpi):
    """K1 built by g++ in the form and TPI of a kernel variant, affine and
    projective inputs, gives the plain version's limbs."""
    curve, g2 = FORMS[form]
    _check_k1(form, tpi, curve, g2, 3 + tpi)


@pytest.mark.parametrize("tpi", build.ADD_TPIS["fq24"])
def test_fast_k1_bw6_g2_b3(tpi):
    """K1 over Fq 24 with b3 = 12 (BW6-761 G2): the b3 the launcher passes
    reaches every lane and every group."""
    assert ct.b3_of("bw6-761", True) == 12
    _check_k1("fq24", tpi, "bw6-761", True, 5)


def _aff_cases(curve, g2, seed):
    """((x, y), inf) operand lists for K6, 42 of them: 16 crafted cases,
    then 16 generic sums with P = Q at 17 and 26, then ten sums each with
    an infinity flag (whole warps of them at TPI 4 and 8), the last warp
    part full."""
    H = _host(curve, g2).F
    rng = random.Random(seed)
    pts = _points(curve, g2, 9)
    a = pts[0]
    neg_a = (a[0], H.neg(a[1]))

    def garbage():
        return (H.rand(rng), H.rand(rng))

    zero = (H.zero(), H.zero())
    lhs = [(garbage(), True), (garbage(), True), (a, False), (a, False),
           (a, False), (pts[1], False), (pts[2], False), (zero, True),
           (pts[4], False), (neg_a, False), (pts[3], False), (a, False),
           (garbage(), True), (pts[5], False), (pts[6], False),
           (pts[7], False)]
    rhs = [(pts[1], False), (garbage(), True), (garbage(), True), (a, False),
           (neg_a, False), (pts[5], False), (pts[6], False), (zero, True),
           (pts[4], False), (a, False), (pts[8], False), (zero, True),
           (neg_a, False), (pts[0], False), (pts[1], False), (pts[2], False)]
    for i in range(16, 32):
        p, q = pts[i % 9], pts[(i + 1 + i % 7) % 9]
        if i in (17, 26) or p == q:
            q = p
        lhs.append((p, False))
        rhs.append((q, False))
    for i in range(10):
        lhs.append((pts[i % 9], i % 3 != 1))
        rhs.append((garbage(), i % 3 != 0))
    return lhs, rhs


def _aff_to_torch(F, ops):
    flat = [c for pt, _ in ops for c in pt]
    xy = F.pack_mont(flat).reshape(len(ops), 2, *F.shape)
    return xy, torch.tensor([i for _, i in ops])


def _fast_aff(form, tpi, F, xa, ia, xb, ib):
    out = torch.empty(xa.shape[0], 3, *F.shape, dtype=torch.int32)
    rc = build.host_check_lib().zt_cpu_fast_aff_add(
        CODE[form], tpi, xa.data_ptr(), ia.data_ptr(), xb.data_ptr(),
        ib.data_ptr(), out.data_ptr(), xa.shape[0])
    assert rc == 0
    return out


@pytest.mark.parametrize("form,tpi", CASES)
def test_fast_k6_cpu_build_matches_plain(form, tpi):
    """K6 built by g++ in the form and TPI of a kernel variant gives the
    plain version's Jacobian triples, and the host curve's sums."""
    curve, g2 = FORMS[form]
    F = ct.coord_field(curve, g2)
    lhs, rhs = _aff_cases(curve, g2, 7 + tpi)
    xa, ia = _aff_to_torch(F, lhs)
    xb, ib = _aff_to_torch(F, rhs)
    got = _fast_aff(form, tpi, F, xa, ia, xb, ib)
    assert torch.equal(got, ct.aff_add(F, xa, ia, xb, ib))
    crv = _host(curve, g2)
    assert ct.jac_to_affine_host(F, got) == [
        crv.add(None if i else p, None if j else q)
        for (p, i), (q, j) in zip(lhs, rhs)]


def _to_ref(F8, xy, z):
    return {"x": F8.pack(xy[0]), "y": F8.pack(xy[1]), "z": F8.pack(z)}


@pytest.mark.parametrize("form", ["fq12", "fq24"])
def test_fast_k1_matches_jnp_proj_add_fold(form):
    """K1 at the largest built TPI, both input forms: the affine values of
    its segment sums equal a fold of the reference's jnp complete
    projective add (msm8.g1_pcurve8(...).add), one entry a step from the
    identity, through numpy."""
    import jax

    from zecale_tpu.ec import msm8 as ref_msm8

    curve, g2 = FORMS[form]
    crv8 = ref_msm8.g1_pcurve8(curve)
    H = _host(curve, g2).F
    b3 = ct.b3_of(curve, g2)
    tpi = build.ADD_TPIS[form][-1]
    F, pts, xy, ent, seg, segs, e2, s2 = _k1_inputs(curve, g2, 41)
    add = jax.jit(crv8.add)

    def fold(rows, lists):
        """rows: host (x, y, z) triples; lists: entries of each segment."""
        n = len(lists)
        ident = (H.zero(), H.one(), H.zero())
        acc = _to_ref(crv8.F, ([ident[0]] * n, [ident[1]] * n),
                      [ident[2]] * n)
        for j in range(max(map(len, lists))):
            q = []
            for s in lists:
                if j < len(s):
                    x, y, z = rows[s[j] >> 1]
                    q.append((x, H.neg(y) if s[j] & 1 else y, z))
                else:
                    q.append(ident)
            acc = add(acc, _to_ref(crv8.F, ([t[0] for t in q],
                                            [t[1] for t in q]),
                                   [t[2] for t in q]))
        cols = [crv8.F.unpack(np.asarray(acc[k])) for k in ("x", "y", "z")]
        return [None if H.is_zero(z) else (H.mul(x, H.inv(z)),
                                           H.mul(y, H.inv(z)))
                for x, y, z in zip(*cols)]

    got = _fast_reduce(form, tpi, F, xy, ent, seg, b3, True)
    rows = [(p[0], p[1], H.one()) for p in pts]
    assert ct.to_affine_host(F, got) == fold(rows, segs)
    vals = F.unpack_mont(got.reshape(-1, *F.shape))
    rows2 = [tuple(vals[3 * i: 3 * i + 3]) for i in range(got.shape[0])]
    cuts = s2.tolist()
    lists2 = [e2[a:b].tolist() for a, b in zip(cuts, cuts[1:])]
    got2 = _fast_reduce(form, tpi, F, got, e2, s2, b3, False)
    assert ct.to_affine_host(F, got2) == fold(rows2, lists2)


def test_sum_tpi_table_covers_every_form_and_count():
    """K1 (keyed by a launch's entries) and K6 (by its points) have rows
    for every form; each row's TPI is one that fast_kernels.cu is built
    for (ADD_TPIS); the bounds rise to a last row for any count; every
    count >= 1 gets a built variant."""
    assert set(build.SUM_TPI) == {"bucket_reduce", "aff_add"}
    assert set(build.KERNELS) == {"fast_kernels.cu"}
    variants = build.KERNELS["fast_kernels.cu"]["variants"]
    for kernel, table in build.SUM_TPI.items():
        assert set(table) == set(FORMS)
        for form, rows in table.items():
            bounds = [bnd for bnd, _ in rows]
            assert bounds[-1] is None and None not in bounds[:-1]
            assert bounds[:-1] == sorted(bounds[:-1])
            for _, tpi in rows:
                assert tpi in build.ADD_TPIS[form] and (form, tpi) in variants
            for n in [1, 2, 380, 2774, 4096, 16384, 19052, 49152, 87590,
                      262144, 262145, 2487636, 1 << 24] + bounds[:-1]:
                assert build.sum_tpi(kernel, form, n) in build.ADD_TPIS[form]


def test_sum_wrappers_refuse_another_field():
    """The fast kernels fix their prime at compile time: a field they were
    not built for (MNT4-298 Fq, 10 limbs) is refused before any build or
    launch, by K1's and K6's launch paths alike."""
    F = ft.field(P.CURVES["mnt4-298"].q)
    pts = torch.zeros(4, 2, F.n, dtype=torch.int32)
    ent = torch.zeros(4, dtype=torch.int32)
    seg = torch.tensor([0, 2, 4], dtype=torch.int32)
    with pytest.raises(ValueError, match="built for another field"):
        msm.launch_reduce(pts, ent, seg, F, 3, True, None)
    inf = torch.zeros(4, dtype=torch.bool)
    with pytest.raises(ValueError, match="built for another field"):
        jc.launch_aff(F, pts, inf, pts, inf, None)
    with pytest.raises(ValueError, match="must be contiguous int32"):
        msm.launch_reduce(pts, ent.long(), seg, F, 3, True, None)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("form", sorted(FORMS))
def test_cuda_k1_k6_every_tpi_match_plain(cuda_device, form):
    """Each built TPI of K1 (both input forms) and K6, and the wrappers'
    pick, equal the plain versions on the card."""
    curve, g2 = FORMS[form]
    b3 = ct.b3_of(curve, g2)
    F, _, xy, ent, seg, _, e2, s2 = _k1_inputs(curve, g2, 43)
    want = msm.bucket_reduce_ref(xy, ent, seg, F, b3, True)
    want2 = msm.bucket_reduce_ref(want, e2, s2, F, b3, False)
    d = [t.to(cuda_device) for t in (xy, ent, seg, want, e2, s2)]
    before = msm.bucket_reduce.launches
    assert torch.equal(msm.bucket_reduce(*d[:3], F, b3, True).cpu(), want)
    assert msm.bucket_reduce.launches == before + 1
    for t in build.ADD_TPIS[form]:
        assert torch.equal(
            msm.bucket_reduce_tpi(*d[:3], F, b3, True, t).cpu(), want)
        assert torch.equal(
            msm.bucket_reduce_tpi(*d[3:], F, b3, False, t).cpu(), want2)
    lhs, rhs = _aff_cases(curve, g2, 47)
    xa, ia = _aff_to_torch(F, lhs)
    xb, ib = _aff_to_torch(F, rhs)
    want = ct.aff_add(F, xa, ia, xb, ib)
    d = [t.to(cuda_device) for t in (xa, ia, xb, ib)]
    before = jc.aff_add.launches
    assert torch.equal(jc.aff_add(F, *d).cpu(), want)
    assert jc.aff_add.launches == before + 1
    for t in build.ADD_TPIS[form]:
        assert torch.equal(jc.aff_add_tpi(F, *d, t).cpu(), want)
