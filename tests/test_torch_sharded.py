"""The port's sharded MSMs, prover cores and mesh prover
(zecale_tpu_torch/parallel/{mesh,sharded}.py, Groth16Torch.prove(mesh=))
on CPU meshes, where every kernel wrapper takes its plain version, against
the host oracles (host_curve.msm, domain_host) and the port's
single-device engines and prover.  The `cuda` test holds a 4-shard mesh on
cuda:0 against a CPU mesh (the QAP division) and the host oracle (the
three sharded MSMs).  Tier 1 runs the mesh prover (msm4_sharded and
msm8_sharded at 8 shards, through the H MSM) and the mesh's own tests;
the engine x shard-count sweeps, the other groups, the prover cores and
the jac prove are `slow`: each shard's fold is ~r.bit_length() plain
doublings of 11-50 ms each on one CPU thread, so a case takes 6-50 s.
Tolerance: exact (group elements and field values)."""

import random

import numpy as np
import pytest
import torch

from zecale_tpu_torch.ec import curve_torch as ct
from zecale_tpu_torch.ec import host_curve as hc
from zecale_tpu_torch.ec import msm, msm8, msm_jac
from zecale_tpu_torch.ff import params as P
from zecale_tpu_torch.ff.fp_torch import field
from zecale_tpu_torch.parallel import fft_dist, sharded
from zecale_tpu_torch.parallel.mesh import Mesh, make_mesh
from zecale_tpu_torch.poly import domain_host, fft_torch
from zecale_tpu_torch.snark import groth16_torch as gt
from zecale_tpu_torch.snark import setup_native
from zecale_tpu_torch.snark.groth16 import Groth16
from zecale_tpu_torch.snark.r1cs import R1CS

# One intra-op thread: the suite runs in several worker processes at
# once, and torch's OpenMP threads spinning in each of them slow every
# worker many times over.
torch.set_num_threads(1)

CURVE = "bls12-377"
R = P.CURVES[CURVE].r


def _cpu_mesh(D):
    return make_mesh(D, devices=["cpu"] * D)


def _scalars(r, n, seed):
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 1 << 62, size=(n, 7), dtype=np.int64)
    return [int(sum(int(w) << (62 * i) for i, w in enumerate(row))) % r
            for row in words]


def _case(curve, g2, n, seed):
    """n points P_i = 2 P_(i-1) + G and scalars < r: zero scalars at 0 and
    n/2 + 1, points at infinity at 3 and n/2 + 2, the last eighth of the
    points at infinity and the eighth before it with zero scalars (at
    8 shards, one shard all identity and one all zero)."""
    crv = hc.g2_curve(curve) if g2 else hc.g1_curve(curve)
    gen = hc.generators(curve)[1 if g2 else 0]
    pts, p = [], gen
    for _ in range(n):
        pts.append(p)
        p = crv.add(crv.dbl(p), gen)
    r = P.CURVES[curve].r
    scalars = _scalars(r, n, seed)
    e = n // 8
    for i in (0, n // 2 + 1, *range(n - 2 * e, n - e)):
        scalars[i] = 0
    for i in (3, n // 2 + 2, *range(n - e, n)):
        pts[i] = None
    xy, inf = ct.pack_affine(ct.coord_field(curve, g2), pts, "cpu")
    return {"scalars": scalars, "pts": pts, "scal": field(r).pack(scalars),
            "xy": xy, "inf": inf, "want": crv.msm(scalars, pts)}


@pytest.fixture(scope="module")
def g1_case():
    return _case(CURVE, False, 256, 1)


def _run(engine, curve, g2, mesh, case, c):
    nbits = P.CURVES[curve].r.bit_length()
    if engine == "msm4":
        pt = sharded.msm4_sharded(curve, mesh, case["scal"], case["xy"],
                                  case["inf"], g2=g2, c=c)
    elif engine == "msm8":
        pt = sharded.msm8_sharded(curve, mesh, case["scal"], case["xy"],
                                  case["inf"], c, g2=g2)
    else:
        digits = msm_jac.scalar_digit_planes(case["scal"], nbits, c)
        pt = sharded.msm_sharded(curve, mesh, digits, case["xy"],
                                 case["inf"], c, g2=g2)
    assert pt.shape == (3, *ct.coord_field(curve, g2).shape)
    return sharded.point_to_host(curve, g2, pt)


def _single(engine, curve, g2, case, c):
    args = (curve, g2, case["scal"], case["xy"], case["inf"], c)
    return {"msm4": msm.msm, "msm8": msm8.msm8, "jac": msm_jac.msm}[engine](
        *args)


@pytest.mark.slow
@pytest.mark.parametrize("D", [1, 2, 4, 8])
@pytest.mark.parametrize("engine", ["msm4", "msm8", "jac"])
def test_sharded_msm_matches_host_oracle(g1_case, engine, D):
    """BLS12-377 G1, n = 256, zero scalars and points at infinity; at 8
    shards one shard is all identity and one all zero scalars."""
    c = 5 if engine != "msm4" else 0
    assert _run(engine, CURVE, False, _cpu_mesh(D), g1_case, c) == \
        g1_case["want"]


@pytest.mark.slow
@pytest.mark.parametrize("engine", ["msm4", "msm8", "jac"])
def test_sharded_msm_matches_single_device_engine(g1_case, engine):
    c = 6
    want = _single(engine, CURVE, False, g1_case, c)
    assert want == g1_case["want"]
    assert _run(engine, CURVE, False, _cpu_mesh(4), g1_case, c) == want


@pytest.mark.slow
@pytest.mark.parametrize("engine", ["msm4", "msm8", "jac"])
@pytest.mark.parametrize("curve,g2", [("bw6-761", False), (CURVE, True)])
def test_sharded_msm_other_groups(curve, g2, engine):
    """BW6-761 G1 (Fq 24 limbs) and BLS12-377 G2 (Fq2), n = 256, 4 shards."""
    case = _case(curve, g2, 256, 2)
    assert _run(engine, curve, g2, _cpu_mesh(4), case, 5) == case["want"]


@pytest.mark.slow
def test_msm_projective_matches_the_host_fold():
    """msm4's MSM folded on the device (the partial msm4_sharded takes)
    equals ``msm.msm``, which folds on the host."""
    case = _case(CURVE, False, 64, 8)
    pt = msm.msm_projective(CURVE, False, case["scal"], case["xy"],
                            case["inf"])
    assert pt.shape == (1, 3, 12)
    F = ct.coord_field(CURVE, False)
    assert ct.to_affine_host(F, pt)[0] == case["want"]
    assert msm.msm(CURVE, False, case["scal"], case["xy"],
                   case["inf"]) == case["want"]


def test_msm4_sharded_refuses_a_ragged_split():
    """The reference asserts n % D == 0 (``sharded.py:171``)."""
    case = _case(CURVE, False, 16, 7)
    with pytest.raises(ValueError, match="divide"):
        sharded.msm4_sharded(CURVE, _cpu_mesh(3), case["scal"], case["xy"],
                             case["inf"])


@pytest.mark.parametrize("inverse", [False, True])
def test_fft_sharded_matches_fft_torch(inverse):
    F = field(R)
    x = F.pack_mont(_scalars(R, 64, 5))
    mesh = _cpu_mesh(4)
    got = sharded.fft_sharded(mesh, x, R, inverse=inverse)
    assert len(got) == 4 and all(g.shape == (16, F.n) for g in got)
    assert torch.equal(mesh.gather(got), fft_torch.fft(x, R, inverse))


def _abc(n, seed):
    F = field(R)
    vals = [_scalars(R, n, seed + k) for k in range(3)]
    return vals, [F.pack_mont(v) for v in vals]


@pytest.mark.slow
def test_prove_core_sharded8_matches_single_device():
    n, c = 16, 4
    F = field(R)
    _, (az, bz, cz) = _abc(n, 30)
    case = _case(CURVE, False, n, 3)
    rev = fft_dist.bitrev_permutation(n)
    idx = torch.from_numpy(rev.astype(np.int64))
    mesh = _cpu_mesh(2)
    zinv = F.pack_mont([domain_host.domain(n, R)
                        .vanishing_on_coset_inverse()])[0]
    h_sh, pt = sharded.prove_core_sharded8(
        CURVE, mesh, az, bz, cz, zinv,
        {"xy": case["xy"][idx], "inf": case["inf"][idx]}, c)
    single = fft_torch.h_pipeline(az, bz, cz, R)
    assert torch.equal(mesh.gather(h_sh), single[idx])
    h_vals = F.unpack_mont(single)
    assert sharded.point_to_host(CURVE, False, pt) == hc.g1_curve(
        CURVE).msm(h_vals, case["pts"])


@pytest.mark.slow
def test_prove_core_sharded_matches_single_device():
    n, c = 16, 4
    F = field(R)
    _, (az, bz, cz) = _abc(n, 40)
    case = _case(CURVE, False, n, 4)
    mesh = _cpu_mesh(2)
    zinv = F.pack_mont([domain_host.domain(n, R)
                        .vanishing_on_coset_inverse()])[0]
    digits = msm_jac.scalar_digit_planes(case["scal"], R.bit_length(), c)
    h_sh, pt = sharded.prove_core_sharded(
        CURVE, mesh, az, bz, cz, zinv, digits,
        {"xy": case["xy"], "inf": case["inf"]}, c)
    assert torch.equal(mesh.gather(h_sh), fft_torch.h_pipeline(az, bz, cz,
                                                                R))
    assert sharded.point_to_host(CURVE, False, pt) == case["want"]


# ---------------------------------------------------------------------------
# the mesh route of the prover
# ---------------------------------------------------------------------------


def _squaring_chain(k=10):
    """y = x^(2^k), public (y, x): qap_degree 16, which 8 shards divide
    (``tests/test_sharded.py:147``)."""
    r1cs = R1CS(r=R, num_primary=2, num_aux=k - 1)
    r1cs.add_constraint([(2, 1)], [(2, 1)], [(3, 1)])
    for i in range(1, k - 1):
        r1cs.add_constraint([(2 + i, 1)], [(2 + i, 1)], [(3 + i, 1)])
    r1cs.add_constraint([(k + 1, 1)], [(k + 1, 1)], [(1, 1)])
    x = 3
    asg = [1, pow(x, 1 << k, R), x]
    cur = x
    for _ in range(k - 1):
        cur = cur * cur % R
        asg.append(cur)
    assert r1cs.is_satisfied(asg)
    return r1cs, asg


@pytest.fixture(scope="module")
def chain():
    r1cs, asg = _squaring_chain()
    assert r1cs.qap_degree == 16
    kp = setup_native.generate_setup(CURVE, r1cs, random.Random(5))
    prover = gt.Groth16Torch(CURVE, device="cpu", engine="msm4")
    single = prover.prove(r1cs, kp.pk, asg, random.Random(9))
    return r1cs, asg, kp, single


@pytest.mark.parametrize("engine", ["msm4", "msm8"])
def test_prove_with_mesh_gives_the_single_device_proof(chain, engine):
    r1cs, asg, kp, single = chain
    prover = gt.Groth16Torch(CURVE, device="cpu", engine=engine)
    dpk = prover.pack_pk(kp.pk, r1cs.num_primary + 1)
    timings = {}
    proof = prover.prove(r1cs, kp.pk, asg, random.Random(9), device_pk=dpk,
                         timings=timings, mesh=_cpu_mesh(8))
    assert proof == single
    assert Groth16(CURVE).verify(asg[1: 1 + r1cs.num_primary], proof, kp.vk)
    # the mesh route ran: the permuted H query is cached on the key
    deg, q = dpk.h_query_rev
    rev = fft_dist.bitrev_permutation(deg).astype(np.int64)
    assert deg == 16
    assert torch.equal(q["xy"], dpk.h_query["xy"][:deg][rev])
    # the padding at infinity lands where rev[i] = deg - 1
    assert bool(q["inf"][int(np.nonzero(rev == deg - 1)[0][0])])
    assert set(timings) == {"witness", "fft", "digitize", "msm", "assembly"}


def test_mesh_route_rule():
    """``groth16_tpu.py:465-469``: more than one shard, a degree that
    divides into them, and an engine with a sharded H MSM."""
    m8, m3, m1 = _cpu_mesh(8), _cpu_mesh(3), _cpu_mesh(1)
    assert gt.mesh_route("msm4", 16, m8) and gt.mesh_route("msm8", 16, m8)
    assert not gt.mesh_route("jac", 16, m8)
    assert not gt.mesh_route("msm4", 16, m3)
    assert not gt.mesh_route("msm4", 16, m1)
    assert not gt.mesh_route("msm4", 16, None)


def test_prove_with_a_mesh_the_degree_does_not_divide(chain):
    r1cs, asg, kp, single = chain
    prover = gt.Groth16Torch(CURVE, device="cpu", engine="msm4")
    dpk = prover.pack_pk(kp.pk, r1cs.num_primary + 1)
    proof = prover.prove(r1cs, kp.pk, asg, random.Random(9), device_pk=dpk,
                         mesh=_cpu_mesh(3))
    assert proof == single
    assert dpk.h_query_rev is None


@pytest.mark.slow
def test_jac_prove_ignores_the_mesh(chain):
    r1cs, asg, kp, single = chain
    prover = gt.Groth16Torch(CURVE, device="cpu", engine="jac")
    dpk = prover.pack_pk(kp.pk, r1cs.num_primary + 1)
    proof = prover.prove(r1cs, kp.pk, asg, random.Random(9), device_pk=dpk,
                         mesh=_cpu_mesh(8))
    assert proof == single
    assert dpk.h_query_rev is None


# ---------------------------------------------------------------------------
# the mesh itself
# ---------------------------------------------------------------------------


def test_mesh_layout_and_collectives():
    mesh = _cpu_mesh(4)
    assert (mesh.size, mesh.local, mesh.first, mesh.transport) == \
        (4, 4, 0, "local")
    x = torch.arange(16 * 3, dtype=torch.int32).reshape(16, 3)
    xs = mesh.shard(x)
    assert [t[0, 0].item() for t in xs] == [0, 12, 24, 36]
    assert mesh.shard(xs) == xs
    assert torch.equal(mesh.gather(xs), x)
    cols = mesh.shard(x.T.contiguous(), axis=1)
    assert torch.equal(mesh.gather(cols, axis=1), x.T)
    stacked = mesh.all_gather([t[:1] for t in xs])
    assert len(stacked) == 4 and stacked[0].shape == (4, 1, 3)
    for dist in (1, 2):
        got = mesh.exchange(xs, dist)
        assert all(torch.equal(got[g], xs[g ^ dist]) for g in range(4))
    with pytest.raises(ValueError):
        mesh.exchange(xs, 4)
    with pytest.raises(ValueError):
        mesh.shard(x[:15])
    with pytest.raises(ValueError):
        _cpu_mesh(3).exchange(mesh.shard(x[:12].contiguous())[:3], 1)


def test_mesh_refuses_what_it_cannot_place():
    with pytest.raises(ValueError):
        make_mesh(4, devices=["cpu"] * 2)
    with pytest.raises(ValueError):
        Mesh([])


@pytest.mark.cuda
def test_mesh_on_one_card_matches_the_plain_versions():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    gpu = make_mesh(4, devices=["cuda:0"] * 4)
    cpu = _cpu_mesh(4)
    _, (az, bz, cz) = _abc(64, 50)
    got = fft_dist.h_pipeline_sharded(gpu, R, az, bz, cz)
    want = fft_dist.h_pipeline_sharded(cpu, R, az, bz, cz)
    assert torch.equal(gpu.gather(got).cpu(), cpu.gather(want))
    case = _case(CURVE, False, 64, 6)
    dev = {k: (v.cuda() if torch.is_tensor(v) else v)
           for k, v in case.items()}
    for engine in ("msm4", "msm8", "jac"):
        assert _run(engine, CURVE, False, gpu, dev, 5) == case["want"]
    pt = msm.msm_projective(CURVE, False, dev["scal"], dev["xy"], dev["inf"])
    assert ct.to_affine_host(ct.coord_field(CURVE, False), pt)[0] == \
        case["want"]
