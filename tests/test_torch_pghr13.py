"""The device PGHR13 prover, zecale_tpu_torch/snark/pghr13_torch.py, on the
CPU, where the kernels' wrappers take their plain versions: its QAP
pipeline (poly/fft_torch.qap_polys_pipeline) against the JAX package's
qap_polys_pipeline_jit, its setup and proofs against the port's host
Pghr13, Pghr13Native and the JAX package's Pghr13 from one rng state on
the BLS12-377 (G2 over Fq2) and BW6-761 dummy applications, and its
device key against the JAX package's pack_pk_pghr13.  Tolerance: exact -- limbs bit for bit, every
key and proof point equal."""

import functools
import random

import numpy as np
import pytest
import torch

from zecale_tpu.aggregator import dummy_app as ref_da
from zecale_tpu.ff import fp_jax
from zecale_tpu.ff import params as RP
from zecale_tpu.poly import fft_tpu
from zecale_tpu.snark import pghr13 as ref_pghr13
from zecale_tpu.snark import pghr13_tpu
from zecale_tpu_torch.aggregator import dummy_app as da
from zecale_tpu_torch.ff.fp_torch import field
from zecale_tpu_torch.snark.pghr13 import Pghr13, Pghr13Native
from zecale_tpu_torch.snark.pghr13_torch import (
    QUERIES, Pghr13Torch, from_reference_pk_pghr13, pack_pk_pghr13)

# One intra-op thread: the suite runs in several worker processes at
# once, and torch's OpenMP threads spinning in each of them slow every
# worker many times over.
torch.set_num_threads(1)

CURVES = ["bls12-377", "bw6-761"]
PK = ("a_query", "b_query", "c_query", "k_query", "h_query")
VK = ("a", "b", "c", "g", "gb1", "gb2", "z", "ic")
PROOF = ("a", "a_p", "b", "b_p", "c", "c_p", "h", "k")


def _fields(obj, names):
    return {k: getattr(obj, k) for k in names}


def _vals(n, r, seed):
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 1 << 62, size=(n, 7), dtype=np.int64)
    return [int(sum(int(w) << (62 * i) for i, w in enumerate(row))) % r
            for row in words]


@pytest.mark.parametrize("r, n", [(RP.BW6_761_R, 16), (RP.BW6_761_R, 1024),
                                  (RP.BLS12_377_R, 16)],
                         ids=["bw6-fr-16", "bw6-fr-1024", "bls12-fr-16"])
def test_qap_polys_pipeline_matches_jax(r, n):
    from zecale_tpu_torch.poly import fft_torch

    F, Fj = field(r), fp_jax.field(r)
    az, bz, cz = (_vals(n, r, n + k) for k in range(3))
    want = fft_tpu.qap_polys_pipeline_jit(n, r)(
        *(Fj.pack(v) for v in (az, bz, cz)))
    got = fft_torch.qap_polys_pipeline(
        *(F.pack_mont(v) for v in (az, bz, cz)), r)
    assert len(got) == 3
    for g, w in zip(got, want):
        assert F.unpack_mont(g) == Fj.unpack(w)
    assert F.unpack_mont(fft_torch.h_pipeline(
        *(F.pack_mont(v) for v in (az, bz, cz)), r)) == Fj.unpack(want[0])


@functools.lru_cache(maxsize=None)
def _run(curve):
    """Keypairs and proofs of the dummy app (a = 9) from one rng state:
    the device prover's, the port's host Pghr13's and Pghr13Native's (the
    C engine, chip_smoke.py's comparator) and the JAX package's host
    Pghr13's."""
    r1cs = da.dummy_app_r1cs(curve)
    ref_r1cs = ref_da.dummy_app_r1cs(curve)
    asg = da.dummy_app_assignment(curve, 9)
    out = {}
    for side, snark, cs in (("host", Pghr13(curve), r1cs),
                            ("native", Pghr13Native(curve), r1cs),
                            ("ref", ref_pghr13.Pghr13(curve), ref_r1cs)):
        kp = snark.generate_setup(cs, random.Random(31))
        out[side] = (kp, snark.prove(cs, kp.pk, asg, random.Random(32)))
    # the BLS12-377 proof from a device key packed beforehand, the BW6-761
    # one packing its own
    dev = Pghr13Torch(curve, device="cpu")
    kp = dev.generate_setup(r1cs, random.Random(31))
    dpk = dev.pack_pk(kp.pk) if curve == "bls12-377" else None
    timings = {}
    proof = dev.prove(r1cs, kp.pk, asg, random.Random(32), device_pk=dpk,
                      timings=timings)
    out["device"] = (kp, proof)
    out["timings"] = timings
    return out


@pytest.mark.parametrize("curve", CURVES)
def test_device_setup_equals_host_and_reference(curve):
    run = _run(curve)
    kps = {side: run[side][0] for side in ("device", "host", "native",
                                           "ref")}
    want = (_fields(kps["ref"].pk, PK), _fields(kps["ref"].vk, VK))
    for side in ("device", "host", "native"):
        assert (_fields(kps[side].pk, PK), _fields(kps[side].vk, VK)) == want
    assert len(kps["device"].pk.a_query) == da.dummy_app_r1cs(
        curve).num_variables + 3


@pytest.mark.parametrize("curve", CURVES)
def test_device_proof_equals_host_and_reference(curve):
    run = _run(curve)
    want = _fields(run["ref"][1], PROOF)
    for side in ("device", "host", "native"):
        assert _fields(run[side][1], PROOF) == want, side


@pytest.mark.parametrize("curve", CURVES)
def test_device_proof_verifies(curve):
    kp, proof = _run(curve)["device"]
    dev = Pghr13Torch(curve, device="cpu")
    assert dev.verify([9], proof, kp.vk)
    assert not dev.verify([10], proof, kp.vk)
    assert ref_pghr13.Pghr13(curve).verify([9], proof, kp.vk)


@pytest.mark.parametrize("curve", CURVES)
def test_prove_records_the_phases(curve):
    assert list(_run(curve)["timings"]) == ["witness", "fft", "digitize",
                                            "msm", "assembly"]


def _ref_arrays(dpk_ref):
    return {name: {c: np.asarray(getattr(dpk_ref, name)[c])
                   for c in ("x", "y", "z")} for name, _ in QUERIES}


@pytest.mark.parametrize("curve", CURVES)
def test_from_reference_pk_pghr13_equals_pack(curve):
    kp = _run(curve)["ref"][0]
    dpk_ref = pghr13_tpu.pack_pk_pghr13(curve, kp.pk)
    got = from_reference_pk_pghr13(_ref_arrays(dpk_ref), curve, "cpu")
    want = pack_pk_pghr13(curve, kp.pk, "cpu")
    assert (got.n_g1, got.n_g2) == (want.n_g1, want.n_g2)
    # every G1 query padded to next_pow2(max(|A|, |H|)), as the reference
    assert want.n_g1 == 1 << (max(len(kp.pk.a_query),
                                  len(kp.pk.h_query)) - 1).bit_length()
    for name, _ in QUERIES:
        for part in ("xy", "inf"):
            assert torch.equal(getattr(got, name)[part],
                               getattr(want, name)[part]), (name, part)


def test_from_reference_pk_pghr13_refuses_a_z_other_than_0_or_1():
    curve = "bw6-761"
    kp = _run(curve)["ref"][0]
    arrays = _ref_arrays(pghr13_tpu.pack_pk_pghr13(curve, kp.pk))
    arrays["k"]["z"] = arrays["k"]["z"].copy()
    arrays["k"]["z"][0, 0] ^= 1
    with pytest.raises(ValueError, match="query k"):
        from_reference_pk_pghr13(arrays, curve, "cpu")


def test_msm_device_refuses_packed_scalars_of_another_length():
    curve = "bls12-377"
    dev = Pghr13Torch(curve, device="cpu")
    dpk = pack_pk_pghr13(curve, _run(curve)["device"][0].pk, "cpu")
    with pytest.raises(ValueError, match="packed scalars"):
        dev.msm_device(False, dpk.a0, dev._scalars([1, 2], dpk.n_g1 // 2))


def test_mnt_curves_are_refused():
    with pytest.raises(ValueError, match="a = 0"):
        Pghr13Torch("mnt6-298", device="cpu")


@pytest.mark.slow
def test_device_prover_equals_pghr13_tpu():
    """Pghr13TPU itself (JAX on the CPU) against the port's device prover,
    as tests/test_tpu_kernels.py:160 drives it."""
    curve = "bls12-377"
    r1cs = ref_da.dummy_app_r1cs(curve)
    tpu = pghr13_tpu.Pghr13TPU(curve)
    kp = tpu.generate_setup(r1cs, random.Random(31))
    asg = ref_da.dummy_app_assignment(curve, 9)
    proof = tpu.prove(r1cs, kp.pk, asg, random.Random(32))
    dkp, dproof = _run(curve)["device"]
    assert (_fields(kp.pk, PK), _fields(kp.vk, VK)) == (
        _fields(dkp.pk, PK), _fields(dkp.vk, VK))
    assert _fields(proof, PROOF) == _fields(dproof, PROOF)
