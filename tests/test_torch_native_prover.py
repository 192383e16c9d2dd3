"""The port's host prover, zecale_tpu_torch/snark/groth16_native.py
(Groth16Native on the native C engine), against the JAX package's
snark/groth16_native.py: its native FFT on a basic and on an extended
domain, and its keypair and proof from one rng state on a small BW6-761
circuit and on a small MNT6-298 circuit forced onto an extended QAP
domain (the domain_host._override hook of tests/test_domains.py);
server_main's --prover native.  ``slow``: the MNT4-298 -> MNT6-298
recursion of tests/test_mnt_aggregation.py on the port, and server_main
--prover native --curve mnt6-298 serving one aggregation.
Tolerance: exact -- field elements and points equal."""

import pickle
import random
import types

import pytest
import torch

import zecale_tpu.poly.domain_host as ref_dh
from zecale_tpu.native import ec as ref_nec
from zecale_tpu.snark import groth16_native as ref_gn
from zecale_tpu.snark.r1cs import R1CS as RefR1CS
import zecale_tpu_torch.poly.domain_host as dh
from zecale_tpu_torch.api import server_main
from zecale_tpu_torch.ff import params as P
from zecale_tpu_torch.native import ec as nec
from zecale_tpu_torch.snark import groth16_native as gn
from zecale_tpu_torch.snark.r1cs import R1CS

# One intra-op thread: the suite runs in several worker processes at
# once, and torch's OpenMP threads spinning in each of them slow every
# worker many times over.
torch.set_num_threads(1)

MNT6_R = P.CURVES["mnt6-298"].r
BW6_R = P.CURVES["bw6-761"].r

needs_native = pytest.mark.skipif(
    not (nec.available() and ref_nec.available()),
    reason="native toolchain unavailable")


@needs_native
@pytest.mark.parametrize("where", ["basic", "extended"])
def test_native_fft_equals_the_jax_packages(where):
    r = MNT6_R if where == "extended" else BW6_R
    make = {"basic": lambda m: m.Radix2Domain(64, r),
            "extended": lambda m: m.ExtendedRadix2Domain(64, r, small_m=32)}
    d, ref_d = make[where](dh), make[where](ref_dh)
    assert getattr(d, "C", 1) == (2 if where == "extended" else 1)
    rng = random.Random(17)
    coeffs = [rng.randrange(r) for _ in range(64)]
    F, ref_F = nec.NativeScalarField(r), ref_nec.NativeScalarField(r)
    for inverse, host in ((False, d.fft), (True, d.ifft)):
        a = gn._native_fft(F, d, F.to_mont(coeffs), inverse)
        b = ref_gn._native_fft(ref_F, ref_d, ref_F.to_mont(coeffs), inverse)
        assert F.from_mont(a) == ref_F.from_mont(b) == host(coeffs)


def _circuit(r1cs_cls, r, rows):
    """x * y == z with z public, then ``rows`` padding rows x * 1 == x (as
    tests/test_domains.py builds it), and its satisfying assignment."""
    rng = random.Random(23)
    cs = r1cs_cls(r=r, num_primary=1, num_aux=2)
    cs.add_constraint([(2, 1)], [(3, 1)], [(1, 1)])
    for _ in range(rows):
        cs.add_constraint([(2, 1)], [(0, 1)], [(2, 1)])
    x, y = rng.randrange(r), rng.randrange(r)
    return cs, [1, x * y % r, x, y]


KEY = ("alpha_g1", "beta_g1", "beta_g2", "delta_g1", "delta_g2", "a_query",
       "b_g1_query", "b_g2_query", "l_query", "h_query")


@needs_native
@pytest.mark.parametrize("curve, rows, extended", [
    ("bw6-761", 20, False),
    ("mnt6-298", 40, True),
])
def test_keypair_and_proof_equal_the_jax_packages(curve, rows, extended):
    r = P.CURVES[curve].r
    cs, asg = _circuit(R1CS, r, rows)
    ref_cs, _ = _circuit(RefR1CS, r, rows)
    n = cs.qap_degree
    if extended:
        assert n == 64
        dh._override[(n, r)] = dh.ExtendedRadix2Domain(n, r, small_m=16)
        ref_dh._override[(n, r)] = ref_dh.ExtendedRadix2Domain(
            n, r, small_m=16)
    try:
        assert getattr(dh.domain(n, r), "C", 1) == (4 if extended else 1)
        out = {}
        for side, mod, circuit in (("port", gn, cs), ("ref", ref_gn, ref_cs)):
            prover = mod.Groth16Native(curve)
            rng = random.Random(5)
            kp = prover.generate_setup(circuit, rng)
            proof = prover.prove(circuit, kp.pk, asg, rng)
            assert prover.verify([asg[1]], proof, kp.vk)
            assert not prover.verify([(asg[1] + 1) % r], proof, kp.vk)
            out[side] = (kp, proof, rng.random())
    finally:
        dh._override.clear()
        ref_dh._override.clear()
    (kp, proof, after), (ref_kp, ref_proof, ref_after) = (out["port"],
                                                          out["ref"])
    for k in KEY:
        assert getattr(kp.pk, k) == getattr(ref_kp.pk, k), k
    assert (kp.vk.alpha, kp.vk.beta, kp.vk.delta, kp.vk.abc) == (
        ref_kp.vk.alpha, ref_kp.vk.beta, ref_kp.vk.delta, ref_kp.vk.abc)
    assert (proof.a, proof.b, proof.c) == (ref_proof.a, ref_proof.b,
                                           ref_proof.c)
    assert after == ref_after  # the same rng draws, in the same order


def _fake_keypair(path, n_abc):
    with open(path, "wb") as f:
        pickle.dump(types.SimpleNamespace(
            pk="pk", vk=types.SimpleNamespace(abc=list(range(n_abc)))), f)


@needs_native
def test_server_main_builds_the_native_prover(tmp_path):
    # batch 1, one input a proof: [vk_hash, results, input] + 1 abc points;
    # --prover native needs no device, so no --device is given
    path = str(tmp_path / "kp.bin")
    _fake_keypair(path, 4)
    svc, args = server_main.build_service(
        ["--batch-size", "1", "--prover", "native", "--keypair", path])
    assert type(svc.prover) is gn.Groth16Native
    assert svc.prover.curve_name == "bw6-761"
    assert args.prover == "native"


def test_server_main_native_prover_serves_groth16_only(capsys):
    with pytest.raises(SystemExit) as e:
        server_main.build_service(["--prover", "native", "--snark", "PGHR13"])
    assert e.value.code == 2
    assert "GROTH16 only" in capsys.readouterr().err


def test_server_main_help_names_the_native_prover():
    text = server_main.parser().format_help()
    assert "native" in text and "{host,native,torch}" in text


# ---------------------------------------------------------------------------
# slow: the MNT4-298 -> MNT6-298 wrapper
# ---------------------------------------------------------------------------


@needs_native
@pytest.mark.slow
def test_mnt_full_recursion_on_the_port():
    """tests/test_mnt_aggregation.py:33-58 on the port's modules."""
    from zecale_tpu_torch.aggregator import dummy_app as da
    from zecale_tpu_torch.aggregator.circuit import AggregatorCircuit
    from zecale_tpu_torch.ec import host_curve as hc
    from zecale_tpu_torch.snark.groth16 import ExtendedProof, Groth16Proof

    BATCH = 2
    rng = random.Random(13)
    _, nkp = da.dummy_app_setup("mnt4-298", rng)
    eps = [da.dummy_app_prove("mnt4-298", nkp, 5 + i, rng)
           for i in range(BATCH)]
    circ = AggregatorCircuit(1, BATCH, wrapper_curve="mnt6-298")
    prover = gn.Groth16Native("mnt6-298")
    wkp = prover.generate_setup(circ.r1cs, rng)

    wep = circ.prove(nkp.vk, eps, wkp.pk, rng, prover=prover, check=True)
    assert prover.verify(wep.inputs, wep.proof, wkp.vk)
    assert wep.inputs[0] == circ.compute_nested_vk_hash(nkp.vk)
    assert wep.inputs[1] == (1 << BATCH) - 1
    for i in range(BATCH):
        assert wep.inputs[2 + i] == 5 + i
    bad_in = list(wep.inputs)
    bad_in[2] = (bad_in[2] + 1) % prover.r
    assert not prover.verify(bad_in, wep.proof, wkp.vk)

    g1 = hc.g1_curve("mnt4-298")
    corrupt = ExtendedProof(
        proof=Groth16Proof(a=g1.dbl(eps[0].proof.a), b=eps[0].proof.b,
                           c=eps[0].proof.c),
        inputs=list(eps[0].inputs))
    wep2 = circ.prove(nkp.vk, [corrupt] + eps[1:], wkp.pk, rng,
                      prover=prover, check=True)
    assert prover.verify(wep2.inputs, wep2.proof, wkp.vk)
    assert wep2.inputs[1] == (1 << BATCH) - 2


@needs_native
@pytest.mark.slow
def test_server_main_native_serves_mnt6(tmp_path):
    """--prover native --curve mnt6-298: the native setup, written to the
    keypair file, then one aggregation of two MNT4-298 proofs, valid."""
    from zecale_tpu_torch.aggregator import dummy_app as da
    from zecale_tpu_torch.serialization import json_codec as jc

    path = str(tmp_path / "kp.bin")
    svc, _ = server_main.build_service(
        ["--batch-size", "2", "--prover", "native", "--curve", "mnt6-298",
         "--keypair", path])
    assert type(svc.prover) is gn.Groth16Native
    rng = random.Random(3)
    _, nkp = da.dummy_app_setup("mnt4-298", rng)
    svc.register_application("app", jc.groth16_vk_to_json("mnt4-298",
                                                          nkp.vk))
    for a in (5, 6):
        ep = da.dummy_app_prove("mnt4-298", nkp, a, rng)
        svc.submit_nested_transaction({
            "app_name": "app", "parameters": f"{a:02x}", "fee_in_wei": a,
            "extended_proof": jc.extended_proof_to_json("mnt4-298", ep)})
    agg = svc.generate_aggregated_transaction("app")
    ep = jc.extended_proof_from_json("mnt6-298", agg["ext_proof"])
    assert list(ep.inputs[1:]) == [3, 6, 5]
    assert svc.prover.verify(ep.inputs, ep.proof, svc.keypair.vk)
