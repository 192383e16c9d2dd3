# Ported from scripts/rollup_e2e.py: the same steps 1-7, rng seeds and checks, with Groth16Torch as the prover.
"""Full zk-zk-rollup on the card -- the reference's SLOW
aggregator_test.cpp flow: a Zeth-style joinsplit (BLAKE2s PRFs and
commitments, a MiMC Merkle tree of depth 4, 2-in/2-out, 350,776
constraints, QAP domain 2^19) proved on BLS12-377 with ``Groth16Torch``,
then a batch of those proofs aggregated into one BW6-761 wrapper proof,
host-verified, with the primary-layout checks and the corrupt-joinsplit
negative case.

Steps, as the reference numbers them:

  1. the joinsplit circuit (rebuilt on every run: it holds witness
     closures, ~12 s);
  2. its trusted setup on the card (``Groth16Torch.generate_setup``);
  3. the proving key packed to the card once, then ``--batch`` joinsplit
     proofs (``make_test_joinsplit(Random(100 + i))``), each checked by
     the host verifier on the native pairing;
  4. the wrapper circuit ``AggregatorCircuit(1, batch)`` and its trusted
     setup on the card;
  5. the wrapping proof;
  6. its verification and the layout ``[vk_hash, 2^batch - 1, js_hash_0,
     ...]``;
  7. one joinsplit input corrupted: its result bit is 0 and the wrapper
     still verifies (the warm wrapper prove).

The keypairs are pickled in ``--cache`` (the temporary directory by
default), keyed by the rng state they were made from and a digest of the
circuit's R1CS; a loaded keypair restores the rng state its setup left, so
a cached run proves exactly what an uncached one does.  Both provers take
their engine as ``Groth16Torch`` does (msm4 unless ``ZECALE_USE_MSM8`` is
set).  There is no CPU fallback: without a GPU the default ``--device
cuda`` raises.

Usage: python -m zecale_tpu_torch.rollup_e2e [--batch 2] [--cache DIR]
    [--skip-negative] [--json PATH] [--device cuda|cpu]
Prints one ``E2E_JSON: {...}`` line and ends with
``FULL ZK-ZK-ROLLUP PASSED``.
"""

import argparse
import hashlib
import json
import os
import pickle
import random
import sys
import tempfile
import time


def r1cs_digest(r1cs) -> str:
    """A digest of the sizes and every A, B, C row of a constraint
    system (a few seconds for the joinsplit)."""
    h = hashlib.sha256(repr((r1cs.r, r1cs.num_primary, r1cs.num_aux))
                       .encode())
    for row in r1cs.constraints:
        h.update(repr(row).encode())
    return h.hexdigest()[:16]


def setup_cache_path(cache: str, name: str, r1cs, rng: random.Random) -> str:
    """The file cached_setup keeps ``name``'s keypair in, for ``r1cs`` and
    the rng state ``rng`` holds now."""
    key = hashlib.sha256(repr(rng.getstate()).encode()).hexdigest()[:16]
    return os.path.join(cache, f"{name}_{r1cs_digest(r1cs)}_{key}.pkl")


def cached_setup(cache: str, name: str, r1cs, rng: random.Random, setup):
    """``setup(r1cs, rng)`` -> keypair, pickled in ``cache`` under the rng
    state it starts from and the R1CS digest (setup_cache_path), with the
    rng state it leaves; a hit restores that state.  -> (keypair,
    loaded?)."""
    path = setup_cache_path(cache, name, r1cs, rng)
    if os.path.exists(path):
        with open(path, "rb") as f:
            kp, state = pickle.load(f)
        rng.setstate(state)
        return kp, True
    kp = setup(r1cs, rng)
    with open(path + ".tmp", "wb") as f:
        pickle.dump((kp, rng.getstate()), f)
    os.replace(path + ".tmp", path)
    return kp, False


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--cache", default=os.path.join(
        tempfile.gettempdir(), "zecale_tpu_torch_cache"))
    ap.add_argument("--skip-negative", action="store_true")
    ap.add_argument("--json", default="", help="write summary JSON here")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch

    from .aggregate_e2e import DeviceProver, _check
    from .aggregator.circuit import AggregatorCircuit
    from .snark.groth16 import ExtendedProof, Groth16
    from .snark.groth16_torch import Groth16Torch
    from .utils.device import resolve
    from .zeth.dev_vectors import make_test_joinsplit
    from .zeth.joinsplit import JoinsplitCircuit

    dev = resolve(args.device)
    os.makedirs(args.cache, exist_ok=True)
    print("device:", torch.cuda.get_device_name(dev)
          if dev.type == "cuda" else dev, flush=True)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    rng = random.Random(17)
    summary = {"batch": args.batch}
    if dev.type == "cuda":
        # the kernels build at their first launch: build them here, so that
        # the setup's seconds are the setup's
        from .utils import build

        t0 = time.time()
        build.cuda_kernels()
        summary["kernel_build_s"] = round(time.time() - t0, 2)
        print(f"[0] kernels built: {summary['kernel_build_s']}s", flush=True)

    # 1. the joinsplit circuit (the nested application)
    t0 = time.time()
    js_circ = JoinsplitCircuit()
    summary["joinsplit_circuit_s"] = round(time.time() - t0, 2)
    summary["joinsplit_constraints"] = js_circ.r1cs.num_constraints
    print(f"[1] joinsplit: {js_circ.r1cs.num_constraints} constraints, "
          f"domain {js_circ.r1cs.qap_degree} "
          f"({summary['joinsplit_circuit_s']}s)", flush=True)

    # 2. its trusted setup on the card (BLS12-377)
    nprover = Groth16Torch("bls12-377", device=dev)
    setup_t = {}
    t0 = time.time()
    nkp, hit = cached_setup(
        args.cache, "joinsplit_keypair", js_circ.r1cs, rng,
        lambda r1cs, r: nprover.generate_setup(r1cs, r, timings=setup_t))
    summary["joinsplit_setup_s"] = round(time.time() - t0, 2)
    summary["joinsplit_setup_phases"] = {
        k: round(v, 2) for k, v in setup_t.items()}
    print(f"[2] joinsplit trusted setup "
          f"({'loaded' if hit else 'on the card'}): "
          f"{summary['joinsplit_setup_s']}s "
          f"{summary['joinsplit_setup_phases']}", flush=True)

    # 3. joinsplit proofs on the card, the proving key packed once
    t0 = time.time()
    ndpk = nprover.pack_pk(nkp.pk, js_circ.r1cs.num_primary + 1)
    sync()
    summary["joinsplit_pack_pk_s"] = round(time.time() - t0, 2)
    print(f"[3] joinsplit pk packed to the device: "
          f"{summary['joinsplit_pack_pk_s']}s", flush=True)
    host_n = Groth16(js_circ.curve_name)
    js_prover = DeviceProver(nprover, ndpk)
    eps, js_runs = [], []
    for i in range(args.batch):
        t0 = time.time()
        js = make_test_joinsplit(random.Random(100 + i))
        ep = js_circ.prove(**js, pk=nkp.pk, rng=rng, prover=js_prover,
                           check=(i == 0))
        dt = time.time() - t0
        t0 = time.time()
        _check(host_n.verify(ep.inputs, ep.proof, nkp.vk),
               f"joinsplit proof {i} does not verify")
        vt = time.time() - t0
        js_runs.append({"prove_s": round(dt, 2), "verify_s": round(vt, 2),
                        "phases": {k: round(v, 2) for k, v in
                                   js_prover.last_timings.items()}})
        print(f"[3] joinsplit proof {i}: prove {dt:.1f}s, "
              f"host verify {vt:.1f}s", flush=True)
        eps.append(ep)
    summary["joinsplit_proves"] = js_runs

    # 4. the wrapper circuit (a batch of joinsplit proofs) and its setup
    t0 = time.time()
    wcirc = AggregatorCircuit(1, args.batch)
    summary["wrapper_circuit_s"] = round(time.time() - t0, 2)
    summary["wrapper_constraints"] = wcirc.r1cs.num_constraints
    print(f"[4] wrapper: {wcirc.r1cs.num_constraints} constraints "
          f"({summary['wrapper_circuit_s']}s)", flush=True)
    wprover = Groth16Torch("bw6-761", device=dev)
    wsetup_t = {}
    t0 = time.time()
    wkp, hit = cached_setup(
        args.cache, f"wrapper_keypair_b{args.batch}", wcirc.r1cs, rng,
        lambda r1cs, r: wprover.generate_setup(r1cs, r, timings=wsetup_t))
    summary["wrapper_setup_s"] = round(time.time() - t0, 2)
    print(f"[4] wrapper trusted setup "
          f"({'loaded' if hit else 'on the card'}): "
          f"{summary['wrapper_setup_s']}s", flush=True)
    t0 = time.time()
    wdpk = wprover.pack_pk(wkp.pk, wcirc.r1cs.num_primary + 1)
    sync()
    summary["wrapper_pack_pk_s"] = round(time.time() - t0, 2)
    print(f"[4] wrapper pk packed to the device: "
          f"{summary['wrapper_pack_pk_s']}s", flush=True)

    # 5. the wrapping proof
    w_prover = DeviceProver(wprover, wdpk)
    t0 = time.time()
    wep = wcirc.prove(nkp.vk, eps, wkp.pk, rng, prover=w_prover,
                      check=True)
    dt = time.time() - t0
    summary["wrap_cold_prove_s"] = round(dt, 2)
    summary["wrap_cold_phases"] = {
        k: round(v, 2) for k, v in w_prover.last_timings.items()}
    print(f"[5] ROLLUP WRAPPING PROOF generated: {dt:.1f}s "
          f"({args.batch / dt:.3f} aggregated joinsplits/s)", flush=True)

    # 6. verify + layout (vk hash, result bits, hashed joinsplit inputs)
    host_w = Groth16("bw6-761")
    t0 = time.time()
    ok = host_w.verify(wep.inputs, wep.proof, wkp.vk)
    print(f"[6] wrapper proof verifies: {ok} ({time.time() - t0:.1f}s)",
          flush=True)
    _check(ok, "wrapper proof does not verify")
    _check(wep.inputs[0] == wcirc.compute_nested_vk_hash(nkp.vk),
           "input 0 is not the joinsplit vk hash")
    _check(wep.inputs[1] == (1 << args.batch) - 1,
           "results are not all valid")
    for i in range(args.batch):
        _check(wep.inputs[2 + i] == eps[i].inputs[0],
               f"input {2 + i} is not joinsplit {i}'s hash")
    print("[6] primary layout [vk_hash, results, js_hashes...] OK",
          flush=True)

    warm = None
    if not args.skip_negative:
        # 7. corrupt one joinsplit input -> result bit 0, wrapper still
        # valid; the same packed key, so this is the warm wrapper prove
        bad = list(eps)
        bad[-1] = ExtendedProof(proof=bad[-1].proof,
                                inputs=[bad[-1].inputs[0] + 1])
        t0 = time.time()
        wep2 = wcirc.prove(nkp.vk, bad, wkp.pk, rng, prover=w_prover,
                           check=True)
        warm = time.time() - t0
        summary["wrap_warm_phases"] = {
            k: round(v, 2) for k, v in w_prover.last_timings.items()}
        _check(host_w.verify(wep2.inputs, wep2.proof, wkp.vk),
               "wrapper of a corrupt joinsplit does not verify")
        _check(wep2.inputs[1] == (1 << (args.batch - 1)) - 1,
               "corrupt joinsplit did not give result bit 0")
        print(f"[7] corrupt-joinsplit negative case OK ({warm:.1f}s, the "
              f"warm wrapper prove)", flush=True)

    summary["wrap_warm_prove_s"] = round(warm, 2) if warm else None
    summary["aggregated_joinsplits_per_s"] = round(
        args.batch / (warm or dt), 4)
    summary["joinsplit_prove_s"] = js_runs[-1]["prove_s"]
    print("E2E_JSON: " + json.dumps(summary), flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(summary, f)
    print("FULL ZK-ZK-ROLLUP PASSED", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
