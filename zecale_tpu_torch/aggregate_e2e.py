# Ported from scripts/aggregate_e2e.py: the same steps, checks and E2E_JSON keys, with Groth16Torch as the prover.
"""End-to-end aggregation on the card: nested proofs -> wrapper proof.

Runs the complete flow the reference exercises in its SLOW gtest suite
(aggregator_dummy_test.cpp): dummy-app setup + proofs on BLS12-377, wrapper
circuit setup on BW6-761, wrapping proof via the device prover
(``Groth16Torch``, engine msm4 unless ``ZECALE_USE_MSM8`` is set), host
verification of the wrapper proof, primary-input layout checks, settlement
through the dispatcher model, and the corrupt-proof negative case, whose
prove is the warm one.

The wrapper keypair comes from the native C setup where its engine builds,
else from the device setup, and is cached in ``--cache`` (the temporary
directory by default).  The circuit holds witness closures and cannot be
pickled, so it is rebuilt on every run.

Usage: python -m zecale_tpu_torch.aggregate_e2e [--batch 2] [--cache DIR]
    [--skip-negative] [--json PATH] [--device cuda|cpu]
"""

import argparse
import json
import os
import pickle
import random
import sys
import tempfile
import time


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

    from .aggregator import dummy_app as da
    from .aggregator.circuit import AggregatorCircuit
    from .contracts import dispatcher as dp
    from .native import ec as nec
    from .snark import setup_native
    from .snark.groth16 import ExtendedProof, Groth16
    from .snark.groth16_torch import Groth16Torch
    from .utils.device import resolve

    dev = resolve(args.device)
    os.makedirs(args.cache, exist_ok=True)
    print("device:", torch.cuda.get_device_name(dev)
          if dev.type == "cuda" else dev, flush=True)

    rng = random.Random(11)

    # 1. nested app proofs (tiny circuit -- host path is fine)
    t0 = time.time()
    _, nkp = da.dummy_app_setup("bls12-377", rng)
    eps = [da.dummy_app_prove("bls12-377", nkp, 7 + i, rng)
           for i in range(args.batch)]
    print(f"[1] nested setup+proofs: {time.time()-t0:.1f}s", flush=True)

    # 2. wrapper circuit (holds witness closures: rebuilt, never pickled)
    t0 = time.time()
    circ = AggregatorCircuit(1, args.batch)
    print(f"[2] circuit built: {time.time()-t0:.1f}s "
          f"({circ.r1cs.num_constraints} constraints)", flush=True)

    # 3. wrapper trusted setup (native C engine when available), cached
    prover = Groth16Torch("bw6-761", device=dev)
    kp_cache = os.path.join(
        args.cache,
        f"keypair_b{args.batch}_{circ.r1cs.num_constraints}.pkl")
    t0 = time.time()
    if os.path.exists(kp_cache):
        with open(kp_cache, "rb") as f:
            wkp = pickle.load(f)
        print(f"[3] keypair loaded: {time.time()-t0:.1f}s", flush=True)
    else:
        if nec.available():
            wkp = setup_native.generate_setup("bw6-761", circ.r1cs, rng)
            how = "native"
        else:
            wkp = prover.generate_setup(circ.r1cs, rng)
            how = "device"
        with open(kp_cache + ".tmp", "wb") as f:
            pickle.dump(wkp, f)
        os.replace(kp_cache + ".tmp", kp_cache)
        print(f"[3] trusted setup ({how}): {time.time()-t0:.1f}s",
              flush=True)

    # 4. device-resident pk
    t0 = time.time()
    dpk = prover.pack_pk(wkp.pk, circ.r1cs.num_primary + 1)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    print(f"[4] pk packed to device: {time.time()-t0:.1f}s", flush=True)

    # 5. wrapping proof on the device
    dev_prover = DeviceProver(prover, dpk)
    t0 = time.time()
    wep = circ.prove(nkp.vk, eps, wkp.pk, rng,
                     prover=dev_prover, check=True)
    prove_time = time.time() - t0
    cold_phases = dict(dev_prover.last_timings)
    print(f"[5] WRAPPING PROOF generated: {prove_time:.1f}s "
          f"({args.batch/prove_time:.3f} aggregated proofs/s)", flush=True)

    # 6. verify + layout checks
    host_w = Groth16("bw6-761")
    t0 = time.time()
    ok = host_w.verify(wep.inputs, wep.proof, wkp.vk)
    print(f"[6] wrapper proof verifies: {ok} ({time.time()-t0:.1f}s)",
          flush=True)
    _check(ok, "wrapper proof does not verify")
    vk_hash = circ.compute_nested_vk_hash(nkp.vk)
    _check(wep.inputs[0] == vk_hash, "input 0 is not the nested vk hash")
    _check(wep.inputs[1] == (1 << args.batch) - 1,
           "results are not all valid")
    for i in range(args.batch):
        _check(wep.inputs[2 + i] == 7 + i, f"nested input {i} differs")
    print("[6] primary layout [vk_hash, results, inputs...] OK", flush=True)

    # 6b. settle through the word-level dispatcher engine (the on-chain
    # path of scripts/test-client, minus ganache): encode calldata, verify
    # via the contract model, dispatch to the dummy application
    vk_words = dp.vk_to_contract_parameters(wkp.vk)
    eng = dp.DispatcherEngine(vk_words, batch_size=args.batch)
    app = dp.DummyApplicationEngine(eng, expected_vk_hash=vk_hash)
    t0 = time.time()
    ok = eng.process_batch(
        dp.proof_to_contract_parameters(wep.proof),
        dp.inputs_to_contract_parameters(wep.inputs),
        [b"params%d" % i for i in range(args.batch)],
        app,
    )
    _check(ok, "dispatcher rejected the batch proof")
    for i in range(args.batch):
        _check(app.get(7 + i) == b"params%d" % i,
               f"dispatcher did not settle nested proof {i}")
    print(f"[6b] settlement via dispatcher engine OK "
          f"({time.time()-t0:.1f}s)", flush=True)

    warm_prove = None
    warm_phases = {}
    if not args.skip_negative:
        # 7. corrupt one nested proof -> result bit 0, proof still valid.
        # Same packed key, fresh witness: THIS is the warm prove the
        # aggregated-proofs/s is measured on.
        bad = list(eps)
        bad[-1] = ExtendedProof(proof=bad[-1].proof, inputs=[999])
        t0 = time.time()
        wep2 = circ.prove(nkp.vk, bad, wkp.pk, rng,
                          prover=dev_prover, check=True)
        warm_prove = time.time() - t0
        warm_phases = dict(dev_prover.last_timings)
        _check(host_w.verify(wep2.inputs, wep2.proof, wkp.vk),
               "wrapper of a corrupt nested proof does not verify")
        _check(wep2.inputs[1] == (1 << (args.batch - 1)) - 1,
               "corrupt nested proof did not give result bit 0")
        print(f"[7] corrupt-proof negative case (WARM prove) OK "
              f"({warm_prove:.1f}s, "
              f"{args.batch/warm_prove:.3f} aggregated proofs/s)",
              flush=True)

    summary = {
        "batch": args.batch,
        "constraints": circ.r1cs.num_constraints,
        "cold_prove_s": round(prove_time, 2),
        "cold_phases": {k: round(v, 2) for k, v in cold_phases.items()},
        "warm_prove_s": round(warm_prove, 2) if warm_prove else None,
        "warm_phases": {k: round(v, 2) for k, v in warm_phases.items()},
        "aggregated_proofs_per_s": (
            round(args.batch / warm_prove, 4) if warm_prove else None
        ),
    }
    print("E2E_JSON: " + json.dumps(summary), flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(summary, f)
    print("ALL CHECKS PASSED", flush=True)
    return 0


def _check(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


class DeviceProver:
    """Adapter fixing the device pk, and a mesh where one is given (only
    ``Groth16Torch.prove`` takes one), for AggregatorCircuit.prove."""

    def __init__(self, prover, dpk, mesh=None):
        self.prover = prover
        self.dpk = dpk
        self.mesh = mesh
        self.last_timings = {}

    def prove(self, r1cs, pk, assignment, rng=None):
        timings = {}
        extra = {} if self.mesh is None else {"mesh": self.mesh}
        proof = self.prover.prove(
            r1cs, pk, assignment, rng, device_pk=self.dpk, timings=timings,
            **extra
        )
        self.last_timings = timings
        print("    prover phases:",
              {k: round(v, 2) for k, v in timings.items()}, flush=True)
        return proof


if __name__ == "__main__":
    sys.exit(main())
