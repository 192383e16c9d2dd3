# Ported from scripts/batch32_e2e.py: the same steps [1]-[6], rng seed and checks, with Groth16Torch as the prover of its --tpu path and Groth16Native (--engine native) of its other.
"""Batch-32 settlement configuration on the card (SURVEY section 7 step
10): 32 dummy-app BLS12-377 proofs aggregated into ONE BW6-761 wrapper
proof (958,190 constraints, QAP domain 2^20).

Steps, as the reference numbers them:

  1. the nested dummy-app keypair and ``--batch`` proofs of a = 100 + i,
     all from ``Random(23)``;
  2. the wrapper circuit ``AggregatorCircuit(1, batch)`` (it holds witness
     closures and cannot be pickled: rebuilt on every run);
  3. its witness through the native hook replay, with the vk-hash and
     all-result-bits checks;
  4. the wrapper's trusted setup on the card (``Groth16Torch.
     generate_setup``), or on the host's native C engine when the first
     engine is ``native``, pickled in ``--cache`` under the batch, the rng
     state it starts from and a digest of the R1CS (both setups give one
     keypair from one rng state, so they share the file); a hit restores
     the rng state the setup left, so a cached run proves what an uncached
     one does;
  5. the proving key packed to the card once, then the prove with each
     engine of ``--engine`` from one rng state (msm8 in the window chunks
     of ``groth16_torch.msm8_chunks``: 16 at n = 2^20; ``native`` is
     ``Groth16Native``, the reference's path without ``--tpu``), with its
     phases and its peak device memory;
  6. host verification, the layout ``[vk_hash, 2^batch - 1, 100, ...]``,
     and every engine's proof equal to the first one's.

An out-of-memory error ends the run with exit code 1 after its
``E2E_JSON`` line, which names the engine and the failed allocation;
nothing is retried.  There is no CPU fallback: without a GPU the default
``--device cuda`` raises, unless every engine is ``native``, which needs
no device.  The first run of batch 32 on an H100 takes about
15 minutes (circuit and witness on the host, the setup on the card); a
cached keypair saves the setup.

Usage: python -m zecale_tpu_torch.batch32_e2e [--batch 32] [--cache DIR]
    [--engine msm4|msm8|jac|native[,...]] [--json PATH] [--device cuda|cpu]
Prints one ``E2E_JSON: {...}`` line and ends with ``BATCH-<batch> OK``.
"""

import argparse
import json
import os
import random
import sys
import tempfile
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--cache", default=os.path.join(
        tempfile.gettempdir(), "zecale_tpu_torch_cache"))
    ap.add_argument("--engine", default="",
                    help="msm4, msm8, jac or native, or several joined "
                    "by commas "
                    "(default: msm8 if ZECALE_USE_MSM8 is set, else msm4)")
    ap.add_argument("--json", default="", help="write summary JSON here")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch

    from .aggregate_e2e import _check
    from .aggregator import dummy_app as da
    from .aggregator.circuit import AggregatorCircuit
    from .rollup_e2e import cached_setup, setup_cache_path
    from .snark import groth16_torch as gt
    from .snark.groth16 import Groth16
    from .snark.groth16_native import Groth16Native
    from .utils.device import resolve

    engines = (args.engine or gt.default_engine()).split(",")
    for eng in engines:
        if eng not in gt.ENGINES + ("native",):
            ap.error(f"engine {eng!r} not in {gt.ENGINES + ('native',)}")
    on_device = [eng for eng in engines if eng != "native"]
    dev = resolve(args.device) if on_device else torch.device("cpu")
    cuda = dev.type == "cuda"
    os.makedirs(args.cache, exist_ok=True)
    print("device:", torch.cuda.get_device_name(dev) if cuda else dev,
          flush=True)

    B = args.batch
    summary = {"batch": B, "engines": engines}
    if cuda:
        # the kernels build at their first launch: build them here, so that
        # the setup's seconds are the setup's
        from .utils import build

        t0 = time.time()
        build.cuda_kernels()
        summary["kernel_build_s"] = round(time.time() - t0, 2)
        print(f"[0] kernels built: {summary['kernel_build_s']}s", flush=True)

    rng = random.Random(23)
    t0 = time.time()
    _, nkp = da.dummy_app_setup("bls12-377", rng)
    eps = [da.dummy_app_prove("bls12-377", nkp, 100 + i, rng)
           for i in range(B)]
    summary["nested_s"] = round(time.time() - t0, 2)
    print(f"[1] {B} nested dummy-app proofs: {summary['nested_s']}s",
          flush=True)

    t0 = time.time()
    circ = AggregatorCircuit(1, B)
    r1cs = circ.r1cs
    summary.update(circuit_s=round(time.time() - t0, 2),
                   constraints=r1cs.num_constraints,
                   variables=r1cs.num_variables, domain=r1cs.qap_degree)
    print("    (not cacheable: the circuit holds witness closures; rebuilt "
          "on every run)", flush=True)
    print(f"[2] wrapper circuit built: {summary['circuit_s']}s "
          f"({r1cs.num_constraints} constraints, {r1cs.num_variables} "
          f"variables, domain {r1cs.qap_degree})", flush=True)

    t0 = time.time()
    w = circ.generate_witness(nkp.vk, eps)
    summary["witness_s"] = round(time.time() - t0, 2)
    print(f"[3] witness (native hook replay): {summary['witness_s']}s",
          flush=True)
    vk_hash = circ.compute_nested_vk_hash(nkp.vk)
    _check(w[1] == vk_hash, "input 0 is not the nested vk hash")
    _check(w[2] == (1 << B) - 1, "all result bits must be set")

    provers = {eng: Groth16Native("bw6-761") if eng == "native" else
               gt.Groth16Torch("bw6-761", device=dev, engine=eng)
               for eng in engines}
    prover = provers[engines[0]]
    setup_t = {}
    timed = {} if engines[0] == "native" else {"timings": setup_t}
    t0 = time.time()
    # the file that holds (keypair, rng state), for a caller that serves
    # this keypair
    summary["keypair_file"] = setup_cache_path(
        args.cache, f"batch{B}_keypair", r1cs, rng)
    wkp, hit = cached_setup(
        args.cache, f"batch{B}_keypair", r1cs, rng,
        lambda cs, r: prover.generate_setup(cs, r, **timed))
    summary.update(setup_s=round(time.time() - t0, 2), setup_loaded=hit,
                   setup_phases={k: round(v, 2) for k, v in setup_t.items()})
    where = "on the host" if engines[0] == "native" else "on the card"
    print(f"[4] wrapper trusted setup "
          f"({'cached' if hit else where}): {summary['setup_s']}s "
          f"{summary['setup_phases']}", flush=True)

    dpk = None
    if on_device:
        t0 = time.time()
        dpk = provers[on_device[0]].pack_pk(wkp.pk, r1cs.num_primary + 1)
        if cuda:
            torch.cuda.synchronize(dev)
        summary.update(pack_pk_s=round(time.time() - t0, 2), n_g1=dpk.n_g1,
                       n_g2=dpk.n_g2)
        print(f"    pk packed to device: {summary['pack_pk_s']}s (G1 "
              f"queries {dpk.n_g1}, G2 query {dpk.n_g2})", flush=True)

    inputs = w[1: 1 + circ.num_primary_inputs]
    host_w = Groth16("bw6-761")
    state = rng.getstate()
    summary["proves"] = proves = {}
    first = None
    for eng in engines:
        r = random.Random()
        r.setstate(state)
        timings = {}
        chunks = ({"g1": gt.msm8_chunks("bw6-761", dpk.n_g1),
                   "g2": gt.msm8_chunks("bw6-761", dpk.n_g2)}
                  if eng == "msm8" else None)
        run = proves[eng] = {"msm8_chunks": chunks}
        if cuda:
            torch.cuda.synchronize(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            run["base_gb"] = round(torch.cuda.memory_allocated(dev) / 1e9, 3)
        t0 = time.time()
        try:
            proof = provers[eng].prove(r1cs, wkp.pk, w, r, device_pk=dpk,
                                       timings=timings)
        except torch.cuda.OutOfMemoryError as e:
            run.update(out_of_memory=str(e).splitlines()[0],
                       peak_gb=_peak_gb(dev))
            print(f"[5] wrapper prove ({eng}): out of device memory after "
                  f"{time.time() - t0:.1f}s, peak {run['peak_gb']} GB: "
                  f"{run['out_of_memory']}", flush=True)
            _finish(summary, args.json)
            return 1
        run.update(prove_s=round(time.time() - t0, 2),
                   phases={k: round(v, 3) for k, v in timings.items()},
                   peak_gb=_peak_gb(dev))
        print(f"[5] wrapper prove ({eng}): {run['prove_s']}s "
              f"{run['phases']}, peak {run['peak_gb']} GB"
              + (f", msm8 chunks {run['msm8_chunks']}"
                 if run["msm8_chunks"] else ""), flush=True)

        t0 = time.time()
        _check(host_w.verify(inputs, proof, wkp.vk),
               f"wrapper proof ({eng}) does not verify")
        run["verify_s"] = round(time.time() - t0, 2)
        print(f"[6] host verify ({eng}): {run['verify_s']}s", flush=True)
        if first is None:
            first = proof
        else:
            _check(proof == first,
                   f"wrapper proof ({eng}) != {engines[0]} proof")
    _check(inputs[0] == vk_hash and inputs[1] == (1 << B) - 1,
           "primary layout is not [vk_hash, 2^batch - 1, ...]")
    for i in range(B):
        _check(inputs[2 + i] == 100 + i, f"nested input {i} differs")
    prove_s = proves[engines[0]]["prove_s"]
    summary["aggregated_proofs_per_s"] = round(B / prove_s, 4)
    _finish(summary, args.json)
    same = f", {', '.join(engines[1:])} equal" if len(engines) > 1 else ""
    print(f"BATCH-{B} OK: witness {summary['witness_s']:.1f}s, prove "
          f"{prove_s:.1f}s ({B / prove_s:.3f} aggregated proofs/s, "
          f"{engines[0]}{same})", flush=True)
    return 0


def _peak_gb(dev):
    import torch

    if dev.type != "cuda":
        return None
    torch.cuda.synchronize(dev)
    return round(torch.cuda.max_memory_allocated(dev) / 1e9, 3)


def _finish(summary: dict, path: str) -> None:
    print("E2E_JSON: " + json.dumps(summary), flush=True)
    if path:
        with open(path, "w") as f:
            json.dump(summary, f)


if __name__ == "__main__":
    sys.exit(main())
