# Ported from bench.py: the same environment variables, timing, oracle check and JSON keys, on the port's MSM engines.
"""Benchmark of the port -- runs on the card.

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N,
   "engine": ..., "aggregated_proofs_per_s": N|null, ...}

Headline metric: MSM throughput per card on BLS12-377 G1 (the dominant
prover kernel), measured with the msm4 engine (``ec/msm.py``, bucket sums
in the CUDA kernel ``bucket_reduce``); ``ZECALE_USE_MSM8=1`` measures the
msm8 engine (``ec/msm8.py``) instead, and "engine" tags the JSON.  Three
timed MSMs after a warm-up; the warm-up's result is checked against the
exact folded host MSM (64 cycled bases) or, with ``BENCH_RANDOM_POINTS=1``
(random points from the native fixed-base ladder), the native C MSM.  The
second metric, aggregated proofs/s (BW6-761 Groth16 wrapper, warm prove),
comes from running ``zecale_tpu_torch.aggregate_e2e`` in a subprocess
under a timeout, merged into the same JSON line (null if it fails or times
out; ``BENCH_E2E=0`` skips it, ``BENCH_E2E_BATCH`` and
``BENCH_E2E_TIMEOUT`` resize it).  ``vs_baseline`` is against a nominal
1.0 Mpoints/s for the reference's libff Pippenger on a 64-core host.

Diagnostics on stderr: per-phase timings (``utils/profiling.py``) and the
native C engine's CPU MSM.  ``BENCH_MSM_N``, ``BENCH_CURVE`` and
``BENCH_WINDOW_C`` resize; ``BENCH_PHASES`` names the phase JSON (by
default in the temporary directory).

Usage: python -m zecale_tpu_torch.bench
"""

import json
import os
import random
import subprocess
import sys
import tempfile
import time

REFERENCE_MSM_MPOINTS_PER_S = 1.0  # nominal 64-core libff baseline


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def run(device=None) -> tuple:
    """(host-oracle check passed, the JSON line's dict) of one bench run
    on ``device`` (the card unless the CPU is asked for)."""
    import torch

    from .ec import curve_torch as ct
    from .ec import host_curve as hc
    from .ec import msm, msm8
    from .ff import params as P
    from .ff.fp_torch import field
    from .native import ec as nec
    from .utils.device import resolve
    from .utils.profiling import PhaseProfiler

    n_points = int(os.environ.get("BENCH_MSM_N", str(1 << 18)))
    curve = os.environ.get("BENCH_CURVE", "bls12-377")
    window_c = int(os.environ.get("BENCH_WINDOW_C", "0"))
    phases_out = os.environ.get("BENCH_PHASES", os.path.join(
        tempfile.gettempdir(), "zecale_tpu_torch_bench_phases.json"))
    use_msm8 = bool(os.environ.get("ZECALE_USE_MSM8"))
    random_points = bool(os.environ.get("BENCH_RANDOM_POINTS"))

    dev = resolve(device)
    prof = PhaseProfiler()
    log(f"device: {torch.cuda.get_device_name(dev)}"
        if dev.type == "cuda" else f"device: {dev}")
    r = P.CURVES[curve].r
    rng = random.Random(42)
    gen = hc.generators(curve)[0]
    crv_h = hc.g1_curve(curve)
    engine = msm8 if use_msm8 else msm
    c = window_c or engine.default_window(n_points)
    msm_fn = msm8.msm8 if use_msm8 else msm.msm
    scalars = [rng.randrange(r) for _ in range(n_points)]
    if random_points:
        # fully random points via the native fixed-base ladder (fast);
        # oracle-checked against the native Pippenger MSM below
        if not nec.available():
            raise RuntimeError("BENCH_RANDOM_POINTS needs the C engine")
        log(f"building {n_points} RANDOM points (native ladder), c={c}...")
        ks = [rng.randrange(1, r) for _ in range(n_points)]
        pts = nec.NativeCurve(curve).fixed_base_mul_batch(ks, gen)
        base_pts = None
    else:
        log(f"building {n_points} points (64 distinct bases cycled), "
            f"c={c}...")
        base_pts = []
        pt = gen
        for _ in range(64):
            base_pts.append(pt)
            pt = crv_h.dbl(pt)
        pts = [base_pts[i % 64] for i in range(n_points)]

    Fr = field(r)
    with prof.phase("pack"):
        scal = Fr.pack(scalars, dev)
        xy, inf = ct.pack_affine(ct.coord_field(curve, False), pts, dev)

    def fn(s):
        return msm_fn(curve, False, s, xy, inf, c)

    with prof.phase("compile+first"):
        got = fn(scal)  # a host point: the device work is done
    log(f"first run (kernel build and warm-up): "
        f"{prof.total('compile+first'):.1f}s")

    iters = 3
    variants = [scal] + [
        Fr.pack([rng.randrange(r) for _ in range(n_points)], dev)
        for _ in range(iters - 1)
    ]
    with prof.phase("steady"):
        t0 = time.time()
        for i in range(iters):
            fn(variants[i])
        dt = (time.time() - t0) / iters
    mpoints = n_points / dt / 1e6
    log(f"steady-state MSM: {dt*1e3:.0f} ms for {n_points} points")

    # correctness of the first run against the exact oracle
    with prof.phase("verify"):
        if random_points:
            expect = nec.NativeCurve(curve).msm(scalars, pts)
        else:
            folded = [0] * 64
            for i, s in enumerate(scalars):
                folded[i % 64] = (folded[i % 64] + s) % r
            expect = crv_h.msm(folded, base_pts)
        ok = got == expect
    log(f"correctness vs host oracle: {ok}")

    # diagnostics: native CPU MSM for scale (stderr only)
    if nec.available():
        n_cpu = min(n_points, 1 << 14)
        ncv = nec.NativeCurve(curve)
        with prof.phase("native_cpu_msm"):
            t0 = time.time()
            ncv.msm(scalars[:n_cpu], pts[:n_cpu])
            cpu_dt = time.time() - t0
        log(f"native C MSM (CPU, n={n_cpu}): {cpu_dt*1e3:.0f} ms "
            f"-> {n_cpu/cpu_dt/1e6:.3f} Mpoints/s")
    else:
        log("native CPU diagnostic skipped: the C engine did not build")

    prof.report()
    prof.to_json(phases_out)
    if not ok:
        log("MSM MISMATCH -- benchmark invalid")
        return False, None

    # second metric: aggregated proofs/s (BW6-761 wrapper, warm prove) via
    # aggregate_e2e in a subprocess under a timeout -- its failure must
    # not invalidate the MSM headline
    e2e = None
    if os.environ.get("BENCH_E2E", "1") != "0":
        e2e = _run_e2e(dev)

    return True, {
        "metric": f"msm_{curve}_g1_mpoints_per_s_per_chip",
        "value": round(mpoints, 4),
        "unit": "Mpoints/s",
        "vs_baseline": round(mpoints / REFERENCE_MSM_MPOINTS_PER_S, 4),
        "engine": "msm8" if use_msm8 else "msm4",
        "points": "random" if random_points else "cycled64",
        "aggregated_proofs_per_s": (
            e2e.get("aggregated_proofs_per_s") if e2e else None
        ),
        "e2e_batch": e2e.get("batch") if e2e else None,
        "e2e_warm_prove_s": e2e.get("warm_prove_s") if e2e else None,
        "e2e_cold_prove_s": e2e.get("cold_prove_s") if e2e else None,
    }


def _run_e2e(dev):
    """Run the wrapper e2e in a subprocess; return its summary dict or
    None.  BENCH_E2E_BATCH / BENCH_E2E_TIMEOUT resize."""
    batch = int(os.environ.get("BENCH_E2E_BATCH", "8"))
    tmo = int(os.environ.get("BENCH_E2E_TIMEOUT", "2700"))
    jpath = os.path.join(tempfile.gettempdir(),
                         f"zecale_tpu_torch_bench_e2e_b{batch}.json")
    try:
        os.remove(jpath)
    except FileNotFoundError:
        pass
    cmd = [sys.executable, "-m", "zecale_tpu_torch.aggregate_e2e",
           "--batch", str(batch), "--json", jpath, "--device", str(dev)]
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    log(f"e2e: running batch-{batch} wrapper prove (timeout {tmo}s)...")
    try:
        res = subprocess.run(cmd, cwd=root, timeout=tmo,
                             stdout=sys.stderr, stderr=sys.stderr)
    except subprocess.TimeoutExpired:
        log(f"e2e: timed out after {tmo}s")
        return None
    if res.returncode != 0:
        log(f"e2e: FAILED (exit {res.returncode})")
        return None
    with open(jpath) as f:
        summary = json.load(f)
    log(f"e2e: {summary}")
    return summary


def main(device=None) -> int:
    ok, out = run(device)
    if not ok:
        return 1
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
