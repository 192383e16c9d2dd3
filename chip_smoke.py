#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (zecale_tpu_torch) on one GPU.

Phases, each printing one flushed line with its seconds:

  1. the card (nvidia-smi name and power limit) and the nvcc build of every
     kernel (one nvcc process per source and variant, all started
     together: fast_kernels.cu once per (form, TPI) of
     utils/build.py:ADD_TPIS, which holds K1-K6), with each job's seconds
     and its ptxas register and spill lines, and the SASS opcode counts of
     every kernel (cuobjdump);
  2. the bucket-reduce kernel (K1) against its plain PyTorch version on the
     card, for BW6-761 G1 (b3=-3), BW6-761 G2 (b3=12), BLS12-377 G1 (b3=3)
     and [2b] BLS12-377 G2 over Fq2 (twist b3), in every built TPI: a few
     thousand crafted segments with empty buckets, single points, P+P,
     P+(-P) and repeated points, after a block in which every warp mixes
     segments of 0, 1 and 32 entries, as affine and as projective inputs;
     then, for BW6-761 G1, BLS12-377 G1 and G2 (one group a form), every
     launch of an MSM at n = 2^16 (its bucket levels, then its subset
     sums), each in every TPI, timed, with its bound, the first also on
     its first 4,096-65,536 segments;
     [2c] K2 proj_add and [2d] K3 proj_dbl_chain (k = 1, 6 and the
     wrapper's msm8 window c = 11) against their plain versions in all
     three field forms (Fq 12 and 24 limbs, Fq2), a few thousand pairs with
     O+O, O+P, P+O, P+P, P+(-P) and Z != 1, then K2 timed at the largest
     shape the msm8 wrapper prove gives it; K2 (and K4 below) in every
     built threads-per-point variant of utils/build.py:ADD_TPIS, each equal
     to the plain version and timed there and at the batch sizes of
     SWEEP_N below it (all of them at Fq 24); K3 (and K5 below), one warp
     a point with the products of each step side by side, in every built
     TPI, equal to plain on the crafted points, on one point and on W
     points, and timed at its Horner fold's k on the batches of
     DBL_SWEEP_N (one point and the paths' 35 and 48); [2e] K4 jac_add, K5 jac_dbl_chain (k = 1,
     3, 8) and K6 aff_add against their plain versions in the three forms
     on a few thousand crafted cases (O+O, O+P and P+O with nonzero X and Y
     at infinity, P+P with equal and with different Z, P+(-P), distinct
     points; K6 with each infinity flag, P = Q, P = -Q), K4 and K6 in
     every built TPI, then K4 and K6 timed in every TPI at the first tiled
     round of the jac engine's largest MSM (48 windows x 1,024 tiles of a
     BW6-761 G1 MSM at n = 2^16), K6 also at the setup's 16,384-lane
     chunk, and K5 at its Horner fold (k = 8);
  3. a small Groth16 proof on the card equal to the host prover's; [3b] the
     nested BLS12-377 dummy-app proof made on the card (G2 over Fq2), equal
     to the host prover's from the same rng state and valid, its keypair
     also made by the device setup (Groth16Torch.generate_setup, K4 and K6
     over Fq 12 and Fq2) and equal to the host setup's; then the main
     path: [3d] the wrapper's trusted setup on the card from a saved rng
     state, equal to the native setup's keypair from the same state; that
     proof wrapped in a batch-1 BW6-761 Groth16 proof by
     AggregatorCircuit.prove(prover=Groth16Torch), [3f] with the msm4
     engine and [3g] again from the same rng state with the msm8 engine
     and with the jac engine, which must give the same proof bit for bit;
     each verifies with primary inputs [vk_hash, 1, 7]; a corrupt nested
     proof must give result bit 0 in a valid wrapper, and a tampered
     wrapper proof must be rejected; [3j] the wrapper's device setup, the
     msm8 and jac proves and a second msm4 prove run under torch.profiler
     (CUDA activity), each with the device time of every kernel summed by
     name and its K1-K6 launches counted by batch size (K1: segments) and
     variant, with their device ms; [3k] the served path: the aggregator
     service built by api/server_main.py:build_service (batch 1, prover
     torch, the [3d] keypair written to a file so that the load branch and
     its vk-shape check run), each request and answer carried through the
     protobuf wire format: the configuration, the registration of the
     nested vk and its hash (equal), two nested transactions at fees 5 and
     10 and one with a point off the curve (refused), two aggregations,
     which must come in fee order with proofs valid under the wrapper vk
     for inputs [vk_hash, 1, a] and launch K1, and a third (refused: the
     pool is empty), with the seconds of each request;
  4. bench.py's MSM shape on the three engines: BLS12-377 G1 at n = 2^18
     with uniform scalars from random.Random(42) and 64 cycled bases,
     checked against the folded host MSM, Mpoints/s after one warm-up run;
     and a BLS12-377 G2 (Fq2) MSM at n = 2^16, equal across the engines;
     [4b] the port's bench (zecale_tpu_torch/bench.py) in this process
     at its default shape without its e2e run: its host-oracle check must
     pass and its line must carry bench.py's keys;
  5. a JSON line of the kernels with their launches on the main path, then
     the card's name and power limit, then {"ok": true, "device": ...}.

Each path of phase 3 ([3k]: its two aggregations) runs with the launch
counts set to 0 just before it and read just after.  Tolerance: exact.
Field and group values are integers, so a kernel's limbs must equal the
plain version's bit for bit.
Any failed check raises and the script exits non-zero without the last
line.  There is no CPU fallback: without a CUDA device it exits 1 at once.

The native wrapper keypair is cached in the temporary directory, never in
the repository, under a name keyed by a hash of the rng state it was made
from and the circuit's size; the circuit holds witness closures, cannot be
pickled, and is rebuilt (a few seconds).

Usage: python3 chip_smoke.py
"""

import hashlib
import json
import math
import os
import pickle
import random
import re
import subprocess
import sys
import tempfile
import time

T_START = time.time()

#: int32 multiply-adds per second of one H100 SXM: 132 SMs x 64 INT32
#: lanes x 1.98 GHz (half the 128 FP32 lanes behind NVIDIA's 67 TFLOP/s)
INT32_OPS_PER_S = 132 * 64 * 1.98e9
#: HBM3 bytes per second of one H100 SXM (NVIDIA's data sheet)
HBM_BYTES_PER_S = 3.35e12


def log(msg: str) -> None:
    print(f"[{time.time() - T_START:7.1f}s] {msg}", flush=True)


def check(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


#: SASS opcodes counted in K1-K6: multiply-adds, local memory (spills
#: and runtime-indexed arrays), shuffles and votes
SASS_OPS = ("IMAD", "LDL", "STL", "SHFL", "VOTE")


def sass_counts(libs: dict) -> dict:
    """{library: {kernel: {"all": instructions, op: count for SASS_OPS}}}
    by cuobjdump -sass of {library: path}, one process each, all at once."""
    from zecale_tpu_torch.utils import build

    tool = os.path.join(os.path.dirname(build.nvcc_path()), "cuobjdump")
    procs = {lib: subprocess.Popen([tool, "-sass", path], text=True,
                                   stdout=subprocess.PIPE)
             for lib, path in libs.items()}
    out = {}
    for lib, proc in procs.items():
        text, _ = proc.communicate()
        check(proc.returncode == 0, f"cuobjdump of {lib} failed")
        counts, name = out.setdefault(lib, {}), None
        for ln in text.splitlines():
            fn = re.search(r"Function : (\S+)", ln)
            if fn:
                name = build.kernel_label(fn.group(1)) or fn.group(1)[:40]
                counts[name] = dict.fromkeys(("all",) + SASS_OPS, 0)
                continue
            op = re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?"
                           r"([A-Z][A-Z0-9_]*)", ln)
            if name and op:
                counts[name]["all"] += 1
                if op.group(1) in counts[name]:
                    counts[name][op.group(1)] += 1
    return out


def cuda_ms(fn, reps: int) -> float:
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(ops: float, nbytes: float) -> tuple:
    """(least ms the card could take, what bounds it)."""
    t_ops, t_bytes = ops / INT32_OPS_PER_S, nbytes / HBM_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def mul_ops(F) -> int:
    """int32 multiply-adds of one Montgomery product of F's base field:
    2 N^2 32-bit products, two ops each (low and high halves)."""
    n = getattr(F, "base", F).n
    return 2 * n * n * 2


def words(F) -> int:
    """32-bit words of one coordinate (12 or 24 over Fq, 24 over Fq2)."""
    return math.prod(F.shape)


def add_muls(F, mixed: bool = False) -> int:
    """Base-field products of one RCB add: 12 (11 with Z2 = 1) over Fq,
    where the small b3 is additions; over Fq2 each product is three base
    products and the twist b3 costs two more Fq2 products."""
    k = 11 if mixed else 12
    return 3 * (k + 2) if len(F.shape) == 2 else k


def dbl_muls(F) -> int:
    """Base-field products of one RCB doubling (8, plus one Fq2 product
    for the twist b3)."""
    return 3 * 9 if len(F.shape) == 2 else 8


def jac_muls(F, op: str) -> int:
    """Base-field products of one Jacobian op on finite, distinct inputs:
    K4 add 16 (11M + 5S), K5 doubling 7 (2M + 5S), K6 affine add 6
    (4M + 2S); three base products per Fq2 product."""
    k = {"add": 16, "dbl": 7, "aff": 6}[op]
    return 3 * k if len(F.shape) == 2 else k


def counted() -> tuple:
    """Every kernel wrapper that counts its launches."""
    from zecale_tpu_torch.ec import jac_curve as jc
    from zecale_tpu_torch.ec import msm
    from zecale_tpu_torch.ec import proj_curve as pc

    return (msm.bucket_reduce, pc.proj_add, pc.proj_dbl_chain, jc.jac_add,
            jc.jac_dbl_chain, jc.aff_add)


def reset_counts() -> None:
    for fn in counted():
        fn.launches = 0
        fn.launches_by_form.clear()


def read_counts() -> dict:
    return {fn.__name__: {"launches": fn.launches,
                          "by_form": dict(fn.launches_by_form)}
            for fn in counted()}


#: the kernel functions of each counted wrapper, as the profiler names them
KERNEL_OF = {"bucket_reduce": "bucket_reduce_kernel",
             "proj_add": "proj_add_kernel",
             "proj_dbl_chain": "proj_dbl_chain_kernel",
             "jac_add": "jac_add_kernel",
             "jac_dbl_chain": "jac_dbl_chain_kernel",
             "aff_add": "aff_add_kernel"}


#: the wrappers whose launches [3j] counts by batch size (K1: segments)
#: and variant
SIZED = ("bucket_reduce", "proj_add", "jac_add", "proj_dbl_chain",
         "jac_dbl_chain", "aff_add")


def profiled(fn) -> tuple:
    """(fn(), profile) with fn run under torch.profiler (CUDA activity):
    profile = {"device_ms": all kernels, "wall_s": the run, "by_kernel":
    {our kernel: ms}, "top": the five largest others, "launch_us": {each
    kernel of SIZED: [us of each launch, in launch order]}}.  device_ms is
    None where the trace held no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    t0 = time.time()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    wall = time.time() - t0
    ours, others, starts = {}, {}, {k: [] for k in SIZED}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = e.time_range.elapsed_us()
        name = next((k for k, v in KERNEL_OF.items() if v in e.name), None)
        if name:
            ours[name] = ours.get(name, 0.0) + us / 1e3
            if name in starts:
                starts[name].append((e.time_range.start, us))
        else:
            others[e.name[:60]] = others.get(e.name[:60], 0.0) + us / 1e3
    total = sum(ours.values()) + sum(others.values())
    top = dict(sorted(others.items(), key=lambda kv: -kv[1])[:5])
    return out, {"device_ms": total or None, "wall_s": wall,
                 "by_kernel": ours, "top": top,
                 "launch_us": {k: [us for _, us in sorted(v)]
                               for k, v in starts.items()}}


#: upper ends of the size classes of the K1-K6 launch histogram
SIZE_CLASSES = (1, 128, 1024, 4096, 16384, 65536, None)


class Launches:
    """Records the size (points, or K1's segments) and variant of every
    K1-K6 launch while it is entered, by wrapping proj_curve.launch_fast,
    which every wrapper launches through; the launch counts stay the
    wrappers' own."""

    #: the argument of each launcher that holds the launch's size
    SIZE_ARG = {"zt_bucket_reduce": 3, "zt_proj_add": 3, "zt_jac_add": 3,
                "zt_proj_dbl_chain": 2, "zt_jac_dbl_chain": 2,
                "zt_aff_add": 5}

    def __enter__(self):
        from zecale_tpu_torch.ec import jac_curve as jc
        from zecale_tpu_torch.ec import proj_curve as pc

        self.mods = (pc, jc)
        self.orig = pc.launch_fast
        self.sizes = []

        def rec(name, sym, key, out, *args):
            form, tpi = key
            self.sizes.append((name, form, args[self.SIZE_ARG[sym]],
                               f"tpi{tpi}"))
            return self.orig(name, sym, key, out, *args)

        for m in self.mods:
            m.launch_fast = rec
        return self

    def __exit__(self, *exc):
        for m in self.mods:
            m.launch_fast = self.orig

    def histogram(self, launch_us: dict = None) -> dict:
        """{"kernel form variant": {"<=n": [launches, device ms or None]}}:
        device ms from the profile's launches in order where their number
        is the recorded one."""
        hist = {}
        for name in SIZED:
            rows = [(f, n, v) for k, f, n, v in self.sizes if k == name]
            us = (launch_us or {}).get(name)
            if us is not None and len(us) != len(rows):
                us = None
            for i, (form, n, variant) in enumerate(rows):
                top = next(c for c in SIZE_CLASSES if c is None or n <= c)
                key = f"<={top}" if top else f">{SIZE_CLASSES[-2]}"
                cell = hist.setdefault(f"{name} {form} {variant}", {})
                cell.setdefault(key, [0, 0.0 if us else None])
                cell[key][0] += 1
                if us:
                    cell[key][1] += us[i] / 1e3
        return hist


def log_profile(run: str, profiles: dict, hists: dict) -> None:
    prof = dict(profiles[run])
    prof.pop("launch_us")
    log(f"[3j] {run}, device time by kernel: {json.dumps(prof)}; K1-K6 "
        f"launches [count, device ms] by batch size (K1: segments): "
        f"{json.dumps(hists[run])}")


#: segment counts of K1's sweep: the first segments of an MSM's first
#: bucket level, between its subset sums' and its own counts
K1_SWEEP_SEGS = (4096, 16384, 32768, 49152, 65536)


def k1_levels(stage: str, F, b3, pts, ent, counts, affine: bool,
              tpis) -> list:
    """The launches msm.reduce_runs makes for these runs (one level a
    launch), each in every built TPI equal to the plain version and timed,
    with its bound: a product count of one add per entry, and each input
    and output read or written once.  "ms" is the table's pick.  The
    first level is also timed on its first m segments for each m of
    K1_SWEEP_SEGS below its count."""
    import torch

    from zecale_tpu_torch.ec import msm
    from zecale_tpu_torch.ec.curve_torch import form_of
    from zecale_tpu_torch.utils import build

    dev = pts.device
    form = form_of(F)
    seg, nch = msm.segments(counts, ent.numel())
    levels = []
    while True:
        got = msm.bucket_reduce(pts, ent, seg, F, b3, affine)
        torch.cuda.synchronize()
        t_ref = time.time()
        ref = msm.bucket_reduce_ref(pts, ent, seg, F, b3, affine)
        torch.cuda.synchronize()
        plain_ms = (time.time() - t_ref) * 1e3
        err = max_err(got, ref)
        nseg = seg.numel() - 1
        pick = build.sum_tpi("bucket_reduce", form, ent.numel())
        level = {"stage": stage, "affine": affine, "segments": nseg,
                 "entries": ent.numel(),
                 "longest": int((seg[1:] - seg[:-1]).max()), "tpi": pick}
        for t in tpis:
            run = lambda t=t: msm.bucket_reduce_tpi(  # noqa: E731
                pts, ent, seg, F, b3, affine, t)
            err = max(err, max_err(run(), ref))
            level[f"tpi{t}_ms"] = cuda_ms(run, 3)
        if not levels:  # the first level's first m segments, every TPI
            level["sweep"] = []
            for m in (m for m in K1_SWEEP_SEGS if m < nseg):
                row = {"segments": m}
                for t in tpis:
                    run = lambda t=t: msm.bucket_reduce_tpi(  # noqa: E731
                        pts, ent, seg[:m + 1], F, b3, affine, t)
                    err = max(err, max_err(run(), ref[:m]))
                    row[f"tpi{t}_ms"] = cuda_ms(run, 3)
                level["sweep"].append(row)
        check(err == 0, f"K1 {stage} level {len(levels)}: differs from plain")
        ops = ent.numel() * add_muls(F, mixed=affine) * mul_ops(F)
        nbytes = 4 * (pts.numel() + ent.numel() + seg.numel() + got.numel())
        level["bound_ms"], level["bound_by"] = bound(ops, nbytes)
        level.update(ms=level[f"tpi{pick}_ms"], plain_ms=plain_ms,
                     max_abs_err=err)
        levels.append(level)
        if int(nch.max()) <= 1:
            return levels
        pts, affine = got, False
        ent = torch.arange(got.shape[0], dtype=torch.int32, device=dev) * 2
        seg, nch = msm.segments(nch, ent.numel())


# ---------------------------------------------------------------------------
# phase 2: K1 against its plain version
# ---------------------------------------------------------------------------


def k1_phase(stats: dict, tpis: dict) -> None:
    import torch

    from zecale_tpu_torch.ec import curve_torch as ct
    from zecale_tpu_torch.ec import host_curve as hc
    from zecale_tpu_torch.ec import msm
    from zecale_tpu_torch.ff import params as P
    from zecale_tpu_torch.ff.fp_torch import field

    dev = torch.device("cuda")
    for curve, g2 in (("bw6-761", False), ("bw6-761", True),
                      ("bls12-377", False), ("bls12-377", True)):
        t0 = time.time()
        F = ct.coord_field(curve, g2)
        b3 = ct.b3_of(curve, g2)
        g = msm.host_curve(curve, g2)
        gen = hc.generators(curve)[1 if g2 else 0]
        D = 1024
        pts = [gen]
        for _ in range(D - 1):
            pts.append(g.add(pts[-1], gen))
        xy, _ = ct.pack_affine(F, pts, dev)
        rng = random.Random(7)

        # crafted segments: first a block whose every warp at every TPI
        # mixes segments of 0, 1 and 32 entries (the warp's trip count and
        # the select), then empty, single, P+P, P+(-P), repeats, mixes
        segs = []
        for i in range(64):
            segs.append([[], [2 * rng.randrange(D)],
                         [2 * rng.randrange(D) + 1 for _ in range(msm.SEG)],
                         [2 * rng.randrange(D) for _ in range(
                             rng.randrange(2, msm.SEG))]][i % 4])
        for i in range(3000):
            kind = i % 6
            a, b = rng.randrange(D), rng.randrange(D)
            if kind == 0:
                segs.append([])
            elif kind == 1:
                segs.append([2 * a + rng.randrange(2)])
            elif kind == 2:
                segs.append([2 * a, 2 * a])
            elif kind == 3:
                segs.append([2 * a, 2 * a + 1, 2 * b])
            elif kind == 4:
                segs.append([2 * a] * rng.randrange(2, 9))
            else:
                segs.append([2 * rng.randrange(D) + rng.randrange(2)
                             for _ in range(rng.randrange(1, msm.SEG + 1))])
        ent = torch.tensor([e for s in segs for e in s], dtype=torch.int32,
                           device=dev)
        offs = [0]
        for s in segs:
            offs.append(offs[-1] + len(s))
        seg = torch.tensor(offs, dtype=torch.int32, device=dev)
        form = ct.form_of(F)
        got = msm.bucket_reduce(xy, ent, seg, F, b3, True)
        ref = msm.bucket_reduce_ref(xy, ent, seg, F, b3, True)
        torch.cuda.synchronize()
        err = int((got.long() - ref.long()).abs().max())
        check(err == 0, f"{curve} g2={g2}: edge-case partials differ")
        for t in tpis[form]:  # every built variant, not only the pick
            e = max_err(msm.bucket_reduce_tpi(xy, ent, seg, F, b3, True, t),
                        ref)
            check(e == 0, f"K1 {form} tpi={t}: edge-case partials differ")
        aff = ct.to_affine_host(F, got)
        check(aff == ct.to_affine_host(F, ref), "affine partials differ")
        for s, pt in list(zip(segs, aff))[:120]:
            want = None
            for e in s:
                q = pts[e >> 1]
                want = g.add(want, g.neg(q) if e & 1 else q)
            check(pt == want, f"{curve} g2={g2}: segment sum != host sum")
        # projective inputs: sums of the partials above
        e2 = torch.arange(got.shape[0], dtype=torch.int32, device=dev) * 2
        s2 = torch.arange(0, got.shape[0] + 1, 5, dtype=torch.int32,
                          device=dev)
        ref2 = msm.bucket_reduce_ref(got, e2, s2, F, b3, False)
        for t in [None] + tpis[form]:
            got2 = msm.bucket_reduce_tpi(got, e2, s2, F, b3, False, t)
            err = max(err, max_err(got2, ref2))
        check(err == 0, f"{curve} g2={g2}: projective partials differ")

        # the launches of one MSM at n = 2^16 (uniform scalars: the H
        # MSM's distribution), timed, for one group a form: the wrapper's
        # G1 (Fq 24), the nested G1 (Fq 12) and G2 (Fq2): the bucket
        # levels, then the subset sums.  BW6-761 G2 shares the Fq 24
        # variants and keeps the crafted segments above.
        levels, c = [], msm.default_window(1 << 16)
        if (curve, g2) != ("bw6-761", True):
            n = 1 << 16
            r = P.CURVES[curve].r
            Fr = field(r)
            scal = Fr.pack([rng.randrange(r) for _ in range(n)], dev)
            xy_n = xy[torch.arange(n, device=dev) % D].contiguous()
            inf = torch.zeros(n, dtype=torch.bool, device=dev)
            ent, counts = msm.bucket_entries(scal, inf, r.bit_length(), c)
            levels = k1_levels("buckets", F, b3, xy_n, ent, counts, True,
                               tpis[form])
            sums = msm.reduce_runs(xy_n, ent, counts, F, b3, True)
            W = msm.num_windows(r.bit_length(), c)
            ent, counts = msm.subset_entries(W, c, dev)
            levels += k1_levels("subsets", F, b3, sums, ent, counts, False,
                                tpis[form])
            err = max([err] + [lv["max_abs_err"] for lv in levels])
        stats[(curve, g2)] = {"max_abs_err": err, "levels": levels}
        tag = "[2b] " if len(F.shape) == 2 else ""
        b3s = "twist" if len(F.shape) == 2 else b3
        log(f"{tag}K1 {curve} {'G2' if g2 else 'G1'} b3={b3s}: every TPI "
            f"{tpis[form]} equal to plain (3064 crafted segments, affine and "
            f"projective, + {len(levels)} MSM-shape launches, c={c}); "
            f"{json.dumps(levels)} ({time.time() - t0:.1f}s)")


# ---------------------------------------------------------------------------
# phase 2c / 2d: K2 and K3 against their plain versions
# ---------------------------------------------------------------------------


def first_round(curve: str, n: int, c: int) -> int:
    """Width of the first combining round of an msm8 MSM: its largest K2
    launch."""
    from zecale_tpu_torch.ec import msm, msm8
    from zecale_tpu_torch.ff import params as P

    W = msm.num_windows(P.CURVES[curve].r.bit_length(), c)
    return msm8._round_schedule(W * n, W << (c - 1))[0]


def max_err(got, ref) -> int:
    return int((got.long() - ref.long()).abs().max()) if got.numel() else 0


def reps_for(n: int) -> int:
    """Launches to time at a batch of n: ~10 ms of work or more."""
    return 200 if n <= 1024 else 20 if n <= 65536 else 3


def sweep(name: str, run, ref, sizes, variants: dict, ops_per,
          bytes_per) -> dict:
    """Each variant of a kernel ({label: argument of run}) on the first n
    rows of the inputs, for each n of ``sizes``: equal to the plain
    version's rows, timed."""
    out = {}
    for n in sizes:
        row = {"n": n}
        row["bound_ms"], _ = bound(n * ops_per, n * bytes_per)
        for label, v in variants.items():
            got = run(n, v)
            check(max_err(got, ref[:n]) == 0,
                  f"{name} {label} n={n}: differs from plain")
            row[f"{label}_ms"] = cuda_ms(lambda v=v: run(n, v), reps_for(n))
        out[n] = row
    return out


def tpi_variants(tpis) -> dict:
    """K1-K6 sweep variants: one per built TPI."""
    return {f"tpi{t}": t for t in tpis}


#: batch sizes of the K3 / K5 sweep: the Horner fold's one point, msm8's
#: 35-window scan and the jac engine's 48-window bit-serial doublings
DBL_SWEEP_N = (1, 35, 48)


def dbl_check(name: str, run, plain, pts, ks, tpis, w: int) -> int:
    """Every TPI of K3 / K5 (run(x, k, tpi)) equal to the plain
    chain (plain(x, k)) on the crafted points, on one point and on w
    points, for each k of ``ks``; returns the largest error (0)."""
    err = 0
    for k in ks:
        ref = plain(pts, k)
        for label, v in tpi_variants(tpis).items():
            for n in (pts.shape[0], 1, w):
                e = max_err(run(pts[:n], k, v), ref[:n])
                check(e == 0, f"{name} {label} k={k} n={n}: differs from "
                      f"plain")
                err = max(err, e)
    return err


#: batch sizes of the K6 sweep below the table's shape: the setup's
#: fixed-base chunk
K6_SWEEP_N = (16384,)


#: batch sizes of the K2 / K4 sweep: a Horner add, a step of msm8's scan
#: 2, two sizes between, the setup's chunk, and at Fq 24 the jac engine's
#: first tiled round and msm8's first combining round
SWEEP_N = (1, 105, 1024, 4096, 16384, 49152, 1182721)


def sweep_sizes(form: str, big: int) -> list:
    """The table's shape first, then the sweep's sizes below it (all of
    them at Fq 24)."""
    return [big] + [n for n in SWEEP_N if n != big
                    and (form == "fq24" or n < big)]


def proj_phase(stats: dict, tpis: dict) -> None:
    import torch

    from zecale_tpu_torch.utils import build

    from zecale_tpu_torch.ec import curve_torch as ct
    from zecale_tpu_torch.ec import host_curve as hc
    from zecale_tpu_torch.ec import msm8
    from zecale_tpu_torch.ec import proj_curve as pc

    dev = torch.device("cuda")
    c_wrap = msm8.default_window(1 << 16)  # the wrapper's G1 queries
    # each form at the largest launch this script's msm8 paths give it:
    # the wrapper's BW6-761 G1 MSMs (n = 2^16), bench.py's BLS12-377 G1
    # shape (n = 2^18) and the BLS12-377 G2 MSM of phase 4 (n = 2^16)
    forms = {
        "fq24": ("bw6-761", False, first_round("bw6-761", 1 << 16, c_wrap)),
        "fq12": ("bls12-377", False, first_round(
            "bls12-377", 1 << 18, msm8.default_window(1 << 18))),
        "fq2": ("bls12-377", True, first_round(
            "bls12-377", 1 << 16, msm8.default_window(1 << 16))),
    }
    for form, (curve, g2, big) in forms.items():
        t0 = time.time()
        crv = pc.ProjCurve(curve, g2)
        F, b3 = crv.F, crv.b3
        g = hc.g2_curve(curve) if g2 else hc.g1_curve(curve)
        gen = hc.generators(curve)[1 if g2 else 0]
        D = 256
        pts = [gen]
        for _ in range(D - 1):
            pts.append(g.add(pts[-1], gen))
        xy, inf = ct.pack_affine(F, pts, dev)
        base = crv.from_affine(xy, inf)
        neg = crv.from_affine(torch.cat([xy[:, :1], F.neg(xy[:, 1:])], 1),
                              inf)

        # [2c] a few thousand pairs: O+O, O+P, P+O, P+P, P+(-P), P+Q, all
        # scaled by a random Z (the identity too: (0 : z : 0))
        B = 3000
        rng = random.Random(13)
        ia = torch.tensor([rng.randrange(D) for _ in range(B)], device=dev)
        ib = torch.tensor([rng.randrange(D) for _ in range(B)], device=dev)
        kind = torch.arange(B, device=dev) % 6
        ident = crv.identity_like(base[ia])
        lhs = crv.select(kind <= 1, ident, base[ia])
        rhs = crv.select((kind == 0) | (kind == 2), ident,
                         crv.select(kind == 3, base[ia],
                                    crv.select(kind == 4, neg[ia],
                                               base[ib])))
        H = F.host

        def scale(pt, seed):
            r = random.Random(seed)
            z = F.pack_mont([H.rand(r) for _ in range(B)], dev)
            z = z.unsqueeze(1).expand_as(pt)
            return F.mul(pt, z).contiguous()

        lhs, rhs = scale(lhs, 1), scale(rhs, 2)
        got = pc.proj_add(F, lhs, rhs, b3)
        ref = ct.proj_add(F, lhs, rhs, b3)
        torch.cuda.synchronize()
        err = max_err(got, ref)
        check(err == 0, f"K2 {form}: edge-case sums differ from plain")
        for t in tpis[form]:  # every built variant, not only the pick
            e = max_err(pc.proj_add_tpi(F, lhs, rhs, b3, t), ref)
            check(e == 0, f"K2 {form} tpi={t}: edge-case sums differ")
        aff_l, aff_r = crv.to_affine_host(lhs[:60]), crv.to_affine_host(
            rhs[:60])
        check(crv.to_affine_host(got[:60])
              == [g.add(p, q) for p, q in zip(aff_l, aff_r)],
              f"K2 {form}: sums differ from the host curve")
        t_ref = time.time()
        ct.proj_add(F, lhs, rhs, b3)
        torch.cuda.synchronize()
        small_plain_ms = (time.time() - t_ref) * 1e3

        # at the largest shape of the paths (Z = 1 inputs; the kernel's
        # time does not depend on the values), every variant against the
        # plain version and timed; at Fq 24 also the sweep of SWEEP_N
        gen_ = torch.Generator(device=dev).manual_seed(5)
        a = base[torch.randint(0, D, (big,), device=dev, generator=gen_)]
        b = base[torch.randint(0, D, (big,), device=dev, generator=gen_)]
        t_ref = time.time()
        ref = ct.proj_add(F, a, b, b3)
        torch.cuda.synchronize()
        plain_ms = (time.time() - t_ref) * 1e3
        ops_per, bytes_per = add_muls(F) * mul_ops(F), 3 * 3 * words(F) * 4
        run = lambda n, t: pc.proj_add_tpi(  # noqa: E731
            F, a[:n], b[:n], b3, t)
        sizes = sweep_sizes(form, big)
        swp = sweep(f"K2 {form}", run, ref, sizes, tpi_variants(tpis[form]),
                    ops_per, bytes_per)
        pick = build.add_tpi("proj_add", form, big)
        bms, bby = bound(big * ops_per, big * bytes_per)
        k2 = {"pairs": big, "tpi": pick, "ms": swp[big][f"tpi{pick}_ms"],
              "plain_ms": plain_ms, "plain_ms_3000": small_plain_ms,
              "bound_ms": bms, "bound_by": bby, "max_abs_err": err,
              "sweep": list(swp.values())}
        del a, b, got, ref
        log(f"[2c] K2 {form} ({curve} {'G2' if g2 else 'G1'}): every TPI "
            f"{tpis[form]} equal to plain on {B} edge-case pairs and at "
            f"{len(sizes)} sizes; {json.dumps(k2)} "
            f"({time.time() - t0:.1f}s)")

        # [2d] K3 for k = 1, 6 and the wrapper's window c, every TPI
        t0 = time.time()

        def plain3(x, k):
            for _ in range(k):
                x = ct.proj_dbl(F, x, b3)
            return x

        got = pc.proj_dbl_chain(F, lhs, c_wrap, b3)  # the table's pick
        err3 = max_err(got, plain3(lhs, c_wrap))
        check(err3 == 0, f"K3 {form}: differs from plain")
        check(crv.to_affine_host(got[:60])
              == [None if p is None else g.mul(1 << c_wrap, p)
                  for p in aff_l], f"K3 {form}: 2^c P differs from host")
        err3 = max(err3, dbl_check(
            f"K3 {form}", lambda x, k, t: pc.proj_dbl_chain_tpi(
                F, x, k, b3, t), plain3, lhs, (1, 6, c_wrap), tpis[form],
            35))
        log(f"[2d] K3 {form}: every TPI {tpis[form]} equal to plain for k = 1, 6, {c_wrap} on {B}, 1 and 35 points "
            f"({time.time() - t0:.1f}s)")
        # timed at the Horner fold's k on the batches of DBL_SWEEP_N
        t0 = time.time()
        nmax = max(DBL_SWEEP_N)
        pts = base[torch.randint(0, D, (nmax,), device=dev,
                                 generator=gen_)].contiguous()
        ref = plain3(pts, c_wrap)
        one = pts[:1]
        t_ref = time.time()
        plain3(one, c_wrap)
        torch.cuda.synchronize()
        plain_ms = (time.time() - t_ref) * 1e3
        ops_per = c_wrap * dbl_muls(F) * mul_ops(F)
        swp = sweep(f"K3 {form}", lambda n, t: pc.proj_dbl_chain_tpi(
            F, pts[:n], c_wrap, b3, t), ref, DBL_SWEEP_N,
            tpi_variants(tpis[form]), ops_per, 2 * 3 * words(F) * 4)
        tpi = build.dbl_tpi("proj_dbl_chain", form, 1)
        bms, bby = bound(ops_per, 2 * 3 * words(F) * 4)
        k3 = {"points": 1, "k": c_wrap, "tpi": tpi,
              "ms": swp[1][f"tpi{tpi}_ms"], "plain_ms": plain_ms,
              "bound_ms": bms, "bound_by": bby, "max_abs_err": err3,
              "sweep": list(swp.values())}
        stats[form] = {"proj_add": k2, "proj_dbl_chain": k3}
        log(f"[2d] K3 {form} timed: {json.dumps(k3)} "
            f"({time.time() - t0:.1f}s)")


# ---------------------------------------------------------------------------
# phase 2e: K4, K5 and K6 against their plain versions
# ---------------------------------------------------------------------------


def jac_phase(stats: dict, tpis: dict) -> None:
    import torch

    from zecale_tpu_torch.utils import build

    from zecale_tpu_torch.ec import curve_torch as ct
    from zecale_tpu_torch.ec import host_curve as hc
    from zecale_tpu_torch.ec import jac_curve as jc
    from zecale_tpu_torch.ec import msm_jac
    from zecale_tpu_torch.ff import params as P

    dev = torch.device("cuda")
    c = msm_jac.MSM_WINDOW_C

    def tiled_lanes(curve: str, n: int) -> int:
        """Lanes of the first tiled round of a jac-engine MSM (tiles of 64
        at n >= 4096): its largest K4 and K6 launches."""
        return msm_jac.num_windows(P.CURVES[curve].r.bit_length(), c) * (
            n // 64)

    # each form at the largest launch this script's jac paths give it: the
    # wrapper's BW6-761 G1 MSMs (n = 2^16), bench.py's BLS12-377 G1 shape
    # (n = 2^18) and the BLS12-377 G2 MSM of phase 4 (n = 2^16)
    forms = {
        "fq24": ("bw6-761", False, tiled_lanes("bw6-761", 1 << 16)),
        "fq12": ("bls12-377", False, tiled_lanes("bls12-377", 1 << 18)),
        "fq2": ("bls12-377", True, tiled_lanes("bls12-377", 1 << 16)),
    }
    for form, (curve, g2, big) in forms.items():
        t0 = time.time()
        crv = jc.JacCurve(curve, g2)
        F = crv.F
        g = hc.g2_curve(curve) if g2 else hc.g1_curve(curve)
        gen = hc.generators(curve)[1 if g2 else 0]
        D = 256
        pts = [gen]
        for _ in range(D - 1):
            pts.append(g.add(pts[-1], gen))
        xy, _ = ct.pack_affine(F, pts, dev)
        negxy = torch.cat([xy[:, :1], F.neg(xy[:, 1:])], 1)
        H = F.host
        B = 3000
        rng = random.Random(17)
        ia = torch.tensor([rng.randrange(D) for _ in range(B)], device=dev)
        ib = (ia + torch.tensor([rng.randrange(1, D) for _ in range(B)],
                                device=dev)) % D  # ib != ia
        fin = torch.zeros(B, dtype=torch.bool, device=dev)

        def zs(seed):
            r = random.Random(seed)
            return F.pack_mont([H.rand(r) for _ in range(B)], dev)

        def scaled(aff, z):
            """(x z^2, y z^3, z): the point with Jacobian scale z."""
            z2 = F.mul(z, z)
            return torch.stack([F.mul(aff[:, 0], z2),
                                F.mul(aff[:, 1], F.mul(z2, z)), z], 1)

        def pick(choices, idx):
            return torch.stack(choices)[idx, torch.arange(B, device=dev)]

        z1, z2 = zs(1), zs(2)
        pa, pa2, na = scaled(xy[ia], z1), scaled(xy[ia], z2), scaled(
            negxy[ia], z2)
        qb = scaled(xy[ib], z2)
        zero = torch.zeros_like(pa)
        garbage = crv.mask(scaled(xy[ib], zs(3)), fin)  # X, Y != 0, Z = 0
        kind = torch.arange(B, device=dev) % 7
        # O+O, O+P, P+O, P+P (one triple), P+P (other Z), P+(-P), P+Q
        tab_l = torch.tensor([0, 1, 2, 2, 2, 2, 2], device=dev)
        tab_r = torch.tensor([0, 3, 1, 2, 3, 4, 5], device=dev)
        lhs = pick([zero, garbage, pa], tab_l[kind])
        rhs = pick([zero, garbage, pa, pa2, na, qb], tab_r[kind])
        got = jc.jac_add(F, lhs, rhs)
        ref = ct.jac_add(F, lhs, rhs)
        torch.cuda.synchronize()
        err4 = max_err(got, ref)
        check(err4 == 0, f"K4 {form}: crafted sums differ from plain")
        for t in tpis[form]:  # every built variant, not only the pick
            e = max_err(jc.jac_add_tpi(F, lhs, rhs, t), ref)
            check(e == 0, f"K4 {form} tpi={t}: crafted sums differ")
        aff_l = crv.to_affine_host(lhs[:70])
        aff_r = crv.to_affine_host(rhs[:70])
        check(crv.to_affine_host(got[:70])
              == [g.add(p, q) for p, q in zip(aff_l, aff_r)],
              f"K4 {form}: sums differ from the host curve")
        def plain5(x, k):
            for _ in range(k):
                x = ct.jac_dbl(F, x)
            return x

        got5 = jc.jac_dbl_chain(F, lhs, c)  # the table's pick
        err5 = max_err(got5, plain5(lhs, c))
        check(err5 == 0, f"K5 {form}: differs from plain")
        check(crv.to_affine_host(got5[:70])
              == [None if p is None else g.mul(1 << c, p) for p in aff_l],
              f"K5 {form}: 2^c P differs from the host curve")
        err5 = max(err5, dbl_check(
            f"K5 {form}", lambda x, k, t: jc.jac_dbl_chain_tpi(
                F, x, k, t), plain5, lhs, (1, 3, c), tpis[form], 48))
        # K6: O+P, P+O, O+O (nonzero x, y at infinity), P+P, P+(-P), P+Q
        inf_l = (kind == 0) | (kind == 2)
        inf_r = (kind == 1) | (kind == 2)
        a6 = xy[ia].clone()
        b6 = pick([xy[ib], xy[ia], negxy[ia]],
                  torch.tensor([0, 0, 0, 1, 2, 0, 0], device=dev)[kind])
        got6 = jc.aff_add(F, a6, inf_l, b6, inf_r)
        ref6 = ct.aff_add(F, a6, inf_l, b6, inf_r)
        torch.cuda.synchronize()
        err6 = max_err(got6, ref6)
        check(err6 == 0, f"K6 {form}: crafted sums differ from plain")
        for t in tpis[form]:  # every built variant, not only the pick
            e = max_err(jc.aff_add_tpi(F, a6, inf_l, b6, inf_r, t), ref6)
            check(e == 0, f"K6 {form} tpi={t}: crafted sums differ")
        h_l = crv.to_affine_host(crv.lift(a6[:70], inf_l[:70]))
        h_r = crv.to_affine_host(crv.lift(b6[:70], inf_r[:70]))
        check(crv.to_affine_host(got6[:70])
              == [g.add(p, q) for p, q in zip(h_l, h_r)],
              f"K6 {form}: sums differ from the host curve")
        log(f"[2e] K4/K5/K6 {form} ({curve} {'G2' if g2 else 'G1'}): equal "
            f"to plain on {B} crafted cases each, in every built TPI "
            f"(K5 k = 1, 3, {c}, also on 1 and 48 points) "
            f"({time.time() - t0:.1f}s)")

        # timed at the largest launch of the paths, on finite distinct
        # points: every lane takes the generic formulas; K4 in every TPI
        # variant, at Fq 24 also at the sizes of SWEEP_N
        t0 = time.time()
        nb = max(big, *SWEEP_N) if form == "fq24" else big
        gen_ = torch.Generator(device=dev).manual_seed(5)
        ja = torch.randint(0, D, (nb,), device=dev, generator=gen_)
        jb = (ja + torch.randint(1, D, (nb,), device=dev,
                                 generator=gen_)) % D
        zbig = F.mul(xy[ja][:, 0], xy[jb][:, 1])  # nonzero w.h.p.
        z2b = F.mul(zbig, zbig)
        p4 = torch.stack([F.mul(xy[ja][:, 0], z2b),
                          F.mul(xy[ja][:, 1], F.mul(z2b, zbig)), zbig], 1)
        fin = torch.zeros(nb, dtype=torch.bool, device=dev)
        q4 = crv.lift(xy[jb], fin)
        del zbig, z2b
        out = {}
        W = words(F)
        t_ref = time.time()
        ref = ct.jac_add(F, p4[:big], q4[:big])
        torch.cuda.synchronize()
        plain_ms = (time.time() - t_ref) * 1e3
        if nb > big:
            ref = ct.jac_add(F, p4, q4)
        ops_per, bytes_per = jac_muls(F, "add") * mul_ops(F), 9 * W * 4
        run = lambda n, t: jc.jac_add_tpi(  # noqa: E731
            F, p4[:n], q4[:n], t)
        sizes = sweep_sizes(form, big)
        swp = sweep(f"K4 {form}", run, ref, sizes, tpi_variants(tpis[form]),
                    ops_per, bytes_per)
        pick = build.add_tpi("jac_add", form, big)
        bms, bby = bound(big * ops_per, big * bytes_per)
        out["jac_add"] = {"lanes": big, "tpi": pick,
                          "ms": swp[big][f"tpi{pick}_ms"],
                          "plain_ms": plain_ms, "bound_ms": bms,
                          "bound_by": bby, "max_abs_err": err4,
                          "sweep": list(swp.values())}
        del ref
        # K6 in every TPI at the tiled round's lanes and the setup's chunk
        xa, xb, fb = xy[ja[:big]], xy[jb[:big]], fin[:big]
        t_ref = time.time()
        ref = ct.aff_add(F, xa, fb, xb, fb)
        torch.cuda.synchronize()
        plain_ms = (time.time() - t_ref) * 1e3
        ops_per = jac_muls(F, "aff") * mul_ops(F)
        bytes_per = 4 * W * 4 + 2 + 3 * W * 4
        run = lambda n, t: jc.aff_add_tpi(  # noqa: E731
            F, xa[:n], fb[:n], xb[:n], fb[:n], t)
        sizes = [big] + [n for n in K6_SWEEP_N if n < big]
        swp = sweep(f"K6 {form}", run, ref, sizes,
                    tpi_variants(tpis[form]), ops_per, bytes_per)
        pick = build.sum_tpi("aff_add", form, big)
        bms, bby = bound(big * ops_per, big * bytes_per)
        out["aff_add"] = {"lanes": big, "tpi": pick,
                          "ms": swp[big][f"tpi{pick}_ms"],
                          "plain_ms": plain_ms, "bound_ms": bms,
                          "bound_by": bby, "max_abs_err": err6,
                          "sweep": list(swp.values())}
        del ref
        # K5 at the Horner fold's k on the batches of DBL_SWEEP_N
        pts = p4[:max(DBL_SWEEP_N)].contiguous()
        ref = plain5(pts, c)
        t_ref = time.time()
        plain5(pts[:1], c)
        torch.cuda.synchronize()
        plain_ms = (time.time() - t_ref) * 1e3
        ops_per = c * jac_muls(F, "dbl") * mul_ops(F)
        swp = sweep(f"K5 {form}", lambda n, t: jc.jac_dbl_chain_tpi(
            F, pts[:n], c, t), ref, DBL_SWEEP_N, tpi_variants(tpis[form]),
            ops_per, 2 * 3 * W * 4)
        tpi = build.dbl_tpi("jac_dbl_chain", form, 1)
        bms, bby = bound(ops_per, 2 * 3 * W * 4)
        out["jac_dbl_chain"] = {"points": 1, "k": c, "tpi": tpi,
                                "ms": swp[1][f"tpi{tpi}_ms"],
                                "plain_ms": plain_ms, "bound_ms": bms,
                                "bound_by": bby, "max_abs_err": err5,
                                "sweep": list(swp.values())}
        stats[form] = out
        log(f"[2e] K4/K5/K6 {form} timed: {json.dumps(out)} "
            f"({time.time() - t0:.1f}s)")


# ---------------------------------------------------------------------------
# phase 3: the wrapper proof
# ---------------------------------------------------------------------------


def keypair_fields(kp) -> tuple:
    """Every point of a Groth16 keypair, for comparing two keypairs."""
    return (tuple(getattr(kp.pk, k) for k in (
        "alpha_g1", "beta_g1", "beta_g2", "delta_g1", "delta_g2", "a_query",
        "b_g1_query", "b_g2_query", "l_query", "h_query")),
        tuple(getattr(kp.vk, k) for k in ("alpha", "beta", "delta", "abc")))


def prove_phase() -> dict:
    import torch

    from zecale_tpu_torch.aggregate_e2e import DeviceProver
    from zecale_tpu_torch.aggregator import dummy_app as da
    from zecale_tpu_torch.aggregator.circuit import AggregatorCircuit
    from zecale_tpu_torch.ec import host_curve as hc
    from zecale_tpu_torch.snark import setup_native
    from zecale_tpu_torch.snark.groth16 import (
        ExtendedProof, Groth16, Groth16Proof)
    from zecale_tpu_torch.snark.groth16_torch import Groth16Torch

    cache = os.path.join(tempfile.gettempdir(), "zecale_tpu_torch_cache")
    os.makedirs(cache, exist_ok=True)
    host_w = Groth16("bw6-761")
    host_n = Groth16("bls12-377")
    prover = Groth16Torch("bw6-761", engine="msm4")
    prover8 = Groth16Torch("bw6-761", engine="msm8")
    prover_j = Groth16Torch("bw6-761", engine="jac")
    counts = {}

    # a small input against the host prover: same rng, same proof
    t0 = time.time()
    r1cs_s, kp_s = da.dummy_app_setup("bw6-761", random.Random(5))
    asg = da.dummy_app_assignment("bw6-761", 9)
    want = host_w.prove(r1cs_s, kp_s.pk, asg, random.Random(77))
    got = prover.prove(r1cs_s, kp_s.pk, asg, random.Random(77))
    check(got == want, "dummy-app proof on the card != host prover's proof")
    log(f"[3a] BW6-761 dummy-app proof on the card equals the host "
        f"prover's ({time.time() - t0:.1f}s)")

    # the nested application's keypair, from the host setup and again from
    # the device setup (K4 and K6 over Fq 12 and Fq2) from one rng state
    rng = random.Random(11)
    t0 = time.time()
    state = rng.getstate()
    r1cs_n, nkp = da.dummy_app_setup("bls12-377", rng)
    r = random.Random()
    r.setstate(state)
    reset_counts()
    nkp_dev = Groth16Torch("bls12-377").generate_setup(r1cs_n, r)
    torch.cuda.synchronize()
    counts["nested setup"] = read_counts()
    check(keypair_fields(nkp_dev) == keypair_fields(nkp),
          "nested device setup != host setup from the same rng state")
    for name in ("jac_add", "aff_add"):
        by_form = counts["nested setup"][name]["by_form"]
        check(by_form.get("fq12", 0) > 0 and by_form.get("fq2", 0) > 0,
              f"{name} not launched in both forms by the nested setup")
    log(f"[3b] nested BLS12-377 keypair from the device setup equals the "
        f"host setup's; launches {json.dumps(counts['nested setup'])} "
        f"({time.time() - t0:.1f}s)")

    # the nested application proof, made on the card (G2 over Fq2) from
    # the rng state the host prover is given too
    t0 = time.time()
    asg_n = da.dummy_app_assignment("bls12-377", 7)
    rng_host = random.Random()
    rng_host.setstate(rng.getstate())
    want = host_n.prove(r1cs_n, nkp.pk, asg_n, rng_host)
    reset_counts()
    t1 = time.time()
    nested = Groth16Torch("bls12-377", engine="msm4").prove(
        r1cs_n, nkp.pk, asg_n, rng)
    torch.cuda.synchronize()
    nested_s = time.time() - t1
    counts["nested"] = read_counts()
    check(nested == want, "nested proof on the card != host prover's proof")
    check(host_n.verify([7], nested, nkp.vk), "nested proof does not verify")
    fq2 = counts["nested"]["bucket_reduce"]["by_form"].get("fq2", 0)
    check(fq2 > 0, "bucket_reduce (Fq2) never launched in the nested prove")
    eps = [ExtendedProof(proof=nested, inputs=[7])]
    log(f"[3b] nested BLS12-377 dummy-app proof made on the card "
        f"({nested_s:.2f}s), equal to the host prover's, valid; launches "
        f"{json.dumps(counts['nested'])} ({time.time() - t0:.1f}s)")

    # the circuit holds witness closures and cannot be pickled: rebuilt
    t0 = time.time()
    circ = AggregatorCircuit(1, 1)
    r1cs = circ.r1cs
    log(f"[3c] circuit built: {r1cs.num_constraints} constraints, "
        f"{r1cs.num_variables} variables, domain {r1cs.qap_degree} "
        f"({time.time() - t0:.1f}s)")

    # the wrapper's trusted setup: native (cached under a hash of the rng
    # state and the circuit's size), then on the card from the same state
    t0 = time.time()
    state = rng.getstate()
    key = hashlib.sha256(repr(state).encode()).hexdigest()[:16]
    kp_path = os.path.join(
        cache, f"keypair_b1_{r1cs.num_constraints}_{key}.pkl")
    if os.path.exists(kp_path):
        with open(kp_path, "rb") as f:
            wkp = pickle.load(f)
        how = f"keypair loaded from {kp_path}"
    else:
        r = random.Random()
        r.setstate(state)
        wkp = setup_native.generate_setup("bw6-761", r1cs, r)
        with open(kp_path + ".tmp", "wb") as f:
            pickle.dump(wkp, f)
        os.replace(kp_path + ".tmp", kp_path)
        how = "native setup"
    log(f"[3d] {how} ({time.time() - t0:.1f}s)")
    # [3j] a first, empty profile: the profiler's start-up is paid here and
    # not inside the setup or a prove below
    profiled(lambda: torch.zeros(1, device="cuda") + 1)
    profiles, hists = {}, {}
    reset_counts()
    timings = {}
    with Launches() as rec:
        wkp_dev, profiles["device setup"] = profiled(
            lambda: prover_j.generate_setup(r1cs, rng, timings=timings))
    setup_s = profiles["device setup"]["wall_s"]  # not the trace's reading
    counts["setup"] = read_counts()
    hists["device setup"] = rec.histogram(
        profiles["device setup"]["launch_us"])
    check(keypair_fields(wkp_dev) == keypair_fields(wkp),
          "wrapper device setup != native setup from the same rng state")
    for name in ("jac_add", "aff_add"):
        check(counts["setup"][name]["launches"] > 0,
              f"{name} never launched during the device setup")
    setup_phases = {k: round(v, 3) for k, v in timings.items()}
    log(f"[3d] wrapper device setup ({setup_s:.1f}s, under the profiler) "
        f"equals the native setup's keypair; launches "
        f"{json.dumps(counts['setup'])}; phases {json.dumps(setup_phases)}")
    log_profile("device setup", profiles, hists)

    t0 = time.time()
    dpk = prover.pack_pk(wkp.pk, r1cs.num_primary + 1)
    torch.cuda.synchronize()
    log(f"[3e] pack_pk: G1 queries {dpk.n_g1}, G2 query {dpk.n_g2} "
        f"({time.time() - t0:.1f}s)")

    vk_hash = circ.compute_nested_vk_hash(nkp.vk)
    state = rng.getstate()
    runs = {}
    # msm4, then msm8 and jac from the same rng state, then msm4 again:
    # the first prove pays one-time host packing, so phases compare warm to
    # warm.  All but the first run under the profiler ([3j])
    for tag, eng, run in (("[3f]", prover, "msm4"),
                          ("[3g]", prover8, "msm8"),
                          ("[3g]", prover_j, "jac"),
                          ("[3g]", prover, "msm4 warm")):
        dev_prover = DeviceProver(eng, dpk)
        r = random.Random()
        r.setstate(state)
        reset_counts()
        t0 = time.time()
        go = lambda: circ.prove(  # noqa: E731
            nkp.vk, eps, wkp.pk, r, prover=dev_prover, check=True)
        if run == "msm4":
            wep = go()
            prove_s = time.time() - t0
        else:
            with Launches() as rec:
                wep, profiles[f"{run} prove"] = profiled(go)
            hists[f"{run} prove"] = rec.histogram(
                profiles[f"{run} prove"]["launch_us"])
            prove_s = profiles[f"{run} prove"]["wall_s"]
        counts[run] = read_counts()
        phases = {k: round(v, 3) for k, v in dev_prover.last_timings.items()}
        runs[run] = {"wep": wep, "prove_s": prove_s, "phases": phases}
        log(f"{tag} wrapper proof on the card, engine {run} "
            f"({prove_s:.1f}s{'' if run == 'msm4' else ', under the profiler'}"
            f"); launches {json.dumps(counts[run])}; "
            f"prover phases {json.dumps(phases)}")
        if run != "msm4":
            log_profile(f"{run} prove", profiles, hists)
        if run == "msm4 warm":
            break
        t0 = time.time()
        check(host_w.verify(wep.inputs, wep.proof, wkp.vk),
              f"{run} wrapper proof does not verify")
        check(list(wep.inputs) == [vk_hash, 1, 7],
              f"primary layout {wep.inputs[:3]} != [vk_hash, 1, 7]")
        log(f"{tag} {run} wrapper proof verifies; layout "
            f"[vk_hash, 1, 7] ({time.time() - t0:.1f}s)")
    check(runs["msm4 warm"]["wep"].proof == runs["msm4"]["wep"].proof,
          "a second msm4 wrapper proof from the same rng state differs")
    del counts["msm4 warm"]  # a repeat, not another path
    c4, c8 = counts["msm4"], counts["msm8"]
    check(c4["bucket_reduce"]["launches"] > 0,
          "bucket_reduce never launched during the msm4 prove")
    for name in ("proj_add", "proj_dbl_chain"):
        check(c8[name]["launches"] > 0,
              f"{name} never launched during the msm8 prove")
    for name in ("jac_add", "jac_dbl_chain", "aff_add"):
        check(counts["jac"][name]["launches"] > 0,
              f"{name} never launched during the jac prove")
    wep = runs["msm4"]["wep"]
    for run in ("msm8", "jac"):
        check(runs[run]["wep"].proof == wep.proof
              and runs[run]["wep"].inputs == wep.inputs,
              f"{run} wrapper proof != msm4 wrapper proof")
    log("[3g] msm8 and jac wrapper proofs equal the msm4 one bit for bit")
    rng.setstate(state)

    t0 = time.time()
    bad = [ExtendedProof(proof=eps[0].proof, inputs=[999])]
    dev_prover = DeviceProver(prover, dpk)
    wep2 = circ.prove(nkp.vk, bad, wkp.pk, rng, prover=dev_prover,
                      check=True)
    check(wep2.inputs[1] == 0, "corrupt nested proof did not give bit 0")
    check(host_w.verify(wep2.inputs, wep2.proof, wkp.vk),
          "wrapper of a corrupt nested proof does not verify")
    phases = {k: round(v, 3) for k, v in dev_prover.last_timings.items()}
    log(f"[3h] corrupt nested proof: result bit 0, wrapper valid; its msm4 "
        f"prove (warm, not profiled) phases {json.dumps(phases)} "
        f"({time.time() - t0:.1f}s)")

    t0 = time.time()
    g1 = hc.g1_curve("bw6-761")
    tampered = Groth16Proof(
        a=wep.proof.a, b=wep.proof.b,
        c=g1.add(wep.proof.c, hc.generators("bw6-761")[0]),
    )
    check(not host_w.verify(wep.inputs, tampered, wkp.vk),
          "tampered wrapper proof accepted")
    log(f"[3i] tampered wrapper proof rejected ({time.time() - t0:.1f}s)")

    return {"counts": counts, "setup_s": setup_s, "profiles": profiles,
            "hists": hists,
            "runs": {k: {"prove_s": v["prove_s"], "phases": v["phases"]}
                     for k, v in runs.items()},
            "nested_kp": nkp, "nested_proof": nested, "wrapper_kp": wkp,
            "vk_hash": vk_hash}


# ---------------------------------------------------------------------------
# phase 4: bench.py's MSM shape on the three engines
# ---------------------------------------------------------------------------


def bench_phase() -> dict:
    import torch

    from zecale_tpu_torch.ec import curve_torch as ct
    from zecale_tpu_torch.ec import host_curve as hc
    from zecale_tpu_torch.ec import msm, msm8, msm_jac
    from zecale_tpu_torch.ff import params as P
    from zecale_tpu_torch.ff.fp_torch import field

    dev = torch.device("cuda")
    out = {}
    for curve, g2, n in (("bls12-377", False, 1 << 18),
                         ("bls12-377", True, 1 << 16)):
        t0 = time.time()
        name = f"{curve} {'G2' if g2 else 'G1'} n=2^{n.bit_length() - 1}"
        r = P.CURVES[curve].r
        g = hc.g2_curve(curve) if g2 else hc.g1_curve(curve)
        # bench.py:86-92: uniform scalars from Random(42), 64 bases cycled
        rng = random.Random(42)
        scalars = [rng.randrange(r) for _ in range(n)]
        base, pt = [], hc.generators(curve)[1 if g2 else 0]
        for _ in range(64):
            base.append(pt)
            pt = g.dbl(pt)
        folded = [0] * 64
        for i, s_ in enumerate(scalars):
            folded[i % 64] = (folded[i % 64] + s_) % r
        want = g.msm(folded, base)
        F = ct.coord_field(curve, g2)
        xy64, _ = ct.pack_affine(F, base, dev)
        xy = xy64[torch.arange(n, device=dev) % 64].contiguous()
        inf = torch.zeros(n, dtype=torch.bool, device=dev)
        scal = field(r).pack(scalars, dev)
        res = {}
        for engine, fn in (("msm4", msm.msm), ("msm8", msm8.msm8),
                           ("jac", msm_jac.msm)):
            fn(curve, g2, scal, xy, inf)  # warm-up
            torch.cuda.synchronize()
            t1 = time.time()
            got = fn(curve, g2, scal, xy, inf)
            torch.cuda.synchronize()
            dt = time.time() - t1
            check(got == want, f"{name} {engine}: MSM != folded host MSM")
            res[engine] = {"s": dt, "mpoints_per_s": n / dt / 1e6}
        out[name] = res
        log(f"[4] {name}: all three engines equal the folded host MSM; "
            f"{json.dumps(res)} ({time.time() - t0:.1f}s)")
    return out


# ---------------------------------------------------------------------------
# phase 3k: the served path
# ---------------------------------------------------------------------------


def wire_codecs() -> dict:
    """method -> (request schema, client request -> wire, wire -> service
    request, response schema, service response -> wire, wire -> client
    response): the protobuf transport of api/grpc_server.py, which imports
    grpc, and of the reference's client/aggregator_client.py."""
    from zecale_tpu_torch.serialization import protowire as pw

    same = lambda m: m  # noqa: E731
    return {
        "GetConfiguration": (pw.EMPTY, same, same,
                             pw.AGGREGATOR_CONFIGURATION,
                             pw.config_to_proto, pw.config_from_proto),
        "GetNestedVerificationKeyHash": (
            pw.VERIFICATION_KEY, pw.vk_to_proto, pw.vk_from_proto,
            pw.VERIFICATION_KEY_HASH, same, same),
        "RegisterApplication": (
            pw.APPLICATION_DESCRIPTION,
            lambda d: {"application_name": d["application_name"],
                       "vk": pw.vk_to_proto(d["vk"])},
            lambda m: {"application_name": m["application_name"],
                       "vk": pw.vk_from_proto(m["vk"])},
            pw.VERIFICATION_KEY_HASH, same, same),
        "SubmitNestedTransaction": (
            pw.NESTED_TRANSACTION, pw.nested_tx_to_proto,
            pw.nested_tx_from_proto, pw.EMPTY, same, lambda m: {}),
        "GenerateAggregatedTransaction": (
            pw.AGGREGATED_TRANSACTION_REQUEST, same, same,
            pw.AGGREGATED_TRANSACTION, pw.agg_tx_to_proto,
            pw.agg_tx_from_proto),
    }


def served_phase(pp: dict) -> dict:
    """[3k] The aggregator service built by server_main.build_service
    (batch 1, prover torch, the [3d] keypair loaded from a file), driven
    request by request with each request and answer carried through the
    protobuf wire format."""
    import torch

    from zecale_tpu_torch.aggregator import dummy_app as da
    from zecale_tpu_torch.api import server_main
    from zecale_tpu_torch.api.service import ServiceError
    from zecale_tpu_torch.serialization import json_codec as jc
    from zecale_tpu_torch.serialization import protowire as pw
    from zecale_tpu_torch.snark.groth16 import ExtendedProof, Groth16

    codecs = wire_codecs()
    nkp, wkp, vk_hash = pp["nested_kp"], pp["wrapper_kp"], pp["vk_hash"]
    t0 = time.time()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "keypair.bin")
        with open(path, "wb") as f:
            pickle.dump(wkp, f)
        svc, _ = server_main.build_service(
            ["--batch-size", "1", "--prover", "torch", "--keypair", path])
    log(f"[3k] service built by server_main (batch 1, prover torch, "
        f"keypair loaded) ({time.time() - t0:.1f}s)")
    # each aggregation's split: the prover's phases, whose "witness" holds
    # the per-request repack of the proving key, timed here on its own
    repack, phases = [], []
    prover = svc.prover
    pack_pk, prove = prover.pack_pk, prover.prove

    def timed_pack(*args):
        t = time.time()
        out = pack_pk(*args)
        torch.cuda.synchronize()
        repack.append(round(time.time() - t, 3))
        return out

    def timed_prove(*args, **kw):
        t = {}
        out = prove(*args, timings=t, **kw)
        phases.append({k: round(v, 3) for k, v in t.items()})
        return out

    prover.pack_pk, prover.prove = timed_pack, timed_prove

    def call(method, handler, request):
        req_s, to_wire, from_wire, resp_s, resp_to, resp_from = \
            codecs[method]
        t = time.time()
        got = handler(from_wire(pw.decode(req_s, pw.encode(
            req_s, to_wire(request)))))
        out = resp_from(pw.decode(resp_s, pw.encode(resp_s, resp_to(got))))
        return out, time.time() - t

    seconds = {}
    cfg, seconds["get_configuration"] = call(
        "GetConfiguration", lambda _: svc.get_configuration(), {})
    check(cfg["nested_pairing_parameters"]["name"] == "bls12-377"
          and cfg["wrapper_pairing_parameters"]["name"] == "bw6-761",
          "configuration names the wrong curves")
    vk_json = jc.groth16_vk_to_json("bls12-377", nkp.vk)
    h1, seconds["register_application"] = call(
        "RegisterApplication",
        lambda m: {"hash": svc.register_application(m["application_name"],
                                                    m["vk"])},
        {"application_name": "app", "vk": vk_json})
    h2, seconds["get_nested_verification_key_hash"] = call(
        "GetNestedVerificationKeyHash",
        lambda m: {"hash": svc.get_nested_verification_key_hash(m)},
        vk_json)
    check(h1["hash"] == h2["hash"] == jc.fr_to_json("bw6-761", vk_hash),
          "registration and vk-hash requests give different hashes")

    def submit(tx):
        svc.submit_nested_transaction(tx)
        return {}

    # the [3b] proof (a = 7, made on the card) at fee 5, a host proof of
    # a = 8 at fee 10: the pool answers the higher fee first
    proofs = {7: pp["nested_proof"],
              8: da.dummy_app_prove("bls12-377", nkp, 8,
                                    random.Random(3)).proof}
    txs = {a: {"app_name": "app",
               "extended_proof": jc.extended_proof_to_json(
                   "bls12-377", ExtendedProof(proofs[a], [a])),
               "parameters": f"{a:02x}", "fee_in_wei": fee}
           for a, fee in ((7, 5), (8, 10))}
    for a in (7, 8):
        _, seconds[f"submit a={a}"] = call("SubmitNestedTransaction",
                                           submit, txs[a])
    bad = json.loads(json.dumps(txs[7]))
    bad["extended_proof"]["proof"]["a"][0] = "0x" + "11" * 48
    try:
        call("SubmitNestedTransaction", submit, bad)
        raise RuntimeError("check failed: off-curve proof point accepted")
    except ServiceError as e:
        log(f"[3k] off-curve proof point refused: {e}")

    host_w = Groth16("bw6-761")
    reset_counts()
    answers = []
    for i in range(2):
        agg, s_ = call("GenerateAggregatedTransaction",
                       lambda m: svc.generate_aggregated_transaction(
                           m["application_name"]),
                       {"application_name": "app"})
        seconds[f"generate_aggregated_transaction {i + 1}"] = s_
        answers.append(agg)
    torch.cuda.synchronize()
    counts = read_counts()
    check(counts["bucket_reduce"]["launches"] > 0,
          "bucket_reduce never launched by the served aggregation")
    for agg, a in zip(answers, (8, 7)):
        ep = jc.extended_proof_from_json("bw6-761", agg["ext_proof"])
        check(agg["app_name"] == "app"
              and agg["nested_parameters"] == [f"{a:02x}"],
              f"aggregated transaction of a = {a} out of fee order")
        check(list(ep.inputs) == [vk_hash, 1, a],
              f"served layout {ep.inputs} != [vk_hash, 1, {a}]")
        t = time.time()
        check(host_w.verify(ep.inputs, ep.proof, wkp.vk),
              f"served wrapper proof of a = {a} does not verify")
        seconds[f"host verify a={a}"] = time.time() - t
    try:
        call("GenerateAggregatedTransaction",
             lambda m: svc.generate_aggregated_transaction(
                 m["application_name"]), {"application_name": "app"})
        raise RuntimeError("check failed: empty pool gave a batch")
    except ServiceError as e:
        log(f"[3k] empty pool refused: {e}")
    check(len(repack) == len(phases) == 2,
          "the service did not repack and prove once an aggregation")
    log(f"[3k] served path: two aggregated proofs in fee order (a = 8, "
        f"then 7), valid with inputs [vk_hash, 1, a]; seconds per request "
        f"{json.dumps({k: round(v, 3) for k, v in seconds.items()})}; "
        f"key repack s {repack}; prover phases {json.dumps(phases)}; "
        f"launches of the two aggregations {json.dumps(counts)}")
    return {"counts": counts, "seconds": seconds}


# ---------------------------------------------------------------------------
# phase 4b: the port's bench main
# ---------------------------------------------------------------------------

#: the keys of bench.py's JSON line (bench.py:189-203)
BENCH_KEYS = ("metric", "value", "unit", "vs_baseline", "engine", "points",
              "aggregated_proofs_per_s", "e2e_batch", "e2e_warm_prove_s",
              "e2e_cold_prove_s")


def bench_entry_phase() -> dict:
    """[4b] zecale_tpu_torch.bench in this process at its default shape,
    without its e2e subprocess."""
    from zecale_tpu_torch import bench

    t0 = time.time()
    saved = os.environ.get("BENCH_E2E")
    os.environ["BENCH_E2E"] = "0"
    try:
        ok, out = bench.run()
    finally:
        if saved is None:
            del os.environ["BENCH_E2E"]
        else:
            os.environ["BENCH_E2E"] = saved
    check(ok, "bench: MSM != host oracle")
    check(tuple(out) == BENCH_KEYS, f"bench keys {list(out)}")
    log(f"[4b] bench main: host-oracle check passed; its line "
        f"{json.dumps(out)} ({time.time() - t0:.1f}s)")
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke runs only on a GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from zecale_tpu_torch.utils import build

    card = smi()
    log(f"[1] card: {card}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}")
    t0 = time.time()
    build.cuda_kernels()
    build_s = time.time() - t0
    for line in build.build_report():
        log(f"[1] built {line}")
    log(f"[1] kernel build {build_s:.1f}s, {len(build.last_build)} nvcc "
        f"jobs started together (budget 60s)")
    sass = sass_counts({stem: info["path"]
                        for stem, info in build.last_build.items()})
    for lib, counts in sorted(sass.items()):
        log(f"[1] SASS of {lib}: {json.dumps(counts)}")

    t0 = time.time()
    stats = {}
    k1_phase(stats, build.ADD_TPIS)
    log(f"[2] K1 checks done ({time.time() - t0:.1f}s)")
    t0 = time.time()
    pstats = {}
    proj_phase(pstats, build.ADD_TPIS)
    log(f"[2] K2 / K3 checks done ({time.time() - t0:.1f}s)")
    t0 = time.time()
    jstats = {}
    jac_phase(jstats, build.ADD_TPIS)
    log(f"[2] K4 / K5 / K6 checks done ({time.time() - t0:.1f}s)")

    main_path = prove_phase()
    main_path["counts"]["served"] = served_phase(main_path)["counts"]
    t0 = time.time()
    bench_phase()
    log(f"[4] bench shapes done ({time.time() - t0:.1f}s)")
    bench_entry_phase()

    def launches(name):
        return sum(c[name]["launches"] for c in main_path["counts"].values())

    main_level = stats[("bw6-761", False)]["levels"][0]
    k2 = pstats["fq24"]["proj_add"]
    k3 = pstats["fq24"]["proj_dbl_chain"]
    entry = lambda name, src, line, d, err: {  # noqa: E731
        "name": name, "route": "cuda",
        "source": f"zecale_tpu_torch/csrc/{src}", "replaces": line,
        "launches": launches(name), "max_abs_err": err, "ms": d["ms"],
        "plain_ms": d["plain_ms"], "bound_ms": d["bound_ms"],
        "bound_by": d["bound_by"], "library_ms": None,
    }
    kernels = {"kernels": [
        entry("bucket_reduce", "fast_kernels.cu",
              "zecale_tpu/ec/msm4.py:543", main_level,
              max(s["max_abs_err"] for s in stats.values())),
        entry("proj_add", "fast_kernels.cu",
              "zecale_tpu/ec/ec_pallas.py:573",
              k2, max(p["proj_add"]["max_abs_err"] for p in pstats.values())),
        entry("proj_dbl_chain", "fast_kernels.cu",
              "zecale_tpu/ec/ec_pallas.py:596", k3,
              max(p["proj_dbl_chain"]["max_abs_err"]
                  for p in pstats.values())),
    ] + [
        entry(name, src, f"zecale_tpu/ec/ec_pallas.py:{line}",
              jstats["fq24"][name],
              max(j[name]["max_abs_err"] for j in jstats.values()))
        for name, src, line in (("jac_add", "fast_kernels.cu", 473),
                                ("jac_dbl_chain", "fast_kernels.cu", 514),
                                ("aff_add", "fast_kernels.cu", 543))
    ]}
    for k in kernels["kernels"]:
        check(k["launches"] > 0, f"{k['name']} never launched on the paths")
    print(json.dumps(kernels), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
