# Ported from scripts/multihost_dryrun.py: the same launcher and workers, joined by torch.distributed (gloo, a FileStore) instead of jax.distributed.
"""Multi-process dry run: worker processes of several shards each, joined
by a gloo group into one mesh (2 x 4 = 8 shards by default).

The distributed QAP-division FFT runs sharded over the global mesh, its
cross-shard exchanges crossing the process boundary; process 0 checks the
gathered iFFT against the host oracle.  Each worker also runs an
``msm8_sharded``, whose all-gather crosses the processes, checked the same
way.  gloo carries host tensors, so with ``--device cuda`` every exchange
is staged through host memory (the mesh says so when it is built).  The
processes meet at a ``FileStore`` in a temporary directory (no port to
collide with other runs).

    python -m zecale_tpu_torch.multihost_dryrun [--device cuda|cpu]
        [--procs 2] [--shards 4] [--backend gloo|nccl]
                                        # launcher: starts the workers
    python -m zecale_tpu_torch.multihost_dryrun --worker RANK --store FILE
        ...                             # one worker (started by the launcher)

Prints ``MULTIHOST OK`` (process 0), then ``launcher: all processes
green``, and exits 0.  ``--device cuda`` (the default) is refused without a
CUDA device; every shard of a process lies on that one device.
``--backend nccl`` carries device tensors directly and puts each shard on
a card of its own, so it needs procs x shards cards: NCCL refuses two
ranks on one card.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NPROC = 2
SHARDS = 4
N = 16
CURVE = "bls12-377"
#: points of the msm8 check, and its window bits
N_MSM = 32
C_MSM = 4
#: seconds the launcher waits for its workers before it kills them
TIMEOUT_S = 600


def worker(rank: int, nproc: int, shards: int, device: str, store: str,
           backend: str = "gloo") -> int:
    import random

    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    from zecale_tpu_torch.ec import curve_torch as ct
    from zecale_tpu_torch.ec import host_curve as hc
    from zecale_tpu_torch.ff import params as P
    from zecale_tpu_torch.ff.fp_torch import field
    from zecale_tpu_torch.parallel import fft_dist, sharded
    from zecale_tpu_torch.parallel.mesh import make_mesh
    from zecale_tpu_torch.poly.domain_host import domain

    if backend == "nccl":
        # one card a shard; each rank talks through its first card
        device = f"cuda:{rank * shards}"
        torch.cuda.set_device(device)
    dist.init_process_group(backend, store=dist.FileStore(store, nproc),
                            rank=rank, world_size=nproc)
    try:
        mesh = make_mesh(nproc * shards, group=dist.group.WORLD,
                         devices=None if backend == "nccl"
                         else [device] * shards)
        r = P.CURVES[CURVE].r
        F = field(r)
        rng = random.Random(11)
        vals = [rng.randrange(r) for _ in range(N)]
        out = fft_dist.ifft_sharded(mesh, F.pack_mont(vals), r)
        got = F.unpack_mont(mesh.gather(out))

        crv = hc.g1_curve(CURVE)
        gen = hc.generators(CURVE)[0]
        pts = [crv.mul(rng.randrange(1, r), gen) for _ in range(N_MSM)]
        scalars = [rng.randrange(r) for _ in range(N_MSM)]
        scalars[0] = 0
        pts[1] = None
        xy, inf = ct.pack_affine(ct.coord_field(CURVE, False), pts, device)
        pt = sharded.msm8_sharded(CURVE, mesh, F.pack(scalars, device), xy,
                                  inf, C_MSM)
        got_msm = sharded.point_to_host(CURVE, False, pt)
        if rank == 0:
            rev = fft_dist.bitrev_permutation(N)
            expect = domain(N, r).ifft(vals)
            if got != [expect[i] for i in rev]:
                raise RuntimeError(
                    "multi-process sharded iFFT diverges from the host oracle")
            if got_msm != crv.msm(scalars, pts):
                raise RuntimeError("multi-process msm8_sharded diverges from "
                                   "the host oracle")
            print(f"MULTIHOST OK: {mesh.describe()}; the cross-process iFFT "
                  "and msm8_sharded value-match the host oracle", flush=True)
    finally:
        dist.destroy_process_group()
    return 0


def launcher(nproc: int = NPROC, shards: int = SHARDS, device: str = "cuda",
             backend: str = "gloo") -> int:
    """Start ``nproc`` workers of ``shards`` shards each on ``device`` and
    wait for them (at most ``TIMEOUT_S``); 0 when all are green.  The
    FileStore lies in a new temporary directory.  ``backend`` "nccl" puts
    each shard on a card of its own (cuda:k shards + i for shard i of rank
    k) and needs nproc x shards cards."""
    import torch

    if backend not in ("gloo", "nccl"):
        raise ValueError(f"backend {backend!r} not in ('gloo', 'nccl')")
    if backend == "nccl":
        device = "cuda"
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        print(f"launcher: no CUDA device for --device {device}; pass "
              "--device cpu to run the plain versions", file=sys.stderr)
        return 2
    if backend == "nccl" and torch.cuda.device_count() < nproc * shards:
        print(f"launcher: nccl needs one card a shard, {nproc * shards} in "
              f"all; this machine has {torch.cuda.device_count()} (NCCL "
              "refuses two ranks on one card)", file=sys.stderr)
        return 2
    with tempfile.TemporaryDirectory() as tmp:
        store = os.path.join(tmp, "store")
        env = dict(os.environ)
        env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
        cmd = [sys.executable, "-m", "zecale_tpu_torch.multihost_dryrun",
               "--procs", str(nproc), "--shards", str(shards), "--device",
               device, "--backend", backend, "--store", store, "--worker"]
        print(f"launcher: {nproc} processes x {shards} shards on {device}, "
              f"joined by {backend}", flush=True)
        t0 = time.time()
        procs = [subprocess.Popen(cmd + [str(rank)], cwd=REPO, env=env,
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for rank in range(nproc)]
        outs, rc = [], 0
        try:
            for p in procs:
                out, _ = p.communicate(timeout=max(1.0, t0 + TIMEOUT_S
                                                   - time.time()))
                outs.append(out)
                rc |= p.returncode
        except subprocess.TimeoutExpired:
            rc = 1
            outs += ["(timed out)"] * (nproc - len(outs))
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    sys.stdout.write(outs[0][-2000:])
    if rc == 0 and "MULTIHOST OK" in outs[0]:
        print(f"launcher: all processes green ({time.time() - t0:.1f}s)",
              flush=True)
        return 0
    for i, o in enumerate(outs):
        sys.stderr.write(f"--- worker {i} tail ---\n{o[-2000:]}\n")
    return 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="the device of every shard (cuda or cpu)")
    ap.add_argument("--procs", type=int, default=NPROC)
    ap.add_argument("--shards", type=int, default=SHARDS,
                    help="shards a process")
    ap.add_argument("--backend", default="gloo", choices=("gloo", "nccl"),
                    help="nccl: one card a shard, device tensors carried "
                    "directly")
    ap.add_argument("--worker", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--store", default=None, help=argparse.SUPPRESS)
    a = ap.parse_args(argv)
    if a.worker is not None:
        return worker(a.worker, a.procs, a.shards, a.device, a.store,
                      a.backend)
    return launcher(a.procs, a.shards, a.device, a.backend)


if __name__ == "__main__":
    sys.exit(main())
