"""The benchmark's run of one cell, driven by ``BENCHMARK.json``.

A cell names a configuration (the file ``BENCHMARK.json`` gives it,
whose ``system`` names the module ``systems/<system>.py`` that drives the
port), a traffic mix (``traffic/<name>.json``, read by ``traffic.py``,
whose ``loop`` names the request loop ``loops/<loop>.py``) and its chips.
A metric named ``<base>`` or ``<base>.<suffix>`` is read by
``metrics/<base>.py``.  So a cell, a configuration, a mix, a loop or a
metric is added as files and entries, without editing one that is there.

A run: the system's set-up (the port's kernels and the deployment's
keypair, made by the reference's own trusted setup, are built once per
checkout, inside it), the cell's inputs from the seed, the warm-up
requests, then the mix's loop over the window; then the program's state
is freed and the reference judges every answer of the window.
"""

from __future__ import annotations

import contextlib
import importlib
import json
import os
import sys
import time
from typing import List, Optional

from . import traffic

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
CACHE = os.path.join(BENCH, "cache")
#: top-level modules that may not be loaded once the window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "zecale_tpu")


class NoDevice(RuntimeError):
    pass


def load_spec() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def cell(spec: dict, name: str) -> dict:
    for w in spec["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(spec: dict, name: str) -> dict:
    """The configuration's file as ``BENCHMARK.json`` names it."""
    for c in spec["configs"]:
        if c["name"] == name:
            with open(os.path.join(ROOT, c["file"])) as f:
                return json.load(f)
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def metrics_of(spec: dict, workload: str, trace: bool) -> List[dict]:
    """The cell's end-to-end metrics, or with ``trace`` its per-layer
    metrics: those that list it, and those that list no cell and move an
    end-to-end metric it reports."""
    def mine(m):
        return workload in m.get("workloads", [workload])

    e2e = [m for m in spec["end_to_end"] if mine(m)]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}

    def listed(m):
        if "workloads" in m:
            return workload in m["workloads"]
        return m["moves"] in names

    return [m for m in spec["per_layer"] if listed(m)]


def reader(name: str):
    return importlib.import_module(
        f"benchmark.metrics.{name.split('.')[0]}").read


def loop(mix: dict):
    """The request loop that serves the mix's window."""
    return importlib.import_module(f"benchmark.loops.{mix['loop']}")


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


class Recorder:
    """Spans (host ns) around the calls into the port, each request's
    seconds, and the prover calls inside it; with ``trace`` each span is
    also a profiler annotation."""

    def __init__(self, trace: bool):
        #: with ``trace``, spans are profiler annotations too, and each
        #: prover call keeps what the MSM count reads
        self.trace = trace
        self.spans: list = []
        self.requests: list = []
        self._current: Optional[dict] = None

    @contextlib.contextmanager
    def annotate(self, label: str):
        t0 = time.time_ns()
        if self.trace:
            from torch.profiler import record_function

            with record_function(label):
                yield
        else:
            yield
        self.spans.append((t0, time.time_ns(), label))

    def prover_call(self, t0: int, t1: int, timings: dict,
                    msms=None) -> None:
        """A prover call from ``t0`` to ``t1`` (ns) with its phases, which
        run one after another from its start; ``msms``, kept in a traced
        run, is the call's MSMs as ``roofline.groth16_msms`` reads them."""
        t = t0
        for name, s in timings.items():
            self.spans.append((t, t + int(s * 1e9), f"prover.{name}"))
            t += int(s * 1e9)
        if self._current is not None:
            cur = self._current
            cur["prove_s"] = cur.get("prove_s", 0.0) + (t1 - t0) / 1e9
            for name, s in timings.items():
                cur["phases"][name] = cur["phases"].get(name, 0.0) + s
            if msms is not None and self.trace:
                cur.setdefault("msms", []).append(msms)

    @contextlib.contextmanager
    def request(self):
        cur = {"t0": time.time_ns(), "phases": {}, "ok": False}
        self._current = cur
        try:
            yield cur
        finally:
            cur["t1"] = time.time_ns()
            self._current = None
            self.requests.append(cur)


class Record:
    """What the metric readers read: the window's requests, its length,
    set-up, the trace's reduction and the window's device peak."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


def log(msg: str) -> None:
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


def _device(c: dict, device: str):
    import torch

    if device != "cuda":
        return {"platform": device, "kind": device, "count": c["chips"]}
    if not torch.cuda.is_available():
        raise NoDevice("torch.cuda.is_available() is false")
    if torch.cuda.device_count() < c["chips"]:
        raise NoDevice(f"{torch.cuda.device_count()} devices, the cell "
                       f"asks for {c['chips']}")
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": c["chips"]}


def build_system(cfg: dict, device: str, cache: str, rec, prover=None):
    """The configuration's system, set up: with a device, the port's
    kernels are built (once per checkout) before anything else."""
    parts = {}
    if device == "cuda":
        from zecale_tpu_torch.utils import build

        t0 = time.time()
        build.cuda_kernels()
        parts["kernel_build_s"] = time.time() - t0
        parts["kernels_built"] = sorted(
            k for k, v in build.last_build.items() if v["log"] != "cached")
    mod = importlib.import_module(f"benchmark.systems.{cfg['system']}")
    system = mod.System(cfg, device, cache, rec, prover=prover)
    system.parts = {**parts, **system.parts}
    return system


def judge(system, inp: dict, done: list, failed: int) -> dict:
    """{check: (number, limit)} of the window's answers, each judged by
    the reference."""
    sums: dict = {}
    for sp, answer in done:
        for k, v in system.judge(inp, sp, answer).items():
            sums[k] = sums.get(k, 0) + v
    checks = {"failed_requests": (failed, 0),
              "no_answer": (int(not done), 0)}
    checks.update({k: (v, 0) for k, v in sums.items()})
    return checks


def passed(checks: dict) -> bool:
    return all(v <= lim for v, lim in checks.values())


class Session:
    """A cell set up once: its configuration, mix, device and system."""

    def __init__(self, workload: str, device: str = "cuda",
                 cache: str = CACHE, prover=None):
        self.spec = load_spec()
        self.cell = cell(self.spec, workload)
        self.workload = workload
        self.cfg = config(self.spec, self.cell["config"])
        self.mix = traffic.load(self.cell["traffic"])
        self.loop = loop(self.mix)
        self.device = device
        self.dev = _device(self.cell, device)
        self.rec = Recorder(trace=False)
        self.system = build_system(self.cfg, device, cache, self.rec,
                                   prover=prover)

    def inputs(self, seed: int, warm: bool = True) -> tuple:
        """(inputs, the window's request specs) of ``seed``; ``warm``
        serves its warm-up requests."""
        specs = traffic.distinct(self.mix, seed)
        warmup = traffic.warmup(self.mix, seed)
        inp = self.system.inputs(self.mix, seed, specs + warmup)
        if warm:
            t0 = time.time()
            for sp in warmup:
                self.system.serve(inp, sp)
            self.system.parts["warmup_s"] = time.time() - t0
        return inp, specs

    def measure(self, inp: dict, specs: list, seconds: float,
                trace: bool) -> dict:
        """One window -> {done, failed, window, trace, peak}."""
        import torch

        cuda = self.device == "cuda"
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        rec = self.rec
        rec.trace = trace
        rec.spans = []
        prof = None
        if trace:
            from torch.profiler import ProfilerActivity, profile

            prof = profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA])
            prof.__enter__()
        done, failed, w0, w1 = self.loop.run(self.system, inp, specs,
                                             seconds, rec, self.mix)
        red = None
        if prof is not None:
            prof.__exit__(None, None, None)
            from . import trace as tr

            red = tr.reduce(prof, (w0, w1), rec.spans)
        rec.trace = False
        return {"done": done, "failed": failed, "window": (w0, w1),
                "trace": red, "requests": rec.requests,
                "peak": torch.cuda.max_memory_allocated() if cuda else 0}


def probe(s: Session, seed: int, seconds: float, fault=None,
          warm: bool = False) -> tuple:
    """A window of ``seed`` on a session already set up, with ``fault``
    planted in the timed path, judged by the reference -> (correct,
    checks, answers).  For the tests, on the CPU and on the card."""
    inp, specs = s.inputs(seed, warm=warm)
    s.system.set_fault(fault)
    try:
        w = s.measure(inp, specs, seconds, False)
    finally:
        s.system.set_fault(None)
    checks = judge(s.system, inp, w["done"], w["failed"])
    return passed(checks), checks, len(w["done"])


def run(workload: str, seed: int, seconds: float, trace: bool,
        t_process: float, session=None) -> dict:
    """One run of the cell -> the result line's object.  ``session``, a
    cell already set up, is for the tests."""
    import torch

    s = session or Session(workload)
    system = s.system
    inp, specs = s.inputs(seed)
    cuda = s.device == "cuda"
    setup_peak = torch.cuda.max_memory_allocated() if cuda else 0
    setup_s = time.time() - t_process
    log(f"set-up {setup_s:.3f} s: {system.parts}")
    w = s.measure(inp, specs, seconds, trace)
    dev = dict(s.dev, memory_peak_bytes=max(setup_peak, w["peak"]))
    red = w["trace"]
    if red is not None:
        dev["busy_s"], dev["window_s"] = red["busy_s"], red["window_s"]
    record = Record(setup_s=setup_s, requests=w["requests"],
                    window=w["window"], trace=red,
                    window_peak_bytes=w["peak"],
                    msm_groups=system.msm_groups)
    metrics = {}
    for m in metrics_of(s.spec, workload, trace):
        v = reader(m["name"])(record)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    parts = dict(system.parts, constraints=system.constraints)
    system.close()
    t0 = time.time()
    checks = judge(system, inp, w["done"], w["failed"])
    parts["reference_s"] = time.time() - t0
    out = {"correct": passed(checks), "attempted": len(w["requests"]),
           "failed": w["failed"], "metrics": metrics, "device": dev}
    if red is not None:
        out["breakdown"] = {"device_ops": red["device_ops"],
                            "idle_gaps": red["idle_gaps"]}
    out["setup"] = parts
    out["requests"] = [[(r["t1"] - r["t0"]) / 1e9, r.get("prove_s"),
                        r["phases"]] for r in w["requests"]]
    out["checks"] = {k: {"value": v, "limit": lim}
                     for k, (v, lim) in checks.items()}
    return out
