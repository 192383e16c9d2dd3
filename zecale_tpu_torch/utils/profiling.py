# Ported from zecale_tpu/utils/profiling.py: the same PhaseProfiler API and records; torch.profiler in place of jax.profiler.
"""Phase profiler with torch.profiler trace capture -- the analog of
libff's block profiler (reference: enter_block/leave_block hierarchical
timings, aggregator_test.cpp:91-97,234-243; SURVEY.md section 5).

Usage:
    prof = PhaseProfiler()
    with prof.phase("setup"):
        ...
    with prof.phase("prove"):
        with prof.phase("prove/fft"):
            ...
    prof.report()            # hierarchical stderr table
    prof.to_json(path)       # machine-readable artifact for the bench

A phase's seconds end after ``torch.cuda.synchronize()`` where CUDA is in
use, so they hold the device work queued inside the phase.

Set ZECALE_TORCH_TRACE=<dir> to additionally capture a torch.profiler trace
(CPU and, where there is a card, CUDA activity) around every top-level
phase, exported as ``<dir>/<phase>.json`` in Chrome trace format; the
phase's device time (the sum of its CUDA kernels) and its share of the
phase's seconds then land in ``device``.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Dict, List, Optional

import torch


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


class PhaseProfiler:
    def __init__(self, trace_dir: Optional[str] = None):
        self.records: List[dict] = []
        #: top-level phase -> {"device_ms", "busy"} of its trace
        self.device: Dict[str, dict] = {}
        self._stack: List[str] = []
        self.trace_dir = trace_dir or os.environ.get("ZECALE_TORCH_TRACE")

    @contextlib.contextmanager
    def phase(self, name: str):
        full = "/".join(self._stack + [name]) if self._stack else name
        self._stack.append(name)
        trace = None
        if self.trace_dir and len(self._stack) == 1:
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(ProfilerActivity.CUDA)
            trace = profile(activities=acts)
            trace.__enter__()
        t0 = time.time()
        try:
            yield
        finally:
            _sync()
            dt = time.time() - t0
            if trace is not None:
                trace.__exit__(None, None, None)
                self._export(name, trace, dt)
            self._stack.pop()
            self.records.append(
                {"phase": full, "seconds": round(dt, 4),
                 "depth": full.count("/")}
            )

    def _export(self, name: str, trace, seconds: float) -> None:
        os.makedirs(self.trace_dir, exist_ok=True)
        trace.export_chrome_trace(
            os.path.join(self.trace_dir, name.replace("/", "_") + ".json"))
        us = sum(e.time_range.elapsed_us() for e in trace.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA)
        self.device[name] = {
            "device_ms": us / 1e3,
            "busy": us / 1e6 / seconds if seconds > 0 else None,
        }

    def merge_timings(self, prefix: str, timings: Dict[str, float]):
        """Fold a {name: seconds} dict (e.g. a prover's internal marks)
        into the report under ``prefix/``."""
        for k, v in timings.items():
            self.records.append(
                {"phase": f"{prefix}/{k}", "seconds": round(v, 4),
                 "depth": prefix.count("/") + 1}
            )

    def report(self, file=None) -> None:
        import sys

        f = file or sys.stderr
        print("== phase timings ==", file=f)
        for rec in self.records:
            indent = "  " * rec["depth"]
            name = rec["phase"].rsplit("/", 1)[-1]
            print(f"{indent}{name:<28s} {rec['seconds']:>9.3f}s", file=f)
        for name, d in self.device.items():
            print(f"{name}: device {d['device_ms']:.3f} ms, busy "
                  f"{d['busy']}", file=f)

    def to_json(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump({"phases": self.records}, f, indent=1)

    def total(self, phase: str) -> float:
        return sum(
            r["seconds"] for r in self.records if r["phase"] == phase
        )
