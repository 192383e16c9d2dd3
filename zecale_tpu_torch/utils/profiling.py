# Ported from zecale_tpu/utils/profiling.py: the same PhaseProfiler API and records, recorded through the port's span tracer.
"""The port's tracer: spans and counters where the work happens, on the
host clock ``time.time_ns`` -- the analog of libff's block profiler
(reference: enter_block/leave_block hierarchical timings,
aggregator_test.cpp:91-97,234-243; SURVEY.md section 5).

    from zecale_tpu_torch.utils import profiling
    with profiling.request("service.aggregate"):   # opens a request id
        with profiling.span("circuit.witness", n=3) as sp:
            ...
            sp.attrs["rows"] = 7                   # attributes, set inside
    profiling.count("retries")                     # a counter
    snap = profiling.snapshot()   # Snapshot(spans=[Span, ...], counters={})

A span records its id, its parent's id (the span open in the same thread
or task when it opened, from a ``contextvars`` variable, so threads of a
server do not mix), the id of the request it serves (that of the
innermost ``request`` span open around it, 0 outside one), its name, its
start and end in ``time.time_ns`` and its attributes.  Spans go into a
bounded ring, so a long-running server does not grow; counters into a
dict.  While a ``torch.profiler`` records, each span is also a
``record_function`` of its name, so that the spans lie in the profiler's
trace on its timeline; otherwise a span costs two clock reads and an
append.  A span's seconds hold only the device work its code waits for:
where a span should hold the device work it queues, the code synchronizes
before the span ends.

``PhaseProfiler`` keeps the JAX package's phase records for ``bench.py``:
    prof = PhaseProfiler()
    with prof.phase("prove"):
        with prof.phase("fft"):
            ...
    prof.report()            # hierarchical stderr table
    prof.to_json(path)       # machine-readable artifact for the bench
Each phase is a span; a phase's seconds end after
``torch.cuda.synchronize()`` where CUDA is in use, so they hold the device
work queued inside the phase.
"""

from __future__ import annotations

import collections
import contextlib
import contextvars
import itertools
import json
import threading
import time
from typing import Dict, List, Optional

import torch
import torch.autograd.profiler as _autograd_profiler

#: spans the ring keeps: at about 30 spans a served request, days of
#: requests are more than a reader needs
RING = 65536

Span = collections.namedtuple("Span", "id parent request name t0 t1 attrs")
Snapshot = collections.namedtuple("Snapshot", "spans counters")


class _Open:
    """A span while it is open; ``attrs`` may be set until it closes."""

    __slots__ = ("tracer", "name", "attrs", "opens_request", "id", "parent",
                 "request", "t0", "t1", "_token", "_rf")

    def __init__(self, tracer: "Tracer", name: str, attrs: dict,
                 opens_request: bool):
        self.tracer, self.name, self.attrs = tracer, name, attrs
        self.opens_request = opens_request

    def __enter__(self) -> "_Open":
        tr = self.tracer
        outer = tr._open.get()
        self.id = next(tr._ids)
        self.parent = outer.id if outer is not None else 0
        self.request = outer.request if outer is not None else 0
        if self.opens_request and not self.request:
            self.request = self.id
        self._token = tr._open.set(self)
        self._rf = None
        if _autograd_profiler._is_profiler_enabled:
            self._rf = _autograd_profiler.record_function(self.name)
            self._rf.__enter__()
        self.t0 = time.time_ns()
        return self

    def __exit__(self, *exc) -> bool:
        self.t1 = time.time_ns()
        if self._rf is not None:
            self._rf.__exit__(*exc)
        tr = self.tracer
        tr._open.reset(self._token)
        tr.spans.append((self.id, self.parent, self.request, self.name,
                         self.t0, self.t1, self.attrs))
        return False


class Tracer:
    """Spans in a ring of ``maxlen`` and counters of one process."""

    def __init__(self, maxlen: int = RING):
        self.spans: collections.deque = collections.deque(maxlen=maxlen)
        self.counters: Dict[str, int] = {}
        self._lock = threading.Lock()
        self._ids = itertools.count(1)
        self._open: contextvars.ContextVar = contextvars.ContextVar(
            f"zecale_span_{id(self)}", default=None)

    def span(self, name: str, **attrs) -> _Open:
        return _Open(self, name, attrs, False)

    def request(self, name: str, **attrs) -> _Open:
        """A span that opens a request id for every span inside it, unless
        it opens inside a request already."""
        return _Open(self, name, attrs, True)

    def current(self) -> Optional[_Open]:
        """The span open here, or None."""
        return self._open.get()

    def count(self, name: str, n: int = 1) -> None:
        with self._lock:
            self.counters[name] = self.counters.get(name, 0) + n

    def snapshot(self) -> Snapshot:
        return Snapshot([Span(*s) for s in list(self.spans)],
                        dict(self.counters))


#: the process's tracer, which the port's spans and counters go to
TRACER = Tracer()
span = TRACER.span
request = TRACER.request
count = TRACER.count
snapshot = TRACER.snapshot


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


class PhaseProfiler:
    """Phase records of ``bench.py``: each phase a span of ``tracer``, its
    full name ("prove/fft") from the phases open around it."""

    def __init__(self, tracer: Tracer = TRACER):
        self.tracer = tracer
        self.records: List[dict] = []
        #: span id of each open phase -> its full name
        self._full: Dict[int, str] = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        outer = self.tracer.current()
        parent = self._full.get(outer.id) if outer is not None else None
        full = f"{parent}/{name}" if parent else name
        try:
            with self.tracer.span(name) as sp:
                self._full[sp.id] = full
                try:
                    yield
                finally:
                    _sync()
        finally:
            del self._full[sp.id]
            self.records.append(
                {"phase": full, "seconds": round((sp.t1 - sp.t0) / 1e9, 4),
                 "depth": full.count("/")}
            )

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

    def to_json(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump({"phases": self.records}, f, indent=1)

    def total(self, phase: str) -> float:
        return sum(
            r["seconds"] for r in self.records if r["phase"] == phase
        )
