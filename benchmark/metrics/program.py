"""What the readers of the program's own spans share: the port's tracer
(``zecale_tpu_torch/utils/profiling.py``), read in process once the
window has closed, and per-request means of the spans that lie inside
each completed request, as ``common.phase_mean`` takes them of the
prover's phases.  A program without the tracer gives nothing to read."""

from __future__ import annotations

from typing import Callable, Optional

from .common import ok


def snapshot():
    """The port's spans and counters, or None where the program has no
    tracer."""
    try:
        from zecale_tpu_torch.utils.profiling import snapshot as snap
    except ImportError:
        return None
    return snap()


def seconds(span) -> float:
    return (span.t1 - span.t0) / 1e9


def per_request(record, names, value: Callable = seconds) -> Optional[float]:
    """``value`` of each span named in ``names`` that lies inside a
    completed request's [t0, t1], summed over the window and divided by
    the completed requests; None where no such span lies in any."""
    snap = snapshot()
    done = ok(record)
    if snap is None or not done:
        return None
    spans = [s for s in snap.spans if s.name in names]
    total, found = 0.0, False
    for r in done:
        for s in spans:
            if r["t0"] <= s.t0 and s.t1 <= r["t1"]:
                total += value(s)
                found = True
    return total / len(done) if found else None


def setup_sum(record, names) -> Optional[float]:
    """Seconds of the spans named in ``names`` that end before the
    window opens; None where there is none."""
    snap = snapshot()
    if snap is None:
        return None
    got = [seconds(s) for s in snap.spans
           if s.name in names and s.t1 <= record.window[0]]
    return sum(got) if got else None
