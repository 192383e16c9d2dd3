"""Reduction of a ``torch.profiler`` trace of the measured window: the
seconds some operation ran on the device (the union of kernel, copy and
set intervals), the device operations that took most time, and the
longest idle gaps, each named by the benchmark span open at its middle.

Spans are (start_ns, end_ns, label) on the host's ``time.time_ns``
clock; the profiler's clock is aligned to it by the annotation
``bench.window`` that opens at the host time ``window[0]``.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

TOP = 10


def _device_events(prof, annotations):
    """(name, start, end) of the kernels, copies and sets on the device;
    the device-side copies of the benchmark's ``annotations`` are left
    out."""
    from torch.autograd import DeviceType

    for e in prof.profiler.kineto_results.events():
        if (e.device_type() == DeviceType.CUDA and e.duration_ns() > 0
                and e.name() not in annotations
                and not e.is_user_annotation()):
            yield e.name(), e.start_ns(), e.start_ns() + e.duration_ns()


def _offset(prof, window_start_ns: int) -> int:
    from torch.autograd import DeviceType

    for e in prof.profiler.kineto_results.events():
        if e.name() == "bench.window" and e.device_type() == DeviceType.CPU:
            return e.start_ns() - window_start_ns
    raise RuntimeError("the trace holds no bench.window annotation")


def union(intervals: Sequence[Tuple[int, int]], lo: int,
          hi: int) -> List[Tuple[int, int]]:
    """The union of ``intervals`` clipped to [lo, hi], as sorted disjoint
    intervals."""
    out: List[List[int]] = []
    for s, e in sorted(intervals):
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def gaps(busy: Sequence[Tuple[int, int]], lo: int,
         hi: int) -> List[Tuple[int, int]]:
    """The complement of sorted disjoint ``busy`` within [lo, hi]."""
    out, t = [], lo
    for s, e in busy:
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if hi > t:
        out.append((t, hi))
    return out


def label_at(spans: Sequence[Tuple[int, int, str]], t: int) -> str:
    """The innermost (shortest) span that holds host time ``t``."""
    best = None
    for s, e, name in spans:
        if s <= t < e and (best is None or e - s < best[1] - best[0]):
            best = (s, e, name)
    return best[2] if best else "harness"


def reduce(prof, window: Tuple[int, int],
           spans: Sequence[Tuple[int, int, str]]) -> dict:
    """{busy_s, window_s, device_ops, idle_gaps} of the window
    [window[0], window[1]] (host ns)."""
    off = _offset(prof, window[0])
    lo, hi = window[0] + off, window[1] + off
    ivs, by_name = [], {}
    for name, s, e in _device_events(prof, {sp[2] for sp in spans}):
        ivs.append((s, e))
        d = min(e, hi) - max(s, lo)
        if d > 0:
            by_name[name] = by_name.get(name, 0) + d
    busy = union(ivs, lo, hi)
    idle = sorted(gaps(busy, lo, hi), key=lambda g: g[0] - g[1])[:TOP]
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    return {
        "busy_s": sum(e - s for s, e in busy) / 1e9,
        "window_s": (hi - lo) / 1e9,
        "device_ops": [[n[:120], d / 1e9] for n, d in ops],
        "idle_gaps": [[label_at(spans, (s + e) // 2 - off), (e - s) / 1e9]
                      for s, e in idle],
    }
