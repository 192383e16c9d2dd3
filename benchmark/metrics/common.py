"""Arithmetic the readers share: rates over all completed work of the
window, and per-request means of window sums."""

from __future__ import annotations

from typing import Optional


def ok(record) -> list:
    return [r for r in record.requests if r["ok"]]


def rate(record) -> Optional[float]:
    """Work completed in the window over the seconds from its start to
    the last completion, so that a stall anywhere counts against it."""
    done = ok(record)
    if not done:
        return None
    t0 = record.window[0]
    t1 = max(r["t1"] for r in done)
    return sum(r["work"] for r in done) / ((t1 - t0) / 1e9)


def phase_mean(record, phase: str) -> Optional[float]:
    """Seconds of a prover phase summed over the window's requests,
    divided by their number."""
    done = [r for r in ok(record) if phase in r["phases"]]
    if not done:
        return None
    return sum(r["phases"][phase] for r in done) / len(done)
