"""The reader of ``pk_resident_pct`` (``metrics/pk_resident_pct.py``) on
hand-built snapshots: the share of completed requests whose
``prove.pack_pk`` span found the key resident, and nothing where the
span has no ``resident`` attribute or the program no tracer."""

import pytest

from benchmark.harness import Record
from benchmark.metrics import pk_resident_pct, program
from zecale_tpu_torch.utils.profiling import Snapshot, Span

S = 10 ** 9  # ns a second


def _req(t0, t1, ok=True):
    return {"t0": int(t0 * S), "t1": int(t1 * S), "ok": ok, "phases": {}}


def _span(name, t0, t1, **attrs):
    return Span(0, 0, 0, name, int(t0 * S), int(t1 * S), attrs)


def _use(monkeypatch, spans):
    monkeypatch.setattr(program, "snapshot",
                        lambda: Snapshot(list(spans), {}))


def test_share_of_completed_requests_that_found_the_key(monkeypatch):
    _use(monkeypatch, [
        _span("prove.pack_pk", 4, 5, resident=0),       # warm-up packs
        _span("prove.pack_pk", 10, 10.1, resident=1),   # request 1
        _span("prove.pack_pk", 21, 25, resident=0),     # the failed one
        _span("prove.pack_pk", 30, 31, resident=0),     # request 3
        _span("prove.pack_pk", 41, 41.1, resident=1),   # request 4
        _span("prove.pack_pk", 51, 51.1, resident=1),   # request 5
    ])
    rec = Record(window=(10 * S, 60 * S), requests=[
        _req(10, 20), _req(20, 30, ok=False), _req(30, 40), _req(40, 50),
        _req(50, 60)])
    assert pk_resident_pct.read(rec) == pytest.approx(75.0)


def test_none_without_the_attribute_or_the_tracer(monkeypatch):
    rec = Record(window=(0, 10 * S), requests=[_req(0, 10)])
    _use(monkeypatch, [_span("prove.pack_pk", 1, 5)])  # a program that
    assert pk_resident_pct.read(rec) is None           # always packs
    _use(monkeypatch, [])
    assert pk_resident_pct.read(rec) is None
    monkeypatch.setattr(program, "snapshot", lambda: None)
    assert pk_resident_pct.read(rec) is None
