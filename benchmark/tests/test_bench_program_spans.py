"""The readers of the program's own spans (``metrics/program.py`` and the
seven metrics on it) on hand-built snapshots, on a program without the
tracer, and on a window of ``agg2.served`` served on the CPU with the
device prover replaced by the simulator (``sim.py``)."""

import sys
import types

import pytest
import torch

from benchmark import harness
from benchmark.harness import Record
from benchmark.metrics import (circuit_witness_s, common, hook_compile_s,
                               hook_python_s, msm_fold_s, pack_pk_s,
                               program, service_s, setup_circuit_s)
from zecale_tpu_torch.utils.profiling import Snapshot, Span

from . import sim

torch.set_num_threads(1)

S = 10 ** 9  # ns a second
SEED = 2 ** 31 + 4242
READERS = (pack_pk_s, circuit_witness_s, hook_python_s, service_s,
           msm_fold_s, setup_circuit_s, hook_compile_s)


def _req(t0, t1, ok=True):
    return {"t0": int(t0 * S), "t1": int(t1 * S), "ok": ok, "phases": {}}


def _span(name, t0, t1, **attrs):
    return Span(0, 0, 0, name, int(t0 * S), int(t1 * S), attrs)


def _use(monkeypatch, spans):
    monkeypatch.setattr(program, "snapshot",
                        lambda: Snapshot(list(spans), {}))


def test_per_request_mean_of_the_spans_inside_completed_requests(
        monkeypatch):
    _use(monkeypatch, [
        _span("setup.circuit", 0, 3),
        _span("prove.pack_pk", 4, 5),    # warm-up, before the window
        _span("prove.pack_pk", 10, 12),  # request 1
        _span("prove.pack_pk", 13, 13.5), _span("prove.pack_pk", 14, 14.5),
        _span("prove.pack_pk", 21, 25),  # the failed request
        _span("msm.fold", 31, 31.25),
    ])
    rec = Record(window=(10 * S, 40 * S), requests=[
        _req(10, 20), _req(20, 30, ok=False), _req(30, 40)])
    # 2 s + 1 s in the first request, none in the third: 3 s over two
    assert pack_pk_s.read(rec) == pytest.approx(1.5)
    assert msm_fold_s.read(rec) == pytest.approx(0.125)
    assert circuit_witness_s.read(rec) is None  # no such span
    assert setup_circuit_s.read(rec) == pytest.approx(3.0)
    assert hook_compile_s.read(rec) is None
    assert pack_pk_s.read(Record(window=(0, 0), requests=[
        _req(21, 25, ok=False)])) is None


def test_service_self_time_and_python_hooks(monkeypatch):
    _use(monkeypatch, [
        _span("service.submit", 10, 10.25),
        _span("service.submit", 10.25, 10.5),
        _span("service.aggregate", 10.5, 19.5),
        _span("circuit.prove", 11, 19),
        _span("circuit.witness", 11, 12),
        _span("witness.replay", 11.1, 11.9, py_ns=int(0.3 * S)),
        _span("service.aggregate", 20, 29),  # the failed request
        _span("witness.replay", 21, 22, py_ns=S),
    ])
    rec = Record(window=(10 * S, 30 * S), requests=[
        _req(10, 20), _req(20, 30, ok=False)])
    # 0.25 + 0.25 + 9 s of service, less the 8 s of circuit.prove
    assert service_s.read(rec) == pytest.approx(1.5)
    assert circuit_witness_s.read(rec) == pytest.approx(1.0)
    assert hook_python_s.read(rec) == pytest.approx(0.3)


def test_setup_spans_end_before_the_window(monkeypatch):
    _use(monkeypatch, [
        _span("setup.circuit", 0, 4),
        _span("setup.hook_program", 5, 7),
        _span("setup.native_r1cs", 8, 8.5),
        _span("setup.hook_program", 12, 13),  # inside the window
    ])
    rec = Record(window=(10 * S, 20 * S), requests=[_req(10, 20)])
    assert setup_circuit_s.read(rec) == pytest.approx(4.0)
    assert hook_compile_s.read(rec) == pytest.approx(2.5)


def test_a_program_without_the_tracer_gives_none(monkeypatch):
    """A checkout whose ``utils/profiling.py`` has no ``snapshot``."""
    monkeypatch.setitem(sys.modules, "zecale_tpu_torch.utils.profiling",
                        types.ModuleType("zecale_tpu_torch.utils.profiling"))
    assert program.snapshot() is None
    rec = Record(window=(0, 10 * S), requests=[_req(0, 10)])
    for r in READERS:
        assert r.read(rec) is None, r.__name__


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """A window of ``agg2.served`` on the CPU -> its Record."""
    cache = str(tmp_path_factory.mktemp("cache"))
    prover = sim.keypair(cache, "zecale-b2", "bw6-761", 4)
    s = harness.Session("agg2.served", device="cpu", cache=cache,
                        prover=prover)
    inp, specs = s.inputs(SEED)
    w = s.measure(inp, specs, 0.1, False)
    return Record(setup_s=0.0, requests=w["requests"], window=w["window"])


def test_served_window_reads_the_program_spans(served):
    assert any(r["ok"] for r in served.requests)
    got = {r.__name__.split(".")[-1]: r.read(served) for r in READERS}
    # the simulator stands in for the device prover: no repack, no MSM
    assert got.pop("pack_pk_s") is None and got.pop("msm_fold_s") is None
    for name, v in got.items():
        assert v is not None and v > 0, name
    assert got["hook_python_s"] <= got["circuit_witness_s"]


def test_service_spans_cover_each_request(served):
    spans = [s for s in program.snapshot().spans
             if s.name in ("service.submit", "service.aggregate")]
    for r in common.ok(served):
        inside = sum(s.t1 - s.t0 for s in spans
                     if r["t0"] <= s.t0 and s.t1 <= r["t1"])
        assert inside >= 0.95 * (r["t1"] - r["t0"])

