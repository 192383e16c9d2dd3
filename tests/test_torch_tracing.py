"""The port's tracer (zecale_tpu_torch/utils/profiling.py) on the CPU: the
span tree of a Groth16Torch prove and its agreement with ``timings``, the
resident key's attribute on ``prove.pack_pk``, the ring's bound, the
parent stacks of threads, the hook replay's counts, the service's request
spans over the FakeCircuit flow, and the shared clock with a
``torch.profiler`` trace as the benchmark aligns it.  The
cost of a span and a counter with no profiler is printed, not asserted.
Tolerance: exact, but for clock comparisons (1 us between a span and its
``timings`` entry, 1 ms between a span and its profiler event)."""

import json
import random
import threading
import time

import pytest
import torch

from zecale_tpu_torch.aggregator import dummy_app as da
from zecale_tpu_torch.gadgets.protoboard import LC, Protoboard
from zecale_tpu_torch.native.witness import HookProgram
from zecale_tpu_torch.snark.groth16_torch import Groth16Torch
from zecale_tpu_torch.utils import profiling

from .test_torch_service import _flow

# One intra-op thread: the suite runs in several worker processes at
# once, and torch's OpenMP threads spinning in each of them slow every
# worker many times over.
torch.set_num_threads(1)

CURVE = "bw6-761"
PHASES = ("witness", "fft", "digitize", "msm", "assembly")
MSMS = ("a", "b_g1", "b_g2", "l", "h")


def _spans_of(req):
    """The spans of the request ``req`` opened, itself included."""
    return [s for s in profiling.snapshot().spans if s.request == req.id]


def _inside(child, parent):
    return parent.t0 <= child.t0 <= child.t1 <= parent.t1


@pytest.fixture(scope="module")
def proves():
    """Two proves of the dummy BW6-761 application, each in a request:
    one that packs the key, one given the packed key -> [(proof,
    timings, spans)]."""
    r1cs, kp = da.dummy_app_setup(CURVE, random.Random(5))
    asg = da.dummy_app_assignment(CURVE, 9)
    prover = Groth16Torch(CURVE, device="cpu")
    dpk = prover.pack_pk(kp.pk, r1cs.num_primary + 1)
    out = []
    for extra in ({}, {"device_pk": dpk}):
        timings = {}
        with profiling.request("service.aggregate") as req:
            proof = prover.prove(r1cs, kp.pk, asg, random.Random(77),
                                 timings=timings, **extra)
        out.append((proof, timings, _spans_of(req)))
    return out


def test_prove_span_tree(proves):
    _, _, spans = proves[0]
    by_id = {s.id: s for s in spans}
    root = [s for s in spans if s.parent == 0]
    assert [s.name for s in root] == ["service.aggregate"]
    assert root[0].request == root[0].id

    def children(span):
        return sorted((s for s in spans if s.parent == span.id),
                      key=lambda s: s.t0)

    phases = children(root[0])
    assert [s.name for s in phases] == ["prove." + p for p in PHASES]
    witness, msm_phase = phases[0], phases[3]
    assert [s.name for s in children(witness)] == ["prove.pack_pk",
                                                   "prove.abc"]
    msms = children(msm_phase)
    assert [s.name for s in msms] == ["msm." + q for q in MSMS]
    for s in msms:
        assert s.attrs["engine"] == "msm4" and s.attrs["n"] > 0
        assert [c.name for c in children(s)] == ["msm.fold"]
    for s in spans:  # every child lies inside its parent
        if s.parent:
            assert _inside(s, by_id[s.parent]), s.name


def test_prove_phase_spans_are_the_timings(proves):
    for _, timings, spans in proves:
        assert list(timings) == list(PHASES)
        for p in PHASES:
            (s,) = [s for s in spans if s.name == "prove." + p]
            assert abs((s.t1 - s.t0) / 1e9 - timings[p]) < 1e-6


def test_device_pk_leaves_out_pack_pk(proves):
    (proof, _, spans), (proof_dpk, _, spans_dpk) = proves
    names = [s.name for s in spans_dpk]
    assert "prove.pack_pk" not in names and "prove.abc" in names
    assert [s.name for s in spans].count("prove.pack_pk") == 1
    assert (proof_dpk.a, proof_dpk.b, proof_dpk.c) == (proof.a, proof.b,
                                                        proof.c)


def test_pack_pk_span_says_whether_the_key_was_resident():
    """A fresh prover's first prove packs the key (``resident`` 0); its
    second, with the same key object, finds it resident (1)."""
    r1cs, kp = da.dummy_app_setup(CURVE, random.Random(5))
    asg = da.dummy_app_assignment(CURVE, 9)
    prover = Groth16Torch(CURVE, device="cpu")
    got = []
    for _ in range(2):
        with profiling.request("service.aggregate") as req:
            prover.prove(r1cs, kp.pk, asg, random.Random(77))
        (s,) = [s for s in _spans_of(req) if s.name == "prove.pack_pk"]
        got.append(s.attrs["resident"])
    assert got == [0, 1]


def test_ring_is_bounded():
    tracer = profiling.Tracer(maxlen=8)
    for i in range(20):
        with tracer.span("s", i=i):
            pass
    spans = tracer.snapshot().spans
    assert [s.attrs["i"] for s in spans] == list(range(12, 20))
    assert len(tracer.spans) == 8


def test_threads_keep_separate_parent_stacks():
    tracer = profiling.Tracer()
    both_open = threading.Barrier(2, timeout=10)
    outer = {}

    def work(k):
        with tracer.request(f"req{k}") as req:
            outer[k] = req.id
            both_open.wait()  # each thread's request is open at once
            with tracer.span(f"child{k}"):
                both_open.wait()

    threads = [threading.Thread(target=work, args=(k,)) for k in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=20)
        assert not t.is_alive()
    spans = {s.name: s for s in tracer.snapshot().spans}
    assert outer[0] != outer[1]
    for k in (0, 1):
        child = spans[f"child{k}"]
        assert child.parent == outer[k] and child.request == outer[k]
        assert spans[f"req{k}"].parent == 0


def _small_board():
    """x -> y = x*x, z = y*x (C), two Python hooks a = z + 1, b = 2a,
    u = b*x (C), one Python hook v = u + 3: two C segments, three Python
    hooks in two runs."""
    r = 2 ** 61 - 1
    pb = Protoboard(r)
    x = pb.allocate_primary()
    X = LC.of_var(x)
    y = pb.mul(X, X)
    z = pb.mul(y, X)
    a, b, v = pb.allocate(), pb.allocate(), pb.allocate()

    def h_a(w, _z=z.terms[0][0]):
        w[a] = (w[_z] + 1) % r

    def h_b(w):
        w[b] = 2 * w[a] % r

    pb.add_hook(h_a)
    pb.add_hook(h_b)
    u = pb.mul(LC.of_var(b), X)

    def h_v(w, _u=u.terms[0][0]):
        w[v] = (w[_u] + 3) % r

    pb.add_hook(h_v)
    return pb, r, (x, a, b, v)


def test_hook_replay_counts_c_segments_and_python_hooks():
    pb, r, (x, a, b, v) = _small_board()
    prog = HookProgram(pb)
    if not prog.available:
        pytest.skip("the native witness engine did not build (gcc)")
    w = [0] * pb.num_variables
    w[0], w[x] = 1, 5
    got = prog.run(list(w))
    want = list(w)
    for hook in pb.witness_hooks:
        hook(want)
    assert got == want and got[v] == (2 * (125 + 1) * 5 + 3) % r
    (span,) = [s for s in profiling.snapshot().spans
               if s.name == "witness.replay"][-1:]
    assert sorted(span.attrs) == ["c_segments", "py_hooks", "py_ns"]
    assert span.attrs["c_segments"] == 2 and span.attrs["py_hooks"] == 3
    assert 0 < span.attrs["py_ns"] <= span.t1 - span.t0


def test_service_spans_nest_under_the_fake_circuit_flow():
    n0 = max((s.id for s in profiling.snapshot().spans), default=0)
    got = _flow("port")
    spans = [s for s in profiling.snapshot().spans if s.id > n0]
    assert json.dumps(got) == json.dumps(_flow("ref"))
    by_id = {s.id: s for s in spans}
    reqs = [s for s in spans if s.name.startswith("service.")
            and s.name != "service.check_points"]
    # five submits (one of an unknown application), three aggregations
    assert sorted(s.name for s in reqs) == (["service.aggregate"] * 3
                                            + ["service.submit"] * 5)
    for s in reqs:
        assert s.parent == 0 and s.request == s.id
    for s in spans:
        if s.name in ("codec.decode", "codec.encode") or (
                s.name == "service.check_points" and s.request):
            parent = by_id[s.parent]
            assert parent in reqs and s.request == parent.id
            assert _inside(s, parent)
    names = [s.name for s in spans]
    # four submits reach the codec; the one off the curve stops at the
    # check; one aggregation answers and encodes its proof
    assert names.count("codec.decode") == 4
    assert names.count("codec.encode") == 1
    # the application's key is checked once, outside any request
    assert [s.request for s in spans
            if s.name == "service.check_points"].count(0) == 1


def test_spans_share_the_benchmark_clock_under_a_profiler():
    """Under a CPU torch.profiler each span is a record_function event;
    its start, less the offset between the profiler's clock and
    ``time.time_ns`` that a ``bench.window`` annotation gives (the
    benchmark aligns its traced window so), is the span's start."""
    from torch.profiler import ProfilerActivity, profile, record_function

    tracer = profiling.Tracer()
    pb, _, (x, *_) = _small_board()
    prog = HookProgram(pb)
    w = [0] * pb.num_variables
    w[0], w[x] = 1, 5
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        w0 = time.time_ns()
        with record_function("bench.window"):
            with tracer.request("t.request"):
                for k in range(3):
                    with tracer.span(f"t.step{k}"):
                        torch.ones(8).sum()
                        time.sleep(0.002)
            if prog.available:
                prog.run(list(w))
    events = {}
    for e in prof.profiler.kineto_results.events():
        if e.is_user_annotation():
            events.setdefault(e.name(), []).append(e.start_ns())
    (window,) = events["bench.window"]
    off = window - w0
    spans = tracer.snapshot().spans
    if prog.available:
        spans.append(profiling.snapshot().spans[-1])
        assert spans[-1].name == "witness.replay"
    assert len(spans) == 4 + prog.available
    for s in spans:
        (start,) = events[s.name][-1:]
        assert abs(start - off - s.t0) < 1_000_000, s.name


def test_no_record_function_without_a_profiler(monkeypatch):
    opened = []
    real = profiling._autograd_profiler.record_function

    def spy(name, *args):
        opened.append(name)
        return real(name, *args)

    monkeypatch.setattr(profiling._autograd_profiler, "record_function",
                        spy)
    tracer = profiling.Tracer()
    with tracer.request("off"):
        with tracer.span("off.child"):
            pass
    assert opened == []
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]):
        with tracer.span("on"):
            pass
    assert opened == ["on"]


def test_cost_with_no_profiler_is_printed():
    tracer = profiling.Tracer()
    n = 20000
    t0 = time.perf_counter_ns()
    for _ in range(n):
        with tracer.span("cost"):
            pass
    span_ns = (time.perf_counter_ns() - t0) / n
    t0 = time.perf_counter_ns()
    for _ in range(n):
        tracer.count("cost")
    count_ns = (time.perf_counter_ns() - t0) / n
    print(f"tracer cost, no profiler: {span_ns:.0f} ns a span, "
          f"{count_ns:.0f} ns a counter update")
    assert len(tracer.spans) == n and tracer.counters["cost"] == n
