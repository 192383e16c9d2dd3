"""The benchmark's arithmetic on the CPU: rates over completed work, the
idle share as a union of intervals, the MSM count."""

import pytest

from benchmark import roofline, trace
from benchmark.harness import Record
from benchmark.metrics import (aggregated_per_s, host_s, idle_pct,
                               msm_roofline, qap_s)
from benchmark.reference import params as P

S = 10 ** 9  # ns a second


def _req(t0, t1, work=2, ok=True, prove_s=None, phases=None):
    r = {"t0": t0 * S, "t1": t1 * S, "ok": ok, "work": work,
         "phases": phases or {}}
    if prove_s is not None:
        r["prove_s"] = prove_s
    return r


def test_rate_counts_completed_work_over_the_window():
    rec = Record(window=(0, 10 * S), requests=[
        _req(0, 4), _req(4, 8), _req(8, 12)])
    # 6 proofs from the window's start to the last completion at 12 s
    assert aggregated_per_s.read(rec) == pytest.approx(6 / 12)


def test_rate_counts_a_stall_and_leaves_out_failures():
    rec = Record(window=(0, 10 * S), requests=[
        _req(0, 2), _req(2, 9, ok=False), _req(9, 11)])
    assert aggregated_per_s.read(rec) == pytest.approx(4 / 11)
    assert aggregated_per_s.read(Record(window=(0, S), requests=[
        _req(0, 2, ok=False)])) is None


def test_phase_means_are_window_sums_over_requests():
    rec = Record(window=(0, 0), requests=[
        _req(0, 3, prove_s=2.0, phases={"fft": 1.0}),
        _req(3, 7, prove_s=3.0, phases={"fft": 2.0})])
    assert qap_s.read(rec) == pytest.approx(1.5)
    assert host_s.read(rec) == pytest.approx(((3 - 2) + (4 - 3)) / 2)


def test_idle_share_is_the_complement_of_the_union():
    busy = trace.union([(5, 8), (1, 3), (2, 4), (7, 9), (12, 30)], 0, 20)
    assert busy == [(1, 4), (5, 9), (12, 20)]
    assert trace.gaps(busy, 0, 20) == [(0, 1), (4, 5), (9, 12)]
    rec = Record(trace={"busy_s": 15.0, "window_s": 20.0})
    assert idle_pct.read(rec) == pytest.approx(25.0)
    assert idle_pct.read(Record(trace=None)) is None


def test_gap_label_is_the_innermost_span():
    spans = [(0, 100, "service.aggregate"), (10, 20, "prover.fft")]
    assert trace.label_at(spans, 15) == "prover.fft"
    assert trace.label_at(spans, 50) == "service.aggregate"
    assert trace.label_at(spans, 150) == "harness"


def test_msm_count_by_hand():
    q = P.CURVES["bls12-377"].q  # 377 bits: 12 limbs, 576 ops a product
    # G1, n = 1000, 253-bit scalars: best window 8, 32 windows of 1000
    # mixed adds (11 products) and 256 full adds (12), 253 doublings (8)
    g1 = (32 * (1000 * 11 + 256 * 12) + 253 * 8) * 576
    assert roofline.msm_ops(1000, 253, q, 1) == g1 == 260_540_928
    # G2 over Fq2: 39, 42 and 27 products; window 8 is still best
    g2 = (32 * (1000 * 39 + 256 * 42) + 253 * 27) * 576
    assert roofline.msm_ops(1000, 253, q, 2) == g2 == 920_963_520
    # bytes: 1000 points of 2 x 12 limbs, 1000 scalars of 8 words
    assert roofline.msm_bytes(1000, 253, q, 1) == 1000 * (96 + 32)
    assert roofline.msm_least_s(1000, 253, q, 1) == pytest.approx(
        g1 / (132 * 64 * 1.98e9))


def test_msm_count_leaves_out_trivial_scalars():
    q = P.CURVES["bls12-377"].q  # 576 ops a product
    # 10 scalars 1: one mixed add (11 products) each, the point read
    assert roofline.msm_ops(1000, 253, q, 1, ones=10) == (
        roofline.msm_ops(1000, 253, q, 1) + 10 * 11 * 576)
    assert roofline.msm_bytes(1000, 253, q, 1, ones=10) == (
        1010 * 96 + 1000 * 32)
    assert roofline.msm_ops(0, 253, q, 1) == 0
    assert roofline.msm_ops(0, 253, q, 2, ones=3) == 3 * 39 * 576


class _Pk:
    def __init__(self, **kw):
        self.__dict__.update(kw)


def test_groth16_msms_count_by_hand():
    # variables: one, 1 public, 4 auxiliary; query points None where the
    # variable's polynomial is 0
    P_ = (1, 2)
    pk = _Pk(a_query=[P_, P_, None, P_, P_, P_],
             b_g1_query=[P_, None, None, P_, None, P_],
             b_g2_query=[P_, None, None, P_, None, P_],
             l_query=[P_, P_, None, P_], h_query=[P_] * 7)
    z = [1, 5, 0, 1, 9, 0]
    # A: one (1), 5, aux 1 and 9 (0 left out): n 2, ones 2; B: one, aux 1,
    # aux 0 -> n 0, ones 2; L over aux [0, 1, 9, 0]: 0 at a point, 1 at a
    # point, 9 at None, 0 -> n 0, ones 1; H dense 7
    assert roofline.groth16_msms(1, pk, z) == [
        ("g1", 2, 2), ("g1", 0, 2), ("g2", 0, 2), ("g1", 0, 1),
        ("g1", 7, 0)]


def test_msm_roofline_reads_least_over_phase():
    q = P.CURVES["bls12-377"].q
    pk = _Pk(a_query=[(1, 2)] * 3, b_g1_query=[(1, 2)] * 3,
             b_g2_query=[(1, 2)] * 3, l_query=[(1, 2)], h_query=[(1, 2)] * 3)
    z = [1, 7, 8]
    groups = {"g1": (253, q, 1), "g2": (253, q, 2)}
    least = sum(roofline.msm_least_s(n, *groups[g], ones)
                for g, n, ones in roofline.groth16_msms(1, pk, z))
    a = _req(0, 1, phases={"msm": 0.01})
    b = _req(1, 2, phases={"msm": 0.03})
    a["msms"] = b["msms"] = [(1, pk, z)]
    rec = Record(window=(0, 0), msm_groups=groups, requests=[
        a, b, _req(2, 3, phases={"msm": 5.0})])  # the last: untraced
    assert msm_roofline.read(rec) == pytest.approx(100 * 2 * least / 0.04)
    assert msm_roofline.read(Record(requests=[_req(0, 1)])) is None
