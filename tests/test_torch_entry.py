"""The port's entry points (zecale_tpu_torch: api/server_main.py,
aggregate_e2e.py, bench.py, graft_entry.py, rollup_e2e.py,
utils/profiling.py) on the
CPU: server_main's refusals, its keypair checks (Groth16 and PGHR13) and
its provers, the phase profiler's
records against the JAX package's, graft_entry's function against the
host oracles on the reference's example data, and the bench main at a
small shape.  Tolerance: exact."""

import io
import json
import os
import pickle
import random
import tempfile
import types

import pytest
import torch

import __graft_entry__ as graft_ref
from zecale_tpu.api import server_main as server_main_ref
from zecale_tpu.utils import profiling as profiling_ref
from zecale_tpu_torch import aggregate_e2e, bench, graft_entry, rollup_e2e
from zecale_tpu_torch.api import server_main
from zecale_tpu_torch.ec import host_curve as hc
from zecale_tpu_torch.ec.proj_curve import ProjCurve
from zecale_tpu_torch.ff.fp_torch import field
from zecale_tpu_torch.poly.domain_host import domain
from zecale_tpu_torch.snark.pghr13 import (
    Pghr13KeyPair, Pghr13VerificationKey)
from zecale_tpu_torch.utils import profiling

# One intra-op thread: the suite runs in several worker processes at
# once, and torch's OpenMP threads spinning in each of them slow every
# worker many times over.
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: the keys of bench.py's JSON line (bench.py:189-203)
BENCH_KEYS = ["metric", "value", "unit", "vs_baseline", "engine", "points",
              "aggregated_proofs_per_s", "e2e_batch", "e2e_warm_prove_s",
              "e2e_cold_prove_s"]


# ---------------------------------------------------------------------------
# no entry point falls back to the CPU
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["server_main", "aggregate_e2e", "bench",
                                  "graft_entry", "rollup_e2e"])
def test_entry_point_raises_without_a_gpu(name):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the entry points run on it")
    call = {
        "server_main": lambda: server_main.build_service([]),
        "aggregate_e2e": lambda: aggregate_e2e.main([]),
        "bench": bench.run,
        "graft_entry": graft_entry.entry,
        "rollup_e2e": lambda: rollup_e2e.main([]),
    }[name]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call()


# ---------------------------------------------------------------------------
# server_main
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("argv, says", [
    (["--snark", "PGHR13", "--curve", "mnt6-298"], "a = 0"),
    (["--curve", "mnt6-298"], "a = 0"),
])
def test_server_main_refuses_what_the_torch_prover_cannot_serve(
        argv, says, capsys):
    with pytest.raises(SystemExit) as e:
        server_main.build_service(argv + ["--device", "cpu"])
    assert e.value.code == 2
    assert says in capsys.readouterr().err


def _keypair(n_abc):
    return types.SimpleNamespace(
        pk="pk", vk=types.SimpleNamespace(abc=list(range(n_abc))))


class _Circuit:
    num_primary_inputs = 3

    def __init__(self):
        self.setups = []

    def generate_trusted_setup(self, prover=None):
        self.setups.append(prover)
        return _keypair(self.num_primary_inputs + 1)


@pytest.mark.parametrize("n_abc", [3, 4, 5])
def test_load_or_generate_keypair_matches_reference(tmp_path, n_abc):
    path = str(tmp_path / "kp.bin")
    with open(path, "wb") as f:
        pickle.dump(_keypair(n_abc), f)

    def outcome(fn):
        try:
            return len(fn(_Circuit(), path).vk.abc)
        except ValueError as e:
            return str(e)

    want = outcome(server_main_ref.load_or_generate_keypair)
    assert outcome(server_main.load_or_generate_keypair) == want
    assert (want == 4) == (n_abc == 4)


def _pghr13_keypair(n_ic):
    points = dict.fromkeys(("a", "b", "c", "g", "gb1", "gb2", "z"))
    return Pghr13KeyPair(pk="pk", vk=Pghr13VerificationKey(
        ic=list(range(n_ic)), **points))


@pytest.mark.parametrize("n_ic", [3, 4, 5])
def test_load_or_generate_keypair_checks_the_pghr13_ic(tmp_path, n_ic):
    path = str(tmp_path / "kp.bin")
    with open(path, "wb") as f:
        pickle.dump(_pghr13_keypair(n_ic), f)
    if n_ic == 4:
        kp = server_main.load_or_generate_keypair(_Circuit(), path)
        assert kp.vk.ic == [0, 1, 2, 3]
    else:
        with pytest.raises(ValueError, match=f"vk shape {n_ic} != "):
            server_main.load_or_generate_keypair(_Circuit(), path)
    # the JAX package reads vk.abc, which a PGHR13 vk does not have
    with pytest.raises(AttributeError, match="abc"):
        server_main_ref.load_or_generate_keypair(_Circuit(), path)


def test_load_or_generate_keypair_generates_and_writes(tmp_path):
    path = str(tmp_path / "kp.bin")
    circ = _Circuit()
    kp = server_main.load_or_generate_keypair(circ, path, prover="p")
    assert circ.setups == ["p"] and len(kp.vk.abc) == 4
    again = server_main.load_or_generate_keypair(circ, path, prover="p")
    assert circ.setups == ["p"] and again.vk.abc == kp.vk.abc


def test_build_service_loads_keypair_for_the_torch_prover(tmp_path):
    path = str(tmp_path / "kp.bin")
    with open(path, "wb") as f:
        pickle.dump(_keypair(4), f)
    r1cs = str(tmp_path / "r1cs.json")
    svc, args = server_main.build_service(
        ["--batch-size", "1", "--prover", "torch", "--device", "cpu",
         "--keypair", path, "--r1cs", r1cs])
    assert args.bind == "0.0.0.0:50052"
    assert type(svc.prover).__name__ == "Groth16Torch"
    assert svc.prover.device.type == "cpu"
    assert svc.circuit.num_proofs == 1 and svc.keypair.vk.abc == [0, 1, 2, 3]
    with open(r1cs) as f:
        summary = json.load(f)
    assert summary["num_primary"] == 3
    assert summary["num_constraints"] == svc.circuit.r1cs.num_constraints
    # a keypair of another batch size is refused at load
    with pytest.raises(ValueError, match="vk shape"):
        server_main.build_service(
            ["--batch-size", "2", "--device", "cpu", "--keypair", path])


def test_build_service_serves_pghr13_with_the_torch_prover(tmp_path):
    path = str(tmp_path / "kp.bin")
    with open(path, "wb") as f:
        pickle.dump(_pghr13_keypair(4), f)
    svc, _ = server_main.build_service(
        ["--batch-size", "1", "--snark", "PGHR13", "--device", "cpu",
         "--keypair", path])
    assert type(svc.prover).__name__ == "Pghr13Torch"
    assert svc.prover.device.type == "cpu"
    assert svc.circuit.wrapper_snark == "PGHR13"
    assert svc.circuit.wsnark.name == "PGHR13"
    assert svc.keypair.vk.ic == [0, 1, 2, 3]


# ---------------------------------------------------------------------------
# PhaseProfiler
# ---------------------------------------------------------------------------


def _nested_run(prof):
    with prof.phase("setup"):
        pass
    with prof.phase("prove"):
        with prof.phase("fft"):
            torch.ones(4).sum()
        with prof.phase("msm"):
            with prof.phase("reduce"):
                pass
        prof.merge_timings("prove/msm", {"k1": 0.5, "host": 0.25})
    with prof.phase("prove"):  # a second trace of "prove" replaces the first
        torch.zeros(2).add(1)
    return prof


def _shape(records):
    return [(r["phase"], r["depth"]) for r in records]


def test_phase_profiler_records_match_reference(tmp_path, monkeypatch):
    monkeypatch.delenv("ZECALE_JAX_TRACE", raising=False)
    monkeypatch.delenv("ZECALE_TORCH_TRACE", raising=False)
    want = _nested_run(profiling_ref.PhaseProfiler())
    got = _nested_run(profiling.PhaseProfiler())
    assert _shape(got.records) == _shape(want.records)
    assert [k for r in got.records for k in r] == [
        k for r in want.records for k in r]
    assert got.total("prove/msm/k1") == want.total("prove/msm/k1") == 0.5
    assert got.total("prove") == sum(
        r["seconds"] for r in got.records if r["phase"] == "prove")
    got.to_json(str(tmp_path / "got.json"))
    want.to_json(str(tmp_path / "want.json"))
    with open(tmp_path / "got.json") as f, open(tmp_path / "want.json") as g:
        assert _shape(json.load(f)["phases"]) == _shape(
            json.load(g)["phases"])
    out_got, out_want = io.StringIO(), io.StringIO()
    got.report(out_got)
    want.report(out_want)
    names = lambda s: [ln.split()[0] for ln in s.getvalue().splitlines()]  # noqa: E731
    assert names(out_got) == names(out_want)
    assert got.device == {}


def test_phase_profiler_writes_a_trace_per_top_level_phase(
        tmp_path, monkeypatch):
    monkeypatch.setenv("ZECALE_TORCH_TRACE", str(tmp_path / "trace"))
    prof = _nested_run(profiling.PhaseProfiler())
    assert sorted(os.listdir(tmp_path / "trace")) == ["prove.json",
                                                      "setup.json"]
    with open(tmp_path / "trace" / "prove.json") as f:
        events = json.load(f)["traceEvents"]
    assert any("aten::" in e.get("name", "") for e in events)
    assert set(prof.device) == {"setup", "prove"}
    assert prof.device["prove"]["device_ms"] == 0  # the CPU has no kernels


# ---------------------------------------------------------------------------
# graft_entry
# ---------------------------------------------------------------------------


def test_graft_entry_example_data_is_the_references():
    ref = graft_ref._example_data()
    r, az, bz, cz, _, scalars, _, pts, _ = ref
    d = graft_entry.example_data("cpu")
    assert (d["r"], d["az"], d["bz"], d["cz"], d["scalars"], d["pts"]) == (
        r, az, bz, cz, scalars, pts)


def test_graft_entry_matches_host_oracles():
    fn, args = graft_entry.entry("cpu")
    h, acc = fn(*args)
    d = graft_entry.example_data("cpu")
    r = d["r"]
    dm = domain(graft_entry.N_DOMAIN, r)
    a_c, b_c, c_c = (dm.coset_fft(dm.ifft(v))
                     for v in (d["az"], d["bz"], d["cz"]))
    h_coset = dm.divide_by_z_on_coset(
        [(x * y - z) % r for x, y, z in zip(a_c, b_c, c_c)])
    assert field(r).unpack_mont(h) == dm.coset_ifft(h_coset)
    assert tuple(h.shape) == (16, 12) and tuple(acc.shape) == (1, 3, 24)
    got = ProjCurve(graft_entry.CURVE, False).to_affine_host(acc)[0]
    assert got == hc.g1_curve("bw6-761").msm(d["scalars"], d["pts"])


# ---------------------------------------------------------------------------
# bench
# ---------------------------------------------------------------------------


def test_bench_main_on_the_cpu(monkeypatch, capsys):
    for k in ("ZECALE_USE_MSM8", "BENCH_RANDOM_POINTS", "BENCH_PHASES",
              "BENCH_WINDOW_C", "BENCH_CURVE"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("BENCH_MSM_N", "64")
    monkeypatch.setenv("BENCH_E2E", "0")
    tracked = os.path.join(REPO, "BENCH_PHASES.json")
    with open(tracked, "rb") as f:
        before = f.read()
    phases = os.path.join(tempfile.gettempdir(),
                          "zecale_tpu_torch_bench_phases.json")
    if os.path.exists(phases):
        os.remove(phases)
    assert bench.main("cpu") == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert list(out) == BENCH_KEYS
    assert out["metric"] == "msm_bls12-377_g1_mpoints_per_s_per_chip"
    assert out["engine"] == "msm4" and out["points"] == "cycled64"
    # the rate is rounded to 4 places as bench.py rounds it: on the CPU,
    # 64 points take seconds and it may read 0.0
    assert out["value"] >= 0 and out["vs_baseline"] == out["value"]
    assert out["e2e_batch"] is None
    with open(phases) as f:
        names = [r["phase"] for r in json.load(f)["phases"]]
    assert names[:4] == ["pack", "compile+first", "steady", "verify"]
    with open(tracked, "rb") as f:
        assert f.read() == before


# ---------------------------------------------------------------------------
# rollup_e2e
# ---------------------------------------------------------------------------


def test_rollup_keypair_cache_is_keyed_by_rng_and_r1cs(tmp_path):
    from zecale_tpu_torch.aggregator import dummy_app as da

    r1cs, _ = da.dummy_app_setup("bls12-377", random.Random(1))
    made = []

    def setup(cs, rng):
        made.append(cs.num_constraints)
        return ("keypair", rng.randrange(1 << 64))

    def run(cs, seed=17):
        rng = random.Random(seed)
        kp, hit = rollup_e2e.cached_setup(str(tmp_path), "kp", cs, rng,
                                          setup)
        return kp, hit, rng.random()

    first = run(r1cs)
    assert first[1] is False and made == [1]
    # a hit gives the keypair and leaves the rng where the setup left it
    assert run(r1cs) == (first[0], True, first[2])
    assert made == [1]
    # another rng state or another constraint system misses
    assert run(r1cs, seed=18)[1] is False
    r1cs.add_constraint([(0, 1)], [(0, 1)], [(0, 1)])
    assert run(r1cs)[1] is False
    assert made == [1, 1, 2]


def test_setup_cache_path_names_the_file_cached_setup_writes(tmp_path):
    from zecale_tpu_torch.aggregator import dummy_app as da

    r1cs, _ = da.dummy_app_setup("bls12-377", random.Random(1))
    rng = random.Random(5)
    path = rollup_e2e.setup_cache_path(str(tmp_path), "kp", r1cs, rng)
    assert not os.path.exists(path)
    rollup_e2e.cached_setup(str(tmp_path), "kp", r1cs, rng,
                            lambda cs, r: ("keypair", r.random()))
    assert os.listdir(tmp_path) == [os.path.basename(path)]
    with open(path, "rb") as f:
        assert pickle.load(f)[0][0] == "keypair"
