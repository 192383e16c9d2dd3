"""The harness is driven by data: a configuration, a traffic mix with a
request loop of its own, a per-layer metric and the cell that uses them
are added to a copy of the benchmark as new files and new entries of
``BENCHMARK.json`` alone, and the copy's harness finds and runs them by
name."""

import json
import os
import shutil
import subprocess
import sys
import textwrap

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)


def _files(top):
    out = {}
    for d, dirs, files in os.walk(top):
        dirs[:] = [x for x in dirs if x not in ("cache", "__pycache__")]
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, top)] = fh.read()
    return out


def test_a_cell_added_by_files_alone(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(BENCH, root / "benchmark",
                    ignore=shutil.ignore_patterns("cache", "__pycache__"))
    before = _files(root / "benchmark")
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        spec = json.load(f)
    n_before = {k: len(spec[k]) for k in ("configs", "workloads",
                                          "per_layer")}

    cfg = dict(json.load(open(root / "benchmark/configs/zecale-b2.json")),
               name="zecale-b1", batch_size=1)
    cfg["server_argv"] = [a if a != "2" else "1" for a in cfg["server_argv"]]
    (root / "benchmark/configs/zecale-b1.json").write_text(json.dumps(cfg))
    (root / "benchmark/traffic/served-invalid.json").write_text(json.dumps(
        {"loop": "burst", "clients": 1, "distinct_requests": 3,
         "invalid_every": 1, "warmup_requests": 2}))
    (root / "benchmark/loops/burst.py").write_text(textwrap.dedent(
        '''
        def run(system, inp, specs, seconds, rec, mix):
            done = [(sp, system.serve(inp, sp)) for sp in specs]
            return done, 0, 0, 1
        '''))
    (root / "benchmark/metrics/requests_n.py").write_text(textwrap.dedent(
        '''
        def read(record):
            return float(len(record.requests))
        '''))
    spec["configs"].append({"name": "zecale-b1", "source": "s",
                            "file": "benchmark/configs/zecale-b1.json",
                            "reduced": [], "why": "w"})
    spec["workloads"].append({"name": "agg1.invalid", "config": "zecale-b1",
                              "traffic": "served-invalid", "chips": 1,
                              "why": "w"})
    spec["per_layer"].append({"name": "requests_n.agg1", "unit": "1",
                              "better": "higher", "source": "host_clock",
                              "layer": "host: service and circuit witness",
                              "moves": "aggregated_per_s",
                              "workloads": ["agg1.invalid"]})
    spec["end_to_end"][0]["workloads"].append("agg1.invalid")
    (root / "BENCHMARK.json").write_text(json.dumps(spec))

    probe = textwrap.dedent('''
        import json
        from benchmark import harness, traffic
        spec = harness.load_spec()
        c = harness.cell(spec, "agg1.invalid")
        cfg = harness.config(spec, c["config"])
        mix = traffic.load(c["traffic"])
        specs = traffic.distinct(mix, 5)
        e2e = [m["name"] for m in harness.metrics_of(spec, c["name"], False)]
        pl = [m["name"] for m in harness.metrics_of(spec, c["name"], True)]
        rec = harness.Record(requests=[{}, {}])
        class Echo:
            def serve(self, inp, sp):
                return sp["key"]
        done = harness.loop(mix).run(Echo(), {}, specs, 1.0,
                                     harness.Recorder(False), mix)[0]
        print(json.dumps({"batch": cfg["batch_size"], "system": cfg["system"],
                          "invalid": [s["invalid"] for s in specs],
                          "warm": len(traffic.warmup(mix, 5)),
                          "e2e": e2e, "pl": pl,
                          "served": [a for _, a in done],
                          "value": harness.reader("requests_n.agg1")(rec)}))
    ''')
    out = subprocess.run([sys.executable, "-c", probe], cwd=root,
                         capture_output=True, text=True, check=True)
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got == {"batch": 1, "system": "aggregator",
                   "invalid": [True, True, True], "warm": 2,
                   "e2e": ["aggregated_per_s", "setup_s"],
                   "pl": ["requests_n.agg1"], "value": 2.0,
                   "served": ["d0", "d1", "d2"]}
    after = _files(root / "benchmark")
    assert {k: v for k, v in after.items() if k in before} == before
    assert sorted(set(after) - set(before)) == [
        "configs/zecale-b1.json", "loops/burst.py", "metrics/requests_n.py",
        "traffic/served-invalid.json"]
    assert all(len(spec[k]) == n + 1 for k, n in n_before.items())
