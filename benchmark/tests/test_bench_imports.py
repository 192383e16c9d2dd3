"""What the benchmark loads: nothing on its chip path has the top-level
name ``jax``, ``jaxlib``, ``flax`` or ``zecale_tpu`` (names compared
whole, so ``zecale_tpu_torch`` passes), and the reference loads nothing
of the port either."""

import ast
import json
import os
import subprocess
import sys

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
FORBIDDEN = {"jax", "jaxlib", "flax", "zecale_tpu"}


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def _sources(sub=""):
    for d, dirs, files in os.walk(os.path.join(BENCH, sub)):
        dirs[:] = [x for x in dirs if x not in ("cache", "__pycache__")]
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_no_source_imports_jax_or_the_jax_package():
    for p in _sources():
        assert not set(_imports(p)) & FORBIDDEN, p


def test_reference_sources_import_nothing_of_the_port():
    for p in _sources("reference"):
        names = set(_imports(p))
        assert not names & (FORBIDDEN | {"zecale_tpu_torch", "torch"}), p


def _loaded(code):
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                         capture_output=True, text=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


CHIP_PATH = """
import json, sys, glob, importlib, os
import benchmark.run, benchmark.harness, benchmark.trace
for d in ("systems", "metrics", "loops"):
    for f in glob.glob(f"benchmark/{d}/*.py"):
        importlib.import_module(f"benchmark.{d}." + os.path.basename(f)[:-3])
import zecale_tpu_torch.api.server_main, zecale_tpu_torch.api.service
import zecale_tpu_torch.aggregator.circuit, zecale_tpu_torch.snark.groth16
import zecale_tpu_torch.snark.groth16_torch
import zecale_tpu_torch.utils.build, zecale_tpu_torch.native.witness
import torch.profiler
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""

REFERENCE = """
import json, sys
import benchmark.reference.groth16, benchmark.reference.setup
import benchmark.reference.native_pairing
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


def test_chip_path_loads_no_jax():
    top = _loaded(CHIP_PATH)
    assert "zecale_tpu_torch" in top
    assert not top & FORBIDDEN, top & FORBIDDEN


def test_reference_loads_nothing_of_the_port():
    top = _loaded(REFERENCE)
    assert not top & (FORBIDDEN | {"zecale_tpu_torch"})
