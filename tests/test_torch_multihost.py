"""Meshes across processes and the dry runs on the CPU: 2 worker processes
of 2 CPU shards each, joined by a gloo group (a FileStore in the test's
temporary directory), run the distributed iFFT (n = 16) and an
msm8_sharded, checked by process 0 against the host oracle
(zecale_tpu_torch/multihost_dryrun.py, started as ``python -m`` in a
subprocess); and the refusals of the entry points that would otherwise
run on a card that is not there.  Tolerance: exact."""

import os
import subprocess
import sys

import pytest
import torch

from zecale_tpu_torch import graft_entry, multihost_dryrun
from zecale_tpu_torch.parallel.mesh import make_mesh

# One intra-op thread: the suite runs in several worker processes at
# once, and torch's OpenMP threads spinning in each of them slow every
# worker many times over.
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(args, tmp_path, timeout=600):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO
    env["TMPDIR"] = str(tmp_path)  # the launcher's FileStore lies there
    return subprocess.run(
        [sys.executable, "-m", "zecale_tpu_torch.multihost_dryrun", *args],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=timeout)


def test_two_processes_of_two_cpu_shards_over_gloo(tmp_path):
    proc = _run(["--device", "cpu", "--shards", "2"], tmp_path)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "MULTIHOST OK: 4 shards (2 processes x 2, rank 0)" in proc.stdout
    assert "transport gloo-host" in proc.stdout
    assert proc.stdout.rstrip().splitlines()[-1].startswith(
        "launcher: all processes green")
    assert os.listdir(tmp_path) == []  # the store's directory is gone


def test_entry_points_refuse_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: nothing to refuse")
    with pytest.raises(RuntimeError, match="CUDA devices"):
        make_mesh(4)
    with pytest.raises(RuntimeError, match="CUDA devices"):
        graft_entry.dryrun_multichip(4)
    assert multihost_dryrun.launcher(device="cuda") == 2
    with pytest.raises(RuntimeError, match="rc=2"):
        graft_entry.dryrun_multihost()
    assert multihost_dryrun.main([]) == 2  # the command line's default
