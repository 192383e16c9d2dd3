"""A run of each cell on the CPU with the device prover replaced by a
simulator (``sim.py``): the harness, the port's service or circuit and
witness, and the reference run as on the card.  A sound run is judged
correct; each fault the cell can have, planted in the timed path, and the
control (a broken guarantee) are judged not correct."""

import time

import pytest
import torch

from benchmark import harness

from . import sim

torch.set_num_threads(1)

SEED = 2 ** 31 + 12345

#: (cell, configuration, curve, primary inputs, faults)
CELLS = {
    "agg2.served": ("zecale-b2", "bw6-761", 4,
                    ("state_unchanged", "answer_altered", "half_batch",
                     "control")),
}


@pytest.fixture(scope="module", params=sorted(CELLS))
def session(request, tmp_path_factory):
    name = request.param
    cfg, curve, npub, _ = CELLS[name]
    cache = str(tmp_path_factory.mktemp("cache"))
    prover = sim.keypair(cache, cfg, curve, npub)
    s = harness.Session(name, device="cpu", cache=cache, prover=prover)
    s.inputs(SEED)  # the warm-up: the first witness builds its program
    return s


def test_sound_run_is_correct(session):
    ok, checks, n = harness.probe(session, SEED + 1, 0.1)
    assert ok, checks
    assert n >= 1


def test_each_fault_is_not_correct(session):
    faults = CELLS[session.workload][3]
    for k, fault in enumerate(faults):
        ok, checks, _ = harness.probe(session, SEED + 10 + k,
                                      0.1, fault=fault)
        assert not ok, (fault, checks)


def test_result_line(session):
    out = harness.run(session.workload, SEED + 3, 0.1, False, time.time(),
                      session=session)
    assert out["correct"], out["checks"]
    assert list(out)[-1] == "checks"
    assert set(out["metrics"]) >= {"setup_s"}
    for k in ("correct", "attempted", "failed", "metrics", "device"):
        assert k in out
