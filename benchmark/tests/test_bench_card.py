"""On the card: the control, a broken guarantee planted in the timed
path, comes out not correct at the cell's own size and load on three
seeds, and the program on three others comes out correct (one process,
one set-up).  Each window's readings are printed as a JSON line (seen
with ``pytest -s``).  Skips without a GPU."""

import json

import pytest

from benchmark import harness

WARM_SEED = 3000000010
CONTROL_SEEDS = (3000000001, 3000000002, 3000000003)
SEEDS = (3000000011, 3000000012, 3000000013)


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["agg2.served"])
def test_control_fails_program_passes(workload):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    seconds = harness.load_spec()["run_seconds"]
    s = harness.Session(workload)
    s.inputs(WARM_SEED)
    for seed, fault in ([(x, None) for x in SEEDS]
                        + [(x, "control") for x in CONTROL_SEEDS]):
        ok, checks, n = harness.probe(s, seed, seconds, fault=fault)
        print(json.dumps({"seed": seed, "fault": fault, "correct": ok,
                          "answers": n, "checks": checks}), flush=True)
        assert ok is (fault is None), (seed, fault, checks)
