"""The batch-32 settlement entry point zecale_tpu_torch/batch32_e2e.py
(the port of scripts/batch32_e2e.py --tpu): it refuses an unknown engine
and runs nowhere but on the card unless asked; on the card (``cuda``;
this file imports no JAX) it aggregates 2 nested proofs (wrapper domain
2^17) with the msm4 and msm8 engines, whose proofs must be equal and
valid, msm8 in the reference's 2 window chunks."""

import json

import pytest
import torch

from zecale_tpu_torch import batch32_e2e
from zecale_tpu_torch.snark import groth16_torch as gt

# One intra-op thread: the suite runs in several worker processes at
# once, and torch's OpenMP threads spinning in each of them slow every
# worker many times over.
torch.set_num_threads(1)


def test_batch32_e2e_refuses_an_unknown_engine(capsys):
    with pytest.raises(SystemExit) as e:
        batch32_e2e.main(["--engine", "msm4,msm5"])
    assert e.value.code == 2
    assert "'msm5' not in" in capsys.readouterr().err


def test_batch32_e2e_raises_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: batch32_e2e runs on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        batch32_e2e.main(["--batch", "2"])


@pytest.mark.cuda
def test_batch2_on_the_card_msm4_and_chunked_msm8_agree(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    out = tmp_path / "summary.json"
    rc = batch32_e2e.main(["--batch", "2", "--engine", "msm4,msm8",
                           "--cache", str(tmp_path), "--json", str(out)])
    assert rc == 0
    summary = json.loads(out.read_text())
    assert summary["domain"] == 1 << 17
    chunks = summary["proves"]["msm8"]["msm8_chunks"]
    assert chunks == {"g1": gt.msm8_chunks("bw6-761", summary["n_g1"]),
                      "g2": gt.msm8_chunks("bw6-761", summary["n_g2"])}
    assert chunks["g1"] == 2
