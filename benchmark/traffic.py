"""The general traffic generator: a mix file of parameters, from
``benchmark/traffic/<name>.json``, and a seed give the requests.

Keys of a mix:
  loop               the request loop ``loops/<loop>.py`` that serves the
                     window ("closed": one client sends its next request
                     when the last one is answered, from the window's start)
  clients            clients of the loop (1)
  distinct_requests  K: request i of the window carries distinct input
                     i mod K; every seed draws K inputs of the same sizes
  invalid_every      k > 0: every k-th distinct input (0, k, 2k, ...)
                     carries one item the system must reject or mark
                     invalid, the others none; 0: none
  warmup_requests    requests served in set-up, before the window
  warmup_invalid     whether the warm-up requests carry an invalid item

A request spec is {"key": str, "rng": str, "invalid": bool}; the system
draws its inputs from ``random.Random(spec["rng"])``.
"""

from __future__ import annotations

import json
import os
from typing import List

DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "traffic")


def load(name: str) -> dict:
    with open(os.path.join(DIR, f"{name}.json")) as f:
        return json.load(f)


def distinct(mix: dict, seed: int) -> List[dict]:
    k = mix.get("invalid_every", 0)
    return [{"key": f"d{j}", "rng": f"{seed}/d{j}",
             "invalid": bool(k) and j % k == 0}
            for j in range(mix["distinct_requests"])]


def warmup(mix: dict, seed: int) -> List[dict]:
    return [{"key": f"w{j}", "rng": f"{seed}/w{j}",
             "invalid": bool(mix.get("warmup_invalid", False))}
            for j in range(mix.get("warmup_requests", 1))]
