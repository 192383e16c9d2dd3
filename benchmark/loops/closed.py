"""The closed loop: ``clients`` (1) sends its next request when the last
one is answered, back to back from the window's start until ``seconds``
have passed; the request still running then is let finish and counted."""

from __future__ import annotations

import sys
import time


def run(system, inp: dict, specs: list, seconds: float, rec,
        mix: dict) -> tuple:
    if mix.get("clients", 1) != 1:
        raise ValueError("the closed loop runs one client")
    done, failed = [], 0
    rec.requests = []
    t0 = time.time_ns()
    end = t0 + int(seconds * 1e9)
    i = 0
    with rec.annotate("bench.window"):
        while time.time_ns() < end:
            sp = specs[i % len(specs)]
            i += 1
            with rec.request() as cur:
                try:
                    answer = system.serve(inp, sp)
                except Exception as e:  # a request the system fails
                    failed += 1
                    print(f"[bench] request {sp['key']} failed: {e!r}",
                          file=sys.stderr, flush=True)
                    continue
                cur["ok"] = True
                cur["work"] = system.work(answer)
            done.append((sp, answer))
    return done, failed, t0, rec.requests[-1]["t1"] if rec.requests else t0
