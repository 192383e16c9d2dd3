"""The port's benchmark: one run of one cell of ``BENCHMARK.json``.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

from the root of a checkout.  Prints as its last line on standard output
one JSON object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the
cell's end-to-end metrics, or with ``--trace 1`` its per-layer metrics),
``device`` and, traced, ``breakdown``; then the set-up's parts and, last,
``checks``: each number the reference compared, with its limit, which are
also the last lines on standard error.  Exits non-zero with no result
where the cell's GPUs are missing, or where JAX or the JAX package was
loaded.  Every build and cache stays inside the checkout
(``benchmark/cache/``, the port's ``zecale_tpu_torch/_build/``) or the
temporary directory.
"""

import time

T_PROCESS = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from benchmark import harness

    # the program's defaults run: no ZECALE_* setting reaches it
    for k in [k for k in os.environ if k.startswith("ZECALE_")]:
        del os.environ[k]
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(harness.CACHE,
                                                      "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(harness.CACHE, "triton")
    try:
        out = harness.run(args.workload, args.seed, args.seconds,
                          bool(args.trace), T_PROCESS)
    except harness.NoDevice as e:
        harness.log(f"no result: {e}")
        return 3
    bad = harness.forbidden_modules()
    if bad:
        harness.log(f"no result: loaded {', '.join(bad)}")
        return 4
    for k, c in out["checks"].items():
        print(f"check {k} {c['value']} limit {c['limit']}",
              file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
