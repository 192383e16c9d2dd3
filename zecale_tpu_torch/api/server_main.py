# Ported from zecale_tpu/api/server_main.py: the same flags and keypair cache, with Groth16Torch and Pghr13Torch as the device provers and Groth16Native as the native one.
"""aggregator-server entry point.

Reference analog: aggregator_server/aggregator_server.cpp main (:418-521):
load-or-generate the wrapper keypair (cached on disk), optionally dump the
R1CS, then serve the gRPC API.  Unlike the reference's compile-time
constants (batch_size=2, 1 input/proof hard-coded at :71-72), batch size,
input count and proving backend are runtime flags here.

``build_service`` builds the ``AggregatorService`` from the argument list
and ``serve`` serves it; only ``serve`` imports grpc, so the service object
runs where grpc is not installed.

``--device``, the torch prover's, is ``cuda`` unless the CPU is asked
for; without a GPU the entry point raises.  ``--prover torch`` (the
default) proves and runs the trusted setup on that device through
``Groth16Torch``, or ``Pghr13Torch`` with ``--snark PGHR13``; ``--prover
native`` proves and runs the setup on the host's native C engine through
``Groth16Native`` (GROTH16 only, on any ``--curve``, ``mnt6-298``
included); ``--prover host`` is the pure-Python oracle.  ``--curve
mnt6-298`` is refused with ``--prover torch`` (a != 0, which the device
group law does not serve).
The witness is computed in the serving process: ``ZECALE_PARALLEL_WITNESS``
forks, and is left off here as in the reference.

Usage:
    python -m zecale_tpu_torch.api.server_main [--keypair PATH]
        [--batch-size N] [--inputs-per-proof N] [--bind HOST:PORT]
        [--r1cs PATH] [--prover torch|native|host] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import pickle
import sys
import time

from ..snark.pghr13 import Pghr13VerificationKey
from ..utils.device import resolve


def load_or_generate_keypair(circuit, path: str, prover=None):
    if os.path.exists(path):
        logging.info("loading keypair from %s", path)
        with open(path, "rb") as f:
            kp = pickle.load(f)
        # vk shape check, like the reference (aggregator_server.cpp:490,502);
        # a PGHR13 vk holds its input commitments in ``ic``, a Groth16 one
        # in ``abc`` (the JAX package reads ``abc`` of both and raises
        # AttributeError on its own PGHR13 keypair)
        expect = circuit.num_primary_inputs + 1
        got = len(kp.vk.ic if isinstance(kp.vk, Pghr13VerificationKey)
                  else kp.vk.abc)
        if got != expect:
            raise ValueError(
                f"keypair vk shape {got} != expected {expect}"
            )
        return kp
    logging.info("generating trusted setup (this can take a while)...")
    t0 = time.time()
    kp = circuit.generate_trusted_setup(prover=prover)
    logging.info("setup done in %.1fs; writing %s", time.time() - t0, path)
    with open(path, "wb") as f:
        pickle.dump(kp, f)
    return kp


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument(
        "--keypair",
        default=os.environ.get(
            "ZECALE_SETUP_DIR", os.path.expanduser("~/.zecale")
        )
        + "/zecale_keypair.bin",
    )
    ap.add_argument("--batch-size", type=int, default=2)
    ap.add_argument("--inputs-per-proof", type=int, default=1)
    ap.add_argument("--bind", default="0.0.0.0:50052")
    ap.add_argument(
        "--r1cs", default=None, help="dump the wrapper R1CS to this JSON path"
    )
    ap.add_argument(
        "--prover", choices=["host", "native", "torch"], default="torch",
        help="torch = PyTorch/CUDA prover on --device; native = the "
             "host's native C engine (GROTH16 only); "
             "host = pure-Python oracle",
    )
    ap.add_argument(
        "--device", default="cuda",
        help="device of the torch prover (cuda, or cpu for the plain "
             "versions of the kernels)",
    )
    ap.add_argument(
        "--snark",
        choices=["GROTH16", "PGHR13"],
        default="GROTH16",
        help="wrapper snark (reference ZECALE_SNARK CMake option)",
    )
    ap.add_argument(
        "--nested-snark",
        choices=["GROTH16", "PGHR13"],
        default="GROTH16",
        help="in-circuit nested verifier family (nverifierT trait)",
    )
    ap.add_argument(
        "--curve",
        choices=["bw6-761", "mnt6-298"],
        default="bw6-761",
        help="wrapper curve (reference ZECALE_CURVE CMake option)",
    )
    return ap


def build_service(argv=None):
    """(AggregatorService, parsed arguments) from the argument list: the
    prover, the circuit and the keypair (loaded, or generated and
    written), everything of ``main`` but serving."""
    ap = parser()
    args = ap.parse_args(argv)
    prover = None
    if args.prover == "torch":
        device = resolve(args.device)  # raises where there is no GPU
        if args.snark == "GROTH16":
            from ..snark.groth16_torch import Groth16Torch as Prover
        else:
            from ..snark.pghr13_torch import Pghr13Torch as Prover

        try:
            prover = Prover(args.curve, device=device)
        except ValueError as e:  # the a = 0 law refuses the curve
            ap.error(f"--prover torch cannot serve --curve {args.curve}: "
                     f"{e}")
    elif args.prover == "native":
        if args.snark != "GROTH16":
            ap.error("--prover native serves GROTH16 only")
        from ..snark.groth16_native import Groth16Native

        prover = Groth16Native(args.curve)

    from ..aggregator.circuit import AggregatorCircuit
    from .service import AggregatorService

    logging.info(
        "building aggregator circuit (batch=%d, inputs/proof=%d)...",
        args.batch_size,
        args.inputs_per_proof,
    )
    t0 = time.time()
    circuit = AggregatorCircuit(
        args.inputs_per_proof,
        args.batch_size,
        wrapper_curve=args.curve,
        nested_snark=args.nested_snark,
        wrapper_snark=args.snark,
    )
    logging.info(
        "circuit ready in %.1fs: %d constraints",
        time.time() - t0,
        circuit.r1cs.num_constraints,
    )

    if args.r1cs:
        with open(args.r1cs, "w") as f:
            json.dump(
                {
                    "num_constraints": circuit.r1cs.num_constraints,
                    "num_variables": circuit.r1cs.num_variables,
                    "num_primary": circuit.r1cs.num_primary,
                },
                f,
            )
        logging.info("r1cs summary written to %s", args.r1cs)

    os.makedirs(os.path.dirname(os.path.abspath(args.keypair)),
                exist_ok=True)
    keypair = load_or_generate_keypair(circuit, args.keypair, prover)
    return AggregatorService(circuit, keypair, prover=prover), args


def serve(svc, args) -> None:
    from . import grpc_server

    grpc_server.serve(svc, bind=args.bind)


def main(argv=None) -> int:
    logging.basicConfig(
        level=logging.INFO, format="[%(levelname)s] %(message)s"
    )
    svc, args = build_service(argv)
    serve(svc, args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
