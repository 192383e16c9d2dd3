# Copied from zecale_tpu/client/dummy_app_cli.py (JAX-free); only the docstrings' package names changed.
"""``zecale_dummy_app`` client CLI.

Reference analog: client/zecale/dummy_app (deploy.py:23-70, get.py:22-46) —
deploy the demo application bound to a dispatcher + expected vk hash, and
query its state.  With no EVM in this environment, "deployment" instantiates
the executable dispatcher/application engine models and persists their state
to a JSON instance file, exercising the same settlement semantics
(process_batch -> dispatch -> recorded scalar state).

    python -m zecale_tpu_torch.client.dummy_app_cli deploy VK_HASH \
        [--vk aggregator-vk.json] [--batch-size 2] [--instance app-instance.json]
    python -m zecale_tpu_torch.client.dummy_app_cli submit-batch BATCH_JSON \
        [--instance app-instance.json]
    python -m zecale_tpu_torch.client.dummy_app_cli get SCALAR \
        [--check HEXPARAMS] [--instance app-instance.json]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from ..contracts import dispatcher as dp
from ..serialization import json_codec as jc

DEFAULT_INSTANCE = "app-instance.json"


def _load_instance(path: str):
    with open(path) as f:
        inst = json.load(f)
    eng = dp.DispatcherEngine(inst["vk_words"], inst["batch_size"])
    app = dp.DummyApplicationEngine(eng, int(inst["vk_hash"], 16))
    app.scalars = {int(k): bytes.fromhex(v) for k, v in inst["state"].items()}
    return inst, eng, app


def _save_instance(path: str, inst, app) -> None:
    inst["state"] = {str(k): v.hex() for k, v in app.scalars.items()}
    with open(path, "w") as f:
        json.dump(inst, f, indent=2)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="zecale_dummy_app")
    ap.add_argument(
        "--eth-network", default=None,
        help="EVM chain-state file: deploy/get run against REAL bytecode "
             "(zecale_tpu_torch/evm) bound to a dispatcher deployed with "
             "`zecale deploy`; without it the executable engine model is "
             "used (word-level, no chain)",
    )
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("deploy")
    p.add_argument("vk_hash", help="expected nested vk hash (hex)")
    p.add_argument("--vk", default="aggregator-vk.json",
                   help="wrapper (aggregator) vk JSON")
    p.add_argument("--batch-size", type=int, default=2)
    p.add_argument("--instance", default=DEFAULT_INSTANCE)
    p.add_argument("--dispatcher-instance", default="zecale-instance",
                   help="dispatcher instance file (on-chain mode)")

    p = sub.add_parser("submit-batch")
    p.add_argument("batch_file")
    p.add_argument("--instance", default=DEFAULT_INSTANCE)

    p = sub.add_parser("get")
    p.add_argument("scalar", type=lambda s: int(s, 0))
    p.add_argument("--check", default=None)
    p.add_argument("--instance", default=DEFAULT_INSTANCE)

    args = ap.parse_args(argv)

    if args.eth_network is not None:
        return _onchain(args)

    if args.cmd == "deploy":
        with open(args.vk) as f:
            vk = jc.groth16_vk_from_json("bw6-761", json.load(f))
        inst = {
            "vk_words": dp.vk_to_contract_parameters(vk),
            "vk_hash": args.vk_hash,
            "batch_size": args.batch_size,
            "state": {},
        }
        with open(args.instance, "w") as f:
            json.dump(inst, f, indent=2)
        print(f"deployed; instance written to {args.instance}")
    elif args.cmd == "submit-batch":
        inst, eng, app = _load_instance(args.instance)
        with open(args.batch_file) as f:
            batch = json.load(f)
        ep = jc.extended_proof_from_json("bw6-761", batch["ext_proof"])
        try:
            ok = eng.process_batch(
                dp.proof_to_contract_parameters(ep.proof),
                dp.inputs_to_contract_parameters(ep.inputs),
                [bytes.fromhex(p) for p in batch["nested_parameters"]],
                app,
            )
        except (AssertionError, ValueError) as e:
            # application/dispatcher revert (same effect as an EVM revert)
            print(f"settlement reverted: {e}", file=sys.stderr)
            return 1
        if not ok:
            print("batch proof INVALID", file=sys.stderr)
            return 1
        _save_instance(args.instance, inst, app)
        print(f"batch settled; {len(app.scalars)} scalars recorded")
    elif args.cmd == "get":
        _, _, app = _load_instance(args.instance)
        v = app.get(args.scalar)
        if v is None:
            print("scalar not present")
            return 1
        print(f"scalar {args.scalar}: parameters {v.hex()}")
        if args.check is not None and v.hex() != args.check:
            print("CHECK FAILED", file=sys.stderr)
            return 1
    return 0


def _onchain(args) -> int:
    """On-chain mode: the app runs as real bytecode on the EVM chain
    (reference dummy_app/deploy.py:23-70 and get.py:22-46 semantics)."""
    from ..evm import vm
    from .dispatcher_contract import DispatcherContract, DummyAppContract

    chain = vm.Chain.load(args.eth_network)
    if args.cmd == "deploy":
        disp = DispatcherContract.load_instance(
            chain, args.dispatcher_instance
        )
        h = int(args.vk_hash, 16)
        vk_hash_words = (h >> 256, h & ((1 << 256) - 1))
        app = DummyAppContract.deploy(chain, disp.address, vk_hash_words)
        app.write_instance(args.instance)
        chain.save(args.eth_network)
        print(f"deployed app at {hex(app.address)}; "
              f"instance -> {args.instance}")
    elif args.cmd == "get":
        app = DummyAppContract.load_instance(chain, args.instance)
        v = app.get(args.scalar)
        if v == 0:
            print("scalar not present")
            return 1
        print(f"scalar {args.scalar}: value {hex(v)}")
        if args.check is not None and v != int(args.check, 16):
            print("CHECK FAILED", file=sys.stderr)
            return 1
    else:
        print("submit-batch on-chain: use `zecale submit-batch`",
              file=sys.stderr)
        return 2
    return 0


if __name__ == "__main__":
    sys.exit(main())
