# Copied from zecale_tpu/client/cli.py (JAX-free); only the docstrings' package names changed.
"""``zecale`` command-line client.

Reference analog: client/zecale/cli (click group with subcommands,
cli/__main__.py:80-88).  Same subcommand set and default filenames
(cli/defaults.py:5-17); argparse instead of click (not in the image).

    python -m zecale_tpu_torch.client.cli [--endpoint HOST:PORT] CMD ...

Commands:
    get-configuration
    get-verification-key   [--vk-out aggregator-vk.json]
    nested-verification-key-hash --key VK_JSON
    register --key VK_JSON --name APP
    submit   TX_JSON
    get-batch --name APP [--batch-out batch.json]
    check-batch BATCH_JSON --batch-size N
    deploy       [--batch-size N] [--instance zecale-instance]
    submit-batch BATCH_JSON --app-instance FILE [--wait]
    wait         TX_ID

On-chain commands run against the in-repo EVM chain (real bytecode,
zecale_tpu_torch/evm/); ``--eth-network`` names the JSON chain-state file that
plays the role of the reference's node endpoint.  The server
configuration is fetched lazily and cached to ``aggregator-config.cache``
(reference command_context.py:79-96 — cache invalidated on parse error).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from .aggregator_client import AggregatorClient

DEFAULT_ENDPOINT = "localhost:50052"
AGGREGATOR_VK_FILE = "aggregator-vk.json"
BATCH_FILE = "batch.json"
CONFIG_CACHE_FILE = "aggregator-config.cache"
INSTANCE_FILE = "zecale-instance"
CHAIN_FILE = "eth-chain.json"


class CommandContext:
    """Lazy client/config/chain plumbing (reference
    client/zecale/cli/command_context.py:22-114)."""

    def __init__(self, endpoint: str, transport: str, eth_network: str,
                 config_cache: str = CONFIG_CACHE_FILE):
        self.endpoint = endpoint
        self.transport = transport
        self.eth_network = eth_network
        self.config_cache = config_cache
        self._client = None
        self._config = None
        self._chain = None

    def client(self) -> AggregatorClient:
        if self._client is None:
            self._client = AggregatorClient(
                self.endpoint, transport=self.transport
            )
        return self._client

    def config(self) -> dict:
        """Server configuration, cached on disk; a corrupt cache is
        discarded and re-fetched (command_context.py:79-96)."""
        if self._config is not None:
            return self._config
        if os.path.exists(self.config_cache):
            try:
                with open(self.config_cache) as f:
                    self._config = json.load(f)
                return self._config
            except (json.JSONDecodeError, OSError):
                os.remove(self.config_cache)
        self._config = self.client().get_configuration()
        with open(self.config_cache, "w") as f:
            json.dump(self._config, f)
        return self._config

    def chain(self):
        from ..evm import vm

        if self._chain is None:
            self._chain = vm.Chain.load(self.eth_network)
        return self._chain

    def save_chain(self):
        if self._chain is not None:
            self._chain.save(self.eth_network)


def _write_json(path: str, obj) -> None:
    with open(path, "w") as f:
        json.dump(obj, f, indent=2)
    print(f"wrote {path}")


def _read_json(path: str):
    with open(path) as f:
        return json.load(f)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="zecale")
    ap.add_argument("--endpoint", default=DEFAULT_ENDPOINT)
    ap.add_argument(
        "--transport", choices=["proto", "json"], default="proto",
        help="wire format: proto3 (reference-compatible schema) or the "
             "canonical-JSON fallback service",
    )
    ap.add_argument(
        "--eth-network", default=CHAIN_FILE,
        help="EVM chain-state file (the analog of the reference's node "
             "endpoint)",
    )
    sub = ap.add_subparsers(dest="cmd", required=True)

    sub.add_parser("get-configuration")

    p = sub.add_parser("get-verification-key")
    p.add_argument("--vk-out", default=AGGREGATOR_VK_FILE)

    p = sub.add_parser("nested-verification-key-hash")
    p.add_argument("--key", required=True)

    p = sub.add_parser("register")
    p.add_argument("--key", required=True)
    p.add_argument("--name", required=True)

    p = sub.add_parser("submit")
    p.add_argument("tx_file")

    p = sub.add_parser("get-batch")
    p.add_argument("--name", required=True)
    p.add_argument("--batch-out", default=BATCH_FILE)

    p = sub.add_parser("check-batch")
    p.add_argument("batch_file")
    p.add_argument("--batch-size", type=int, required=True)

    p = sub.add_parser("deploy")
    p.add_argument("--batch-size", type=int, default=2)
    p.add_argument("--vk", default=None,
                   help="aggregator vk JSON (default: fetch from server)")
    p.add_argument("--instance", default=INSTANCE_FILE)

    p = sub.add_parser("submit-batch")
    p.add_argument("batch_file")
    p.add_argument("--instance", default=INSTANCE_FILE)
    p.add_argument("--app-address", required=True,
                   help="application contract address (hex) or app "
                        "instance file")
    p.add_argument("--wait", action="store_true",
                   help="wait for inclusion and print the gas used "
                        "(reference zecale_submit_batch.py:46-63)")

    p = sub.add_parser("wait")
    p.add_argument("tx_id")

    args = ap.parse_args(argv)
    ctx = CommandContext(args.endpoint, args.transport, args.eth_network)
    try:
        return _dispatch(args, ctx)
    except Exception as e:  # surface RPC / chain errors cleanly
        import grpc

        from ..evm.vm import EvmRevert

        if isinstance(e, grpc.RpcError):
            print(f"error: {e.details()}", file=sys.stderr)
            return 1
        if isinstance(e, EvmRevert):
            print(f"error: transaction reverted ({e.reason() or 'no reason'})",
                  file=sys.stderr)
            return 1
        raise


def _dispatch(args, ctx: CommandContext) -> int:
    cli = ctx.client if args.cmd not in (
        "check-batch", "deploy", "submit-batch", "wait"
    ) else None
    if cli is not None:
        cli = ctx.client()

    if args.cmd == "get-configuration":
        print(json.dumps(ctx.config(), indent=2))
    elif args.cmd == "get-verification-key":
        _write_json(args.vk_out, cli.get_verification_key())
    elif args.cmd == "nested-verification-key-hash":
        print(cli.get_nested_verification_key_hash(_read_json(args.key)))
    elif args.cmd == "register":
        h = cli.register_application(args.name, _read_json(args.key))
        print(h)
    elif args.cmd == "submit":
        cli.submit_nested_transaction(_read_json(args.tx_file))
        print("submitted")
    elif args.cmd == "get-batch":
        _write_json(args.batch_out, cli.get_aggregated_transaction(args.name))
    elif args.cmd == "deploy":
        from ..serialization import json_codec as jc
        from .dispatcher_contract import DispatcherContract

        if args.vk:
            vk_json = _read_json(args.vk)
        else:
            vk_json = ctx.client().get_verification_key()
        curve = "bw6-761"
        vk = jc.groth16_vk_from_json(curve, vk_json)
        disp = DispatcherContract.deploy(
            ctx.chain(), vk, args.batch_size, curve
        )
        disp.write_instance(args.instance)
        ctx.save_chain()
        print(f"deployed dispatcher at {hex(disp.address)}; "
              f"instance -> {args.instance}")
    elif args.cmd == "submit-batch":
        from .dispatcher_contract import DispatcherContract

        disp = DispatcherContract.load_instance(ctx.chain(), args.instance)
        if os.path.exists(args.app_address):
            app_addr = int(
                _read_json(args.app_address)["address"], 16
            )
        else:
            app_addr = int(args.app_address, 16)
        gas = disp.process_batch(_read_json(args.batch_file), app_addr)
        ctx.save_chain()
        print("batch submitted")
        if args.wait:
            # single-block chain: inclusion is immediate; report gas like
            # the reference's --wait path
            print(f"gasUsed = {gas}")
    elif args.cmd == "wait":
        # the in-repo chain executes synchronously — transactions are
        # final on return (parity with the reference `wait` command)
        print(f"tx {args.tx_id} confirmed")
    elif args.cmd == "check-batch":
        # results bitmask is primary input [1]
        # (reference: zecale_check_batch.py:25-31)
        batch = _read_json(args.batch_file)
        results = int(batch["ext_proof"]["inputs"][1], 16)
        print(f"results={hex(results)}")
        expect = (1 << args.batch_size) - 1
        if results != expect:
            print("at least one nested proof judged as invalid")
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
