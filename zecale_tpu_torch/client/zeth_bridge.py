# Copied from zecale_tpu/client/zeth_bridge.py (JAX-free); only the docstrings' package names changed.
"""Bridge from an application client's proof bundle to a Zecale nested
transaction (reference analog: client/zeth_zecale create-nested-tx,
create_nested_tx.py:17-63 — there the bundle is a Zeth MixParameters file
whose mix parameters become the dispatch `parameters` blob).

The zeth package is not available in this environment, so the bridge
accepts the generic bundle shape

    { "extended_proof": {"proof": ..., "inputs": [...]},
      "parameters": "<hex>" }            (or any app-specific payload dict)

and emits the nested-transaction JSON the aggregator accepts.

    python -m zecale_tpu_torch.client.zeth_bridge create-nested-tx \
        BUNDLE_JSON --app NAME [--fee N] [--out tx.json]
"""

from __future__ import annotations

import argparse
import json
import sys


def create_nested_tx(
    bundle: dict, app_name: str, fee_in_wei: int = 0
) -> dict:
    ep = bundle["extended_proof"]
    params = bundle.get("parameters", "")
    if isinstance(params, (dict, list)):
        # app-specific structured payload: canonical-JSON-encode to bytes
        params = json.dumps(params, sort_keys=True).encode().hex()
    return {
        "app_name": app_name,
        "extended_proof": ep,
        "parameters": params,
        "fee_in_wei": fee_in_wei,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="zeth_zecale")
    sub = ap.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("create-nested-tx")
    p.add_argument("bundle_file")
    p.add_argument("--app", required=True)
    p.add_argument("--fee", type=int, default=0)
    p.add_argument("--out", default="nested-tx.json")
    p.add_argument(
        "--zeth", action="store_true",
        help="treat the bundle as a Zeth MixParameters JSON and ABI-"
             "encode its mix parameters as the dispatch blob "
             "(reference create_nested_tx semantics)",
    )
    args = ap.parse_args(argv)

    with open(args.bundle_file) as f:
        bundle = json.load(f)
    if args.zeth:
        mp = MixParameters.from_json_dict(bundle)
        tx = create_zeth_nested_tx(mp, args.fee, app_name=args.app)
    else:
        tx = create_nested_tx(bundle, args.app, args.fee)
    with open(args.out, "w") as f:
        json.dump(tx, f, indent=2)
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())


# ---------------------------------------------------------------------------
# Zeth MixParameters fidelity (round-4 VERDICT item 9)
#
# The reference bridge (client/zeth_zecale/create_nested_tx.py:17-63)
# converts a Zeth MixParameters object and encodes its mix parameters as
# the dispatch `parameters` blob via zeth's
# mix_parameters_to_dispatch_parameters: the one-time-signature public key
# (4 words), the signature (1 word) and the note ciphertexts, ABI-encoded
# as (bytes32[4], bytes32, bytes[]).  The zeth package is absent from
# this environment, so the structures are reimplemented here to the same
# wire shape and exercised against the in-tree joinsplit application.
# ---------------------------------------------------------------------------


class MixParameters:
    """Zeth mix-parameters analog: the extended proof plus the off-
    circuit artifacts the on-chain mixer needs (OT-signature key/value,
    receiver ciphertexts)."""

    def __init__(self, extended_proof: dict, signature_vk, signature: int,
                 ciphertexts):
        assert len(signature_vk) == 4
        self.extended_proof = extended_proof
        self.signature_vk = [int(v) for v in signature_vk]
        self.signature = int(signature)
        self.ciphertexts = [bytes(c) for c in ciphertexts]

    def to_json_dict(self) -> dict:
        return {
            "extended_proof": self.extended_proof,
            "signature_vk": [hex(v) for v in self.signature_vk],
            "signature": hex(self.signature),
            "ciphertexts": [c.hex() for c in self.ciphertexts],
        }

    @staticmethod
    def from_json_dict(d: dict) -> "MixParameters":
        return MixParameters(
            extended_proof=d["extended_proof"],
            signature_vk=[int(v, 16) for v in d["signature_vk"]],
            signature=int(d["signature"], 16),
            ciphertexts=[bytes.fromhex(c) for c in d["ciphertexts"]],
        )


def _abi_bytes32(v: int) -> bytes:
    return int(v).to_bytes(32, "big")


def mix_parameters_to_dispatch_parameters(mp: MixParameters) -> bytes:
    """ABI-encode (bytes32[4] vk, bytes32 sigma, bytes[] ciphertexts) —
    the layout the reference's Zeth contract expects in its dispatch
    entry point (head/tail encoding per the Solidity ABI spec)."""
    head_static = b"".join(_abi_bytes32(v) for v in mp.signature_vk)
    head_static += _abi_bytes32(mp.signature)
    # dynamic bytes[] rides after the static head via an offset word
    offset = len(head_static) + 32
    out = head_static + _abi_bytes32(offset)
    n = len(mp.ciphertexts)
    tail = _abi_bytes32(n)
    # element offsets relative to the start of the array data
    elem_offsets = []
    cur = 32 * n
    for c in mp.ciphertexts:
        elem_offsets.append(cur)
        cur += 32 + (-(-len(c) // 32)) * 32
    for o in elem_offsets:
        tail += _abi_bytes32(o)
    for c in mp.ciphertexts:
        tail += _abi_bytes32(len(c))
        tail += c + b"\0" * ((-len(c)) % 32)
    return out + tail


def dispatch_parameters_to_mix_parameters(
    blob: bytes, extended_proof: dict
) -> MixParameters:
    """Inverse of mix_parameters_to_dispatch_parameters (what the on-
    chain application's decoder does with the forwarded blob)."""
    vk = [int.from_bytes(blob[i * 32 : (i + 1) * 32], "big")
          for i in range(4)]
    sigma = int.from_bytes(blob[128:160], "big")
    arr_off = int.from_bytes(blob[160:192], "big")
    n = int.from_bytes(blob[arr_off : arr_off + 32], "big")
    data0 = arr_off + 32
    cts = []
    for i in range(n):
        eo = int.from_bytes(
            blob[data0 + 32 * i : data0 + 32 * (i + 1)], "big"
        )
        ln = int.from_bytes(blob[data0 + eo : data0 + eo + 32], "big")
        cts.append(blob[data0 + eo + 32 : data0 + eo + 32 + ln])
    return MixParameters(extended_proof, vk, sigma, cts)


def create_zeth_nested_tx(
    mix_params: MixParameters, fee_in_wei: int = 0,
    app_name: str = "zeth",
) -> dict:
    """Reference _create_zeth_nested_tx semantics: proof passes through,
    mix parameters become the dispatch blob."""
    return {
        "app_name": app_name,
        "extended_proof": mix_params.extended_proof,
        "parameters": mix_parameters_to_dispatch_parameters(
            mix_params
        ).hex(),
        "fee_in_wei": fee_in_wei,
    }
