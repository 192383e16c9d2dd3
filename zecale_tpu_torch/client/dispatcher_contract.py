# Copied from zecale_tpu/client/dispatcher_contract.py (JAX-free); only the docstrings' package names changed.
"""On-chain client bindings for the ZecaleDispatcher, running against the
in-repo EVM chain (zecale_tpu_torch/evm/) instead of a web3 node.

Reference analog: client/zecale/core/dispatcher_contract.py:23-102
(deploy / process_batch / dump_logs) — the web3 send path is replaced by
the interpreter chain (a JSON chain-state file plays the role of the
--eth-network node endpoint), everything else keeps the reference
semantics: proofs and inputs are encoded to uint256 words with the
contract word layouts, gas is reported after settlement
(zecale_submit_batch.py:55-57).
"""

from __future__ import annotations

import json
from typing import List, Optional, Sequence

from ..contracts.dispatcher import (
    inputs_to_contract_parameters,
    proof_to_contract_parameters,
    vk_to_contract_parameters,
)
from ..evm import contracts_asm, vm
from ..serialization import json_codec as jc


class DispatcherContract:
    """Deployed ZecaleDispatcher instance handle."""

    def __init__(self, chain: vm.Chain, address: int, batch_size: int):
        self.chain = chain
        self.address = address
        self.batch_size = batch_size

    # -- deployment -------------------------------------------------------
    @staticmethod
    def deploy(chain: vm.Chain, vk, batch_size: int,
               curve_name: str = "bw6-761") -> "DispatcherContract":
        """Deploy + initialize the dispatcher with the aggregator VK
        (reference dispatcher_contract.py:37-60)."""
        vk_words = vk_to_contract_parameters(vk)
        addr = chain.deploy(contracts_asm.dispatcher_code())
        chain.call(
            addr, contracts_asm.encode_init_dispatcher(vk_words, batch_size)
        )
        return DispatcherContract(chain, addr, batch_size)

    # -- instance files (reference zecale-instance workflow) --------------
    def write_instance(self, path: str):
        with open(path, "w") as f:
            json.dump(
                {"address": hex(self.address),
                 "batch_size": self.batch_size},
                f,
            )

    @staticmethod
    def load_instance(chain: vm.Chain, path: str) -> "DispatcherContract":
        with open(path) as f:
            j = json.load(f)
        return DispatcherContract(
            chain, int(j["address"], 16), j["batch_size"]
        )

    # -- settlement --------------------------------------------------------
    def process_batch(
        self,
        batch_json: dict,
        app_address: int,
        nested_parameters: Optional[Sequence[bytes]] = None,
        curve_name: str = "bw6-761",
    ) -> int:
        """Settle an aggregated transaction (batch.json as produced by the
        `get-batch` CLI command).  Returns the gas used (reference
        zecale_submit_batch.py:46-63)."""
        ep = jc.extended_proof_from_json(
            curve_name, batch_json["ext_proof"]
        )
        proof_words = proof_to_contract_parameters(ep.proof)
        input_words = inputs_to_contract_parameters(ep.inputs)
        if nested_parameters is None:
            nested_parameters = [
                bytes.fromhex(p)
                for p in batch_json.get("nested_parameters", [])
            ]
        cd = contracts_asm.encode_process_batch(
            proof_words, input_words, list(nested_parameters),
            app_address,
        )
        ret, gas = self.chain.call(self.address, cd)
        if int.from_bytes(ret, "big") != 1:
            raise vm.EvmRevert(b"")
        return gas

    # -- observability ------------------------------------------------------
    def dump_logs(self) -> List[dict]:
        """Reference dispatcher_contract.py:96-102 analog."""
        out = []
        for l in self.chain.logs:
            if l.address == self.address:
                out.append(
                    {"topics": [hex(t) for t in l.topics],
                     "data": l.data.hex()}
                )
        return out


class DummyAppContract:
    """Deployed DummyApplication handle (reference dummy_app/deploy.py)."""

    def __init__(self, chain: vm.Chain, address: int):
        self.chain = chain
        self.address = address

    @staticmethod
    def deploy(chain: vm.Chain, dispatcher_address: int,
               vk_hash_words) -> "DummyAppContract":
        addr = chain.deploy(contracts_asm.dummy_application_code())
        chain.call(
            addr,
            contracts_asm.encode_init_app(
                dispatcher_address, tuple(vk_hash_words)
            ),
        )
        return DummyAppContract(chain, addr)

    def write_instance(self, path: str):
        with open(path, "w") as f:
            json.dump({"address": hex(self.address)}, f)

    @staticmethod
    def load_instance(chain: vm.Chain, path: str) -> "DummyAppContract":
        with open(path) as f:
            return DummyAppContract(
                chain, int(json.load(f)["address"], 16)
            )

    def get(self, scalar: int) -> int:
        ret, _ = self.chain.call(
            self.address, contracts_asm.encode_get(scalar)
        )
        return int.from_bytes(ret, "big")
