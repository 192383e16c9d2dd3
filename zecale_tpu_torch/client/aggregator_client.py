# Copied from zecale_tpu/client/aggregator_client.py (JAX-free); unchanged but for this line.
"""Python client for the aggregator service (reference analog:
client/zecale/core/aggregator_client.py — one method per RPC).

Default transport is the proto3 wire format of
proto/zecale/api/aggregator.proto (hand-encoded,
serialization/protowire.py); pass ``transport="json"`` for the
canonical-JSON fallback service.
"""

from __future__ import annotations

import json
from typing import List, Optional

import grpc

from ..api.grpc_server import (
    JSON_SERVICE_NAME,
    METHOD_CODECS,
    SERVICE_NAME,
    _json_deserializer,
    _json_serializer,
)
from ..serialization import json_codec as jc
from ..serialization import protowire as pw
from ..snark.groth16 import ExtendedProof, Groth16VerificationKey

#: client-side wire converters: (service-dict -> request wire dict,
#:                               response wire dict -> service dict)
_CLIENT_CONV = {
    "GetConfiguration": (lambda d: {}, pw.config_from_proto),
    "GetVerificationKey": (lambda d: {}, pw.vk_from_proto),
    "GetNestedVerificationKeyHash": (pw.vk_to_proto, lambda m: m),
    "RegisterApplication": (
        lambda d: {
            "application_name": d["application_name"],
            "vk": pw.vk_to_proto(d["vk"]),
        },
        lambda m: m,
    ),
    "SubmitNestedTransaction": (pw.nested_tx_to_proto, lambda m: {}),
    "GenerateAggregatedTransaction": (lambda d: d, pw.agg_tx_from_proto),
}


class AggregatorClient:
    def __init__(self, endpoint: str = "localhost:50052",
                 transport: str = "proto"):
        assert transport in ("proto", "json")
        self.transport = transport
        self.channel = grpc.insecure_channel(endpoint)

    def _call(self, method: str, request):
        if self.transport == "json":
            callable_ = self.channel.unary_unary(
                f"/{JSON_SERVICE_NAME}/{method}",
                request_serializer=_json_serializer,
                response_deserializer=_json_deserializer,
            )
            return callable_(request)
        req_schema, _, resp_schema, _ = METHOD_CODECS[method]
        to_wire, from_wire = _CLIENT_CONV[method]
        callable_ = self.channel.unary_unary(
            f"/{SERVICE_NAME}/{method}",
            request_serializer=lambda d: pw.encode(req_schema, to_wire(d)),
            response_deserializer=lambda b: from_wire(
                pw.decode(resp_schema, b or b"")
            ),
        )
        return callable_(request)

    # -- RPCs ----------------------------------------------------------------
    def get_configuration(self) -> dict:
        return self._call("GetConfiguration", {})

    def get_verification_key(self) -> dict:
        return self._call("GetVerificationKey", {})

    def get_nested_verification_key_hash(self, vk_json: dict) -> str:
        return self._call("GetNestedVerificationKeyHash", vk_json)["hash"]

    def register_application(self, name: str, vk_json: dict) -> str:
        return self._call(
            "RegisterApplication", {"application_name": name, "vk": vk_json}
        )["hash"]

    def submit_nested_transaction(self, tx_json: dict) -> None:
        self._call("SubmitNestedTransaction", tx_json)

    def get_aggregated_transaction(self, name: str) -> dict:
        return self._call(
            "GenerateAggregatedTransaction", {"application_name": name}
        )
