# Copied from zecale_tpu/api/grpc_server.py (JAX-free); unchanged but for this line.
"""gRPC transport for the aggregator service.

Service and method names are identical to the reference's
``zecale_proto.Aggregator`` (proto/zecale/api/aggregator.proto:9-41).  Two
transports are served simultaneously:

  * ``zecale_proto.Aggregator`` — real proto3 wire format, hand-encoded
    per proto/zecale/api/aggregator.proto (serialization/protowire.py);
    grpcio's generic-handler API registers it without generated stubs
    (grpcio-tools is not in the image).
  * ``zecale_proto.AggregatorJson`` — the canonical-JSON fallback transport
    carrying the same fields (proto/README.md).

Error mapping mirrors the reference (aggregator_server.cpp:267-275):
ServiceError -> INVALID_ARGUMENT, everything else -> UNKNOWN.
"""

from __future__ import annotations

import json
import logging
from concurrent import futures
from typing import Optional

import grpc

from ..serialization import protowire as pw
from .service import AggregatorService, ServiceError

log = logging.getLogger("zecale.grpc")

SERVICE_NAME = "zecale_proto.Aggregator"
JSON_SERVICE_NAME = "zecale_proto.AggregatorJson"


def _json_serializer(obj) -> bytes:
    return json.dumps(obj).encode("utf-8")


def _json_deserializer(data: bytes):
    if not data:
        return None
    return json.loads(data.decode("utf-8"))


def _ident(x):
    return x


#: method -> (request schema, request converter wire->service dict,
#:            response schema, response converter service dict->wire)
METHOD_CODECS = {
    "GetConfiguration": (pw.EMPTY, _ident, pw.AGGREGATOR_CONFIGURATION,
                         pw.config_to_proto),
    "GetVerificationKey": (pw.EMPTY, _ident, pw.VERIFICATION_KEY,
                           pw.vk_to_proto),
    "GetNestedVerificationKeyHash": (
        pw.VERIFICATION_KEY, pw.vk_from_proto,
        pw.VERIFICATION_KEY_HASH, _ident,
    ),
    "RegisterApplication": (
        pw.APPLICATION_DESCRIPTION,
        lambda m: {
            "application_name": m["application_name"],
            "vk": pw.vk_from_proto(m["vk"]),
        },
        pw.VERIFICATION_KEY_HASH, _ident,
    ),
    "SubmitNestedTransaction": (
        pw.NESTED_TRANSACTION, pw.nested_tx_from_proto, pw.EMPTY, _ident,
    ),
    "GenerateAggregatedTransaction": (
        pw.AGGREGATED_TRANSACTION_REQUEST, _ident,
        pw.AGGREGATED_TRANSACTION, pw.agg_tx_to_proto,
    ),
}


class _Handler(grpc.GenericRpcHandler):
    def __init__(self, service: AggregatorService):
        self.svc = service
        self._methods = {
            "GetConfiguration": self._get_configuration,
            "GetVerificationKey": self._get_vk,
            "GetNestedVerificationKeyHash": self._get_nested_vk_hash,
            "RegisterApplication": self._register,
            "SubmitNestedTransaction": self._submit,
            "GenerateAggregatedTransaction": self._aggregate,
        }

    def service(self, handler_call_details):
        path = handler_call_details.method
        try:
            _, svc_name, method = path.split("/")
        except ValueError:
            return None
        fn = self._methods.get(method)
        if fn is None or svc_name not in (SERVICE_NAME, JSON_SERVICE_NAME):
            return None

        proto_wire = svc_name == SERVICE_NAME
        req_schema, req_conv, resp_schema, resp_conv = METHOD_CODECS[method]

        def unary_unary(request, context):
            try:
                return fn(request)
            except ServiceError as e:
                context.abort(grpc.StatusCode.INVALID_ARGUMENT, str(e))
            except Exception as e:  # -> UNKNOWN, like the reference
                log.exception("internal error")
                context.abort(grpc.StatusCode.UNKNOWN, str(e))

        if proto_wire:
            deser = lambda data: req_conv(pw.decode(req_schema, data or b""))
            ser = lambda obj: pw.encode(resp_schema, resp_conv(obj))
        else:
            deser = _json_deserializer
            ser = _json_serializer
        return grpc.unary_unary_rpc_method_handler(
            unary_unary, request_deserializer=deser, response_serializer=ser
        )

    # -- method bodies (service-dict in / service-dict out) ------------------
    def _get_configuration(self, _request):
        return self.svc.get_configuration()

    def _get_vk(self, _request):
        return self.svc.get_verification_key()

    def _get_nested_vk_hash(self, request):
        return {"hash": self.svc.get_nested_verification_key_hash(request)}

    def _register(self, request):
        h = self.svc.register_application(
            request["application_name"], request["vk"]
        )
        return {"hash": h}

    def _submit(self, request):
        self.svc.submit_nested_transaction(request)
        return {}

    def _aggregate(self, request):
        return self.svc.generate_aggregated_transaction(
            request["application_name"]
        )


def serve(
    service: AggregatorService,
    bind: str = "0.0.0.0:50052",
    max_workers: int = 1,
    block: bool = True,
):
    """Start the server.  Default bind/port matches the reference
    (aggregator_server.cpp:393-416, insecure 0.0.0.0:50052); max_workers=1
    mirrors its synchronous single-threaded service loop."""
    server = grpc.server(futures.ThreadPoolExecutor(max_workers=max_workers))
    server.add_generic_rpc_handlers((_Handler(service),))
    server.add_insecure_port(bind)
    server.start()
    log.info("aggregator server listening on %s", bind)
    if block:
        server.wait_for_termination()
    return server
