"""The user's side of the port, zecale_tpu_torch/client/ and
zecale_tpu_torch/test_client.py, against the JAX package's: the
test-client round trip (register, a duplicate refused, 4 submissions, 2
batches in fee order settled through the dispatcher engine, a third
refused) over a real gRPC socket, the port's AggregatorClient against the
port's server on the proto and the JSON transports; the aggregated
transactions it answers equal, as JSON, those of the JAX package's client
and server for the same seeded submissions; the Zeth bridge equal to the
JAX package's.  The server proves with the reference's witness-level
stub; on the card (``cuda``) the round trip runs with --real-prover, so
that Groth16Torch proves and the dispatcher's real verifier settles.
Tolerance: exact."""

import importlib.util
import json
import os
import random

import pytest
import torch

from zecale_tpu_torch import test_client as tc
from zecale_tpu_torch.api.service import AggregatorService
from zecale_tpu_torch.client import zeth_bridge as zb

# The JAX package is imported only inside the tests that compare with it,
# so that the card's test runs without it.

# One intra-op thread: the suite runs in several worker processes at
# once, and torch's OpenMP threads spinning in each of them slow every
# worker many times over.
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _stub_service():
    return AggregatorService(tc.WitnessLevelCircuit(1, 2), tc.StubKeypair(),
                             nested_curve="bls12-377",
                             wrapper_curve="bw6-761")


def _served(svc, serve, client_cls, transport="proto"):
    """round_trip on ``svc`` served by ``serve`` on a free port, driven by
    ``client_cls``, with the stub's accepting verifier."""
    bind = f"127.0.0.1:{tc.free_port()}"
    server = serve(svc, bind=bind, block=False)
    try:
        return tc.round_trip(client_cls(bind, transport=transport), 2,
                             tc.AcceptingVerifier(), log=lambda m: None)
    finally:
        server.stop(None)


@pytest.mark.parametrize("transport", ["proto", "json"])
def test_round_trip_over_a_grpc_socket(transport):
    pytest.importorskip("grpc")
    from zecale_tpu_torch.api import grpc_server
    from zecale_tpu_torch.client.aggregator_client import AggregatorClient

    out = _served(_stub_service(), grpc_server.serve, AggregatorClient,
                  transport)
    assert [b["nested_parameters"] for b in out["batches"]] == [
        [tc.app_parameters(i).hex() for i in (0, 1)],
        [tc.app_parameters(i).hex() for i in (2, 3)]]
    assert set(out["seconds"]) >= {"register_application", "submit a=7",
                                   "get_aggregated_transaction 1",
                                   "settle 1"}


class _Status:
    def __init__(self, name):
        self.name = name


class _RpcError(Exception):
    """A gRPC error as the client raises it: its status and message."""

    def __init__(self, status, details):
        super().__init__(details)
        self._status, self._details = _Status(status), details

    def code(self):
        return self._status

    def details(self):
        return self._details


def _raise(e):
    raise e


def test_refused_request_is_required():
    """Only the service's own refusal, INVALID_ARGUMENT with the expected
    reason, counts; a transport failure, a crashed handler, another
    reason, an error that is not gRPC's and a success all fail."""
    why = "application 'dummy' already registered"
    assert tc._refused(lambda: _raise(_RpcError("INVALID_ARGUMENT", why)),
                       "already registered") == f"INVALID_ARGUMENT: {why}"
    for e in (_RpcError("UNAVAILABLE", "Socket closed"),
              _RpcError("UNKNOWN", "already registered"),
              _RpcError("INVALID_ARGUMENT", "vk shape does not match"),
              ZeroDivisionError("division by zero")):
        with pytest.raises(type(e)):
            tc._refused(lambda: _raise(e), "already registered")
    with pytest.raises(AssertionError, match="not refused"):
        tc._refused(lambda: None, "already registered")


def test_aggregated_transactions_equal_the_jax_packages():
    """The port's client and server against the JAX package's client and
    server (with the reference's scripts/test_client.py stub circuit), on
    the same seeded submissions: the answered batches equal as JSON."""
    pytest.importorskip("grpc")
    from zecale_tpu.api import grpc_server as ref_grpc
    from zecale_tpu.api.service import AggregatorService as RefService
    from zecale_tpu.client.aggregator_client import (
        AggregatorClient as RefClient)
    from zecale_tpu_torch.api import grpc_server
    from zecale_tpu_torch.client.aggregator_client import AggregatorClient

    spec = importlib.util.spec_from_file_location(
        "reference_test_client", os.path.join(REPO, "scripts",
                                              "test_client.py"))
    ref_tc = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref_tc)
    ref_svc = RefService(ref_tc.WitnessLevelCircuit(1, 2),
                         ref_tc.StubKeypair(), nested_curve="bls12-377",
                         wrapper_curve="bw6-761")

    got = _served(_stub_service(), grpc_server.serve, AggregatorClient)
    want = _served(ref_svc, ref_grpc.serve, RefClient)
    assert got["vk_hash"] == want["vk_hash"]
    assert json.dumps(got["batches"]) == json.dumps(want["batches"])


def test_main_prints_the_round_trip_passed(capsys):
    pytest.importorskip("grpc")
    assert tc.main([]) == 0
    assert "TEST-CLIENT ROUND TRIP PASSED" in capsys.readouterr().out


@pytest.mark.parametrize("shape", ["structured", "hex"])
def test_create_nested_tx_equals_the_jax_packages(shape):
    from zecale_tpu.client import zeth_bridge as ref_zb

    rng = random.Random(4)
    ep = {"proof": {"a": ["0x1", "0x2"], "b": [["0x3", "0x4"],
                                              ["0x5", "0x6"]],
                    "c": ["0x7", "0x8"]}, "inputs": ["0x9"]}
    params = ({"note": [rng.getrandbits(64), "x"], "a": {"b": 1}}
              if shape == "structured" else rng.randbytes(40).hex())
    bundle = {"extended_proof": ep, "parameters": params}
    got = zb.create_nested_tx(bundle, "app", fee_in_wei=12)
    assert got == ref_zb.create_nested_tx(bundle, "app", fee_in_wei=12)
    assert json.dumps(got) == json.dumps(
        ref_zb.create_nested_tx(bundle, "app", fee_in_wei=12))

    mp = zb.MixParameters(ep, [rng.getrandbits(256) for _ in range(4)],
                          rng.getrandbits(256),
                          [rng.randbytes(n) for n in (49, 96, 1)])
    ref_mp = ref_zb.MixParameters.from_json_dict(mp.to_json_dict())
    assert (zb.create_zeth_nested_tx(mp, 3, "zeth")
            == ref_zb.create_zeth_nested_tx(ref_mp, 3, "zeth"))


@pytest.mark.cuda
def test_real_prover_round_trip_on_the_card(tmp_path, capsys):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    pytest.importorskip("grpc")
    assert tc.main(["--real-prover", "--keypair",
                    str(tmp_path / "kp.bin")]) == 0
    assert "TEST-CLIENT ROUND TRIP PASSED" in capsys.readouterr().out
