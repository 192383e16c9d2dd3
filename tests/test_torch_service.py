"""The port's served layer (zecale_tpu_torch: aggregator/pool.py,
api/service.py, api/grpc_server.py, serialization/json_codec.py and
serialization/protowire.py) against the JAX package's on the same seeded
inputs: the pool's order, the service's JSON answers, the codecs' JSON and
bytes, and a gRPC round trip in which the JAX package's client drives the
port's server.  The circuit is the reference tests' FakeCircuit
(tests/test_service.py:25-44), so nothing is proved.  Tolerance: exact."""

import json
import random
import socket

import pytest
import torch

from zecale_tpu.aggregator import dummy_app as da_ref
from zecale_tpu.aggregator import pool as pool_ref
from zecale_tpu.api import service as service_ref
from zecale_tpu.serialization import json_codec as jc_ref
from zecale_tpu.serialization import protowire as pw_ref
from zecale_tpu.snark import groth16 as g16_ref
from zecale_tpu_torch.aggregator import dummy_app as da
from zecale_tpu_torch.aggregator import pool
from zecale_tpu_torch.api import service
from zecale_tpu_torch.serialization import json_codec as jc
from zecale_tpu_torch.serialization import protowire as pw
from zecale_tpu_torch.snark import groth16 as g16

# One intra-op thread: the suite runs in several worker processes at
# once, and torch's OpenMP threads spinning in each of them slow every
# worker many times over.
torch.set_num_threads(1)

#: (package's dummy_app, pool, service, json_codec, groth16) of each side
SIDES = {"ref": (da_ref, pool_ref, service_ref, jc_ref, g16_ref),
         "port": (da, pool, service, jc, g16)}


class FakeCircuit:
    """The reference tests' FakeCircuit: 'proves' by concatenation."""

    num_proofs = 2
    num_inputs = 1

    def __init__(self, g16_mod):
        self.g16 = g16_mod

    def compute_nested_vk_hash(self, vk):
        return sum(p[0] for p in vk.abc) % 997

    def prove(self, vk, nested_proofs, wpk, prover=None):
        inputs = [self.compute_nested_vk_hash(vk),
                  (1 << self.num_proofs) - 1]
        for ep in nested_proofs:
            inputs.extend(ep.inputs)
        return self.g16.ExtendedProof(proof=nested_proofs[0].proof,
                                      inputs=inputs)


def _service(side):
    """A FakeCircuit service of one side, its nested keypair and rng; the
    wrapper keypair is a BW6-761 dummy-app keypair, so that
    get_verification_key has a vk to encode."""
    da_mod, _, svc_mod, _, g16_mod = SIDES[side]
    _, wkp = da_mod.dummy_app_setup("bw6-761", random.Random(5))
    rng = random.Random(1)
    _, nkp = da_mod.dummy_app_setup("bls12-377", rng)
    svc = svc_mod.AggregatorService(FakeCircuit(g16_mod), wkp,
                                    nested_curve="bls12-377",
                                    wrapper_curve="bw6-761")
    return svc, nkp, rng


def _tx_json(side, nkp, a, fee, rng):
    da_mod, _, _, jc_mod, _ = SIDES[side]
    ep = da_mod.dummy_app_prove("bls12-377", nkp, a, rng)
    return {
        "app_name": "app",
        "extended_proof": jc_mod.extended_proof_to_json("bls12-377", ep),
        "parameters": f"{a:02x}",
        "fee_in_wei": fee,
    }


def _flow(side):
    """Every answer of the register / submit / aggregate flow, with the
    error class name where a request is refused."""
    _, _, svc_mod, jc_mod, _ = SIDES[side]
    svc, nkp, rng = _service(side)
    vk_json = jc_mod.groth16_vk_to_json("bls12-377", nkp.vk)
    out = []

    def ask(fn, *args):
        try:
            out.append(fn(*args))
        except svc_mod.ServiceError as e:
            out.append(("ServiceError", str(e)))

    ask(svc.get_configuration)
    ask(svc.get_verification_key)
    ask(svc.register_application, "app", vk_json)
    ask(svc.register_application, "app", vk_json)  # duplicate
    ask(svc.get_nested_verification_key_hash, vk_json)
    ask(svc.submit_nested_transaction,
        {**_tx_json(side, nkp, 9, 1, rng), "app_name": "nope"})
    bad = _tx_json(side, nkp, 6, 1, rng)
    bad["extended_proof"]["proof"]["a"][0] = "0x" + "11" * 48
    ask(svc.submit_nested_transaction, bad)  # not on the curve
    for a, fee in ((7, 10), (8, 5), (10, 20)):
        ask(svc.submit_nested_transaction, _tx_json(side, nkp, a, fee, rng))
    ask(svc.generate_aggregated_transaction, "app")
    ask(svc.generate_aggregated_transaction, "app")  # one left: refused
    ask(svc.generate_aggregated_transaction, "nope")
    return out


def test_pool_fee_priority_and_whole_batches_match_reference():
    def run(mod):
        p = mod.ApplicationPool("app", vk=None, batch_size=2)
        for fee, tag in [(5, "a"), (9, "b"), (1, "c"), (9, "d")]:
            p.add_tx(mod.NestedTransaction("app", extended_proof=tag,
                                           fee_in_wei=fee))
        got = []
        while True:
            batch = p.get_next_batch()
            got.append(None if batch is None
                       else [tx.extended_proof for tx in batch])
            if batch is None:
                return got, p.size

    want = run(pool_ref)
    assert want == ([["b", "d"], ["a", "c"], None], 0)
    assert run(pool) == want


def test_service_flow_answers_match_reference():
    want = _flow("ref")
    got = _flow("port")
    assert json.dumps(got) == json.dumps(want)
    # fee order: the two highest fees (a = 10, then 7) form the batch
    agg = got[10]
    assert agg["nested_parameters"] == ["0a", "07"]
    assert [int(v, 16) for v in agg["ext_proof"]["inputs"][2:]] == [10, 7]
    assert got[11][0] == got[12][0] == "ServiceError"


def _objects(side):
    """Seeded dummy-app proofs and vks of both curves, and a nested and an
    aggregated transaction in JSON, as one side makes them."""
    da_mod, _, _, jc_mod, _ = SIDES[side]
    _, nkp = da_mod.dummy_app_setup("bls12-377", random.Random(3))
    _, wkp = da_mod.dummy_app_setup("bw6-761", random.Random(4))
    nep = da_mod.dummy_app_prove("bls12-377", nkp, 7, random.Random(5))
    wep = da_mod.dummy_app_prove("bw6-761", wkp, 9, random.Random(6))
    return {
        "nested_vk": jc_mod.groth16_vk_to_json("bls12-377", nkp.vk),
        "wrapper_vk": jc_mod.groth16_vk_to_json("bw6-761", wkp.vk),
        "nested_proof": jc_mod.groth16_proof_to_json("bls12-377", nep.proof),
        "nested_tx": {
            "app_name": "app", "parameters": "c0ffee", "fee_in_wei": 12,
            "extended_proof": jc_mod.extended_proof_to_json("bls12-377",
                                                            nep)},
        "agg_tx": {
            "app_name": "app", "nested_parameters": ["00", "ff"],
            "ext_proof": jc_mod.extended_proof_to_json("bw6-761", wep)},
        "wrapper_ext_proof": wep,
    }


def test_json_codec_matches_reference():
    want, got = _objects("ref"), _objects("port")
    keys = ("nested_vk", "wrapper_vk", "nested_proof", "nested_tx", "agg_tx")
    assert {k: got[k] for k in keys} == {k: want[k] for k in keys}
    # decode: the port's objects hold the reference's values
    for curve, name in (("bls12-377", "nested_vk"), ("bw6-761", "wrapper_vk")):
        vk = jc.groth16_vk_from_json(curve, want[name])
        vk_ref = jc_ref.groth16_vk_from_json(curve, want[name])
        assert (vk.alpha, vk.beta, vk.delta, vk.abc) == (
            vk_ref.alpha, vk_ref.beta, vk_ref.delta, vk_ref.abc)
    ep = jc.extended_proof_from_json("bw6-761", want["agg_tx"]["ext_proof"])
    wep = want["wrapper_ext_proof"]
    assert (ep.proof.a, ep.proof.b, ep.proof.c, ep.inputs) == (
        wep.proof.a, wep.proof.b, wep.proof.c, wep.inputs)
    cfg_ref = _service("ref")[0].get_configuration()
    assert _service("port")[0].get_configuration() == cfg_ref


@pytest.mark.parametrize("curve", ["bls12-377", "bw6-761"])
def test_pghr13_json_codec_matches_reference(curve):
    _, kp = da.dummy_app_setup(curve, random.Random(4), snark="PGHR13")
    ep = da.dummy_app_prove(curve, kp, 5, random.Random(5), snark="PGHR13")
    vk_json = jc.pghr13_vk_to_json(curve, kp.vk)
    ep_json = jc.extended_proof_to_json(curve, ep, "PGHR13")
    assert vk_json == jc_ref.pghr13_vk_to_json(curve, kp.vk)
    assert ep_json == jc_ref.extended_proof_to_json(curve, ep, "PGHR13")
    assert jc.snark_codec("PGHR13")[2](curve, kp.vk) == vk_json
    # decode: the port's objects hold the reference's values
    vk_ref = jc_ref.pghr13_vk_from_json(curve, vk_json)
    assert jc.pghr13_vk_from_json(curve, vk_json).__dict__ == \
        vk_ref.__dict__ == kp.vk.__dict__
    got = jc.extended_proof_from_json(curve, ep_json, "PGHR13")
    want = jc_ref.extended_proof_from_json(curve, ep_json, "PGHR13")
    assert got.proof.__dict__ == want.proof.__dict__ == ep.proof.__dict__
    assert got.inputs == want.inputs == [5]


def test_pghr13_ext_proof_keeps_its_points_through_the_wire():
    curve = "bw6-761"
    _, kp = da.dummy_app_setup(curve, random.Random(4), snark="PGHR13")
    ep = da.dummy_app_prove(curve, kp, 5, random.Random(5), snark="PGHR13")
    agg = {"app_name": "app", "nested_parameters": ["05"],
           "ext_proof": jc.extended_proof_to_json(curve, ep, "PGHR13")}
    wire = pw.encode(pw.AGGREGATED_TRANSACTION, pw.agg_tx_to_proto(agg))
    back = pw.agg_tx_from_proto(pw.decode(pw.AGGREGATED_TRANSACTION, wire))
    assert back == agg
    got = jc.extended_proof_from_json(curve, back["ext_proof"], "PGHR13")
    assert got.proof.__dict__ == ep.proof.__dict__
    # the JAX package sends it as a Groth16 proof: a_p, b_p, c_p, h and k
    # are lost on the wire
    wire = pw_ref.encode(pw_ref.AGGREGATED_TRANSACTION,
                         pw_ref.agg_tx_to_proto(agg))
    lost = pw_ref.agg_tx_from_proto(
        pw_ref.decode(pw_ref.AGGREGATED_TRANSACTION, wire))
    assert sorted(lost["ext_proof"]["proof"]) == ["a", "b", "c"]


@pytest.mark.parametrize("message", ["vk", "config", "nested_tx", "agg_tx"])
def test_protowire_bytes_match_reference(message):
    objs = _objects("ref")
    schema, to_proto, from_proto, value = {
        "vk": ("VERIFICATION_KEY", "vk_to_proto", "vk_from_proto",
               objs["nested_vk"]),
        "config": ("AGGREGATOR_CONFIGURATION", "config_to_proto",
                   "config_from_proto",
                   _service("ref")[0].get_configuration()),
        "nested_tx": ("NESTED_TRANSACTION", "nested_tx_to_proto",
                      "nested_tx_from_proto", objs["nested_tx"]),
        "agg_tx": ("AGGREGATED_TRANSACTION", "agg_tx_to_proto",
                   "agg_tx_from_proto", objs["agg_tx"]),
    }[message]
    want = pw_ref.encode(getattr(pw_ref, schema),
                         getattr(pw_ref, to_proto)(value))
    got = pw.encode(getattr(pw, schema), getattr(pw, to_proto)(value))
    assert got == want
    decoded = getattr(pw, from_proto)(pw.decode(getattr(pw, schema), got))
    assert decoded == getattr(pw_ref, from_proto)(
        pw_ref.decode(getattr(pw_ref, schema), want))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("transport", ["proto", "json"])
def test_grpc_round_trip_reference_client_port_server(transport):
    grpc = pytest.importorskip("grpc")
    from zecale_tpu.client.aggregator_client import AggregatorClient
    from zecale_tpu_torch.api import grpc_server

    svc, nkp, rng = _service("port")
    bind = f"127.0.0.1:{_free_port()}"
    server = grpc_server.serve(svc, bind=bind, block=False)
    try:
        cli = AggregatorClient(bind, transport=transport)
        cfg = cli.get_configuration()
        assert cfg["nested_pairing_parameters"]["name"] == "bls12-377"
        assert cfg["wrapper_pairing_parameters"]["name"] == "bw6-761"
        assert cli.get_verification_key() == svc.get_verification_key()

        vk_json = jc.groth16_vk_to_json("bls12-377", nkp.vk)
        h1 = cli.register_application("app", vk_json)
        assert cli.get_nested_verification_key_hash(vk_json) == h1
        cli.submit_nested_transaction(_tx_json("port", nkp, 7, 3, rng))
        cli.submit_nested_transaction(_tx_json("port", nkp, 8, 4, rng))
        agg = cli.get_aggregated_transaction("app")
        assert agg["app_name"] == "app"
        assert agg["nested_parameters"] == ["08", "07"]
        with pytest.raises(grpc.RpcError) as e:
            cli.get_aggregated_transaction("app")
        assert e.value.code() == grpc.StatusCode.INVALID_ARGUMENT
    finally:
        server.stop(None)
