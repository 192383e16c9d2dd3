# Ported from scripts/test_client.py: the same users, requests and checks, with the protocol in round_trip, a free port, and the --real-prover its docstring names.
"""Multi-user client round trip against a live aggregator server.

Python analog of the reference's scripts/test-client (:26-97): three
simulated users -- an aggregator operator, an application deployer and an
end user -- drive the full protocol over a real gRPC socket:

  deploy (dispatcher engine) -> register (+ duplicate rejection) ->
  submit 4 proofs -> pull 2 batches in fee order -> settle each through
  the dispatcher engine -> assert application state -> assert a 3rd
  batch is unavailable.

``round_trip`` is the protocol, on any client with ``AggregatorClient``'s
methods; ``main`` serves on a free local port and drives it with the
port's ``AggregatorClient``.

Without flags the server proves with the witness-level stub (the
reference's ``WitnessLevelCircuit``) and the dispatcher settles with a
verifier that accepts.  With ``--real-prover`` the server is built by
``api/server_main.build_service`` with ``--prover torch`` on ``--device``
(cuda unless the CPU is asked for), so ``Groth16Torch`` proves every
batch, and each batch is settled by the dispatcher's real verifier under
the wrapper vk the server answers.  Its keypair is loaded from
``--keypair``, or made by the device setup and written there.

Each nested transaction's parameters are the dummy application's
``abi.encode(uint256[])`` of 0xaa00 + i, so an answered batch also
settles unchanged as bytecode (``client/cli.py submit-batch``).

Usage: python -m zecale_tpu_torch.test_client [--batch 2] [--real-prover]
    [--device cuda|cpu] [--keypair PATH]
Ends with ``TEST-CLIENT ROUND TRIP PASSED``.
"""

import argparse
import json
import os
import random
import socket
import sys
import tempfile
import time

from .aggregator import dummy_app as da
from .contracts import dispatcher as dp
from .evm import contracts_asm
from .serialization import json_codec as jc
from .snark.groth16 import ExtendedProof


class WitnessLevelCircuit:
    """AggregatorCircuit stand-in that derives the primary inputs from the
    real witness logic but skips the wrapping proof."""

    def __init__(self, num_inputs, num_proofs):
        self.num_inputs = num_inputs
        self.num_proofs = num_proofs

    def compute_nested_vk_hash(self, vk):
        from .ff import params as P
        from .gadgets import vk_hash as vkh

        return vkh.compute_vk_hash("bls12-377", vk, P.BW6_761_R)

    def prove(self, vk, nested_proofs, wpk, prover=None):
        from .snark.groth16 import Groth16

        nested = Groth16("bls12-377")
        results = 0
        inputs = [self.compute_nested_vk_hash(vk)]
        for i, ep in enumerate(nested_proofs):
            if nested.verify(ep.inputs, ep.proof, vk):
                results |= 1 << i
        inputs.append(results)
        for ep in nested_proofs:
            inputs.extend(ep.inputs)
        # witness-level stub proof: --real-prover settles real ones
        return ExtendedProof(proof=nested_proofs[0].proof, inputs=inputs)


class StubKeypair:
    pk = None
    vk = None


class AcceptingVerifier:
    """The dispatcher's verifier for the stub's witness-level proofs."""

    def verify(self, *args):
        return True


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def app_parameters(i: int) -> bytes:
    """The i-th submission's parameters: what the dummy application's
    bytecode records for its scalar."""
    return contracts_asm.encode_app_parameters(0xAA00 + i)


def _refused(call, reason: str) -> str:
    """The service's refusal of ``call()``: a gRPC error with status
    INVALID_ARGUMENT (the server's answer to the service's own error) whose
    message holds ``reason``.  Any other error -- a server that died
    (UNAVAILABLE), a handler that crashed (UNKNOWN) -- is raised again, and
    a call that succeeds raises.  -> "STATUS: message"."""
    try:
        call()
    except Exception as e:
        code = getattr(e, "code", None)
        status = code().name if callable(code) else None
        if status != "INVALID_ARGUMENT" or reason not in e.details():
            raise
        return f"{status}: {e.details()}"
    raise AssertionError("the request was not refused")


def round_trip(client, batch: int = 2, settle_verifier=None,
               log=print) -> dict:
    """The protocol of the reference's test-client on ``client``: register
    the nested dummy-app vk (a duplicate refused), submit 2 * batch proofs
    of a = 7, 8, ... at falling fees, pull two batches, which must hold the
    scalars in fee order, settle each through the dispatcher engine, check
    the application state, and check that a third batch is refused.
    ``settle_verifier`` None settles with the dispatcher's real verifier
    under the vk the server answers; else with that verifier and zero
    words, as the reference's stub does.  -> {"vk_hash", "batches" (the
    answered aggregated transactions), "seconds" (of each request and
    settlement)}."""
    seconds = {}

    def timed(name, fn, *args):
        t = time.time()
        out = fn(*args)
        seconds[name] = round(time.time() - t, 3)
        return out

    rng = random.Random(9)
    # --- deployer: nested app setup + registration ----------------------
    _, nkp = da.dummy_app_setup("bls12-377", rng)
    vk_json = jc.groth16_vk_to_json("bls12-377", nkp.vk)
    vk_hash = timed("register_application", client.register_application,
                    "dummy", vk_json)
    log(f"[deployer] registered, vk hash {vk_hash[:18]}...")
    why = _refused(lambda: client.register_application("dummy", vk_json),
                   "already registered")
    log(f"[deployer] duplicate rejected ({why})")

    # --- user: submit 2 * batch proofs at falling fees -------------------
    scalars = [7 + i for i in range(2 * batch)]
    for i, a in enumerate(scalars):
        ep = da.dummy_app_prove("bls12-377", nkp, a, rng)
        timed(f"submit a={a}", client.submit_nested_transaction, {
            "app_name": "dummy",
            "extended_proof": jc.extended_proof_to_json("bls12-377", ep),
            "parameters": app_parameters(i).hex(),
            "fee_in_wei": len(scalars) + 6 - i,
        })
    log(f"[user1] submitted {len(scalars)} nested transactions")

    # --- user: pull two batches, settle each -----------------------------
    if settle_verifier is None:
        vk = jc.groth16_vk_from_json(
            "bw6-761", timed("get_verification_key",
                             client.get_verification_key))
        vk_words = dp.vk_to_contract_parameters(vk)
    else:
        vk_words = [0] * (dp.POINT_WORDS * (3 + 3 + batch))
    eng = dp.DispatcherEngine(vk_words, batch)
    if settle_verifier is not None:
        eng.verifier = settle_verifier
    app = dp.DummyApplicationEngine(eng, expected_vk_hash=int(vk_hash, 16))
    batches = []
    for b in range(2):
        agg = timed(f"get_aggregated_transaction {b}",
                    client.get_aggregated_transaction, "dummy")
        ep = jc.extended_proof_from_json("bw6-761", agg["ext_proof"])
        assert ep.inputs[0] == int(vk_hash, 16), "vk hash input"
        assert ep.inputs[1] == (1 << batch) - 1, "results bits"
        # fee order: the highest fees first -> 7, 8 then 9, 10
        want = scalars[b * batch:(b + 1) * batch]
        assert list(ep.inputs[2:]) == want, (ep.inputs[2:], want)
        proof_words = (dp.proof_to_contract_parameters(ep.proof)
                       if settle_verifier is None else [0] * dp.PROOF_WORDS)
        ok = timed(f"settle {b}", eng.process_batch, proof_words,
                   dp.inputs_to_contract_parameters(ep.inputs),
                   [bytes.fromhex(p) for p in agg["nested_parameters"]], app)
        assert ok, f"batch {b} refused by the dispatcher"
        batches.append(agg)
        log(f"[user1] batch {b} settled; scalars {ep.inputs[2:]}")

    for i, s in enumerate(scalars):
        assert app.get(s) == app_parameters(i), f"scalar {s} not dispatched"
    log("[user1] application state verified")

    # --- third batch must be unavailable ---------------------------------
    why = _refused(lambda: client.get_aggregated_transaction("dummy"),
                   "insufficient transactions")
    log(f"[user1] third batch unavailable ({why})")
    return {"vk_hash": vk_hash, "batches": batches, "seconds": seconds}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--real-prover", action="store_true",
                    help="prove with Groth16Torch on --device and settle "
                         "with the dispatcher's real verifier")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--keypair", default=None,
                    help="wrapper keypair (--real-prover); default: in the "
                         "temporary directory, keyed by the batch size")
    args = ap.parse_args(argv)

    from .api import grpc_server
    from .client.aggregator_client import AggregatorClient

    # --- operator: start the server --------------------------------------
    if args.real_prover:
        from .api import server_main

        keypair = args.keypair or os.path.join(
            tempfile.gettempdir(), "zecale_tpu_torch_cache",
            f"test_client_b{args.batch}_keypair.bin")
        svc, _ = server_main.build_service([
            "--batch-size", str(args.batch), "--prover", "torch",
            "--device", args.device, "--keypair", keypair])
        verifier = None
    else:
        from .api.service import AggregatorService

        svc = AggregatorService(
            WitnessLevelCircuit(1, args.batch),
            StubKeypair(),
            nested_curve="bls12-377",
            wrapper_curve="bw6-761",
        )
        verifier = AcceptingVerifier()
    bind = f"127.0.0.1:{free_port()}"
    server = grpc_server.serve(svc, bind=bind, block=False)
    print(f"[operator] server up on {bind}")
    try:
        out = round_trip(AggregatorClient(bind), args.batch, verifier)
        work = tempfile.mkdtemp(prefix="zecale-test-client-")
        for b, agg in enumerate(out["batches"]):
            with open(os.path.join(work, f"batch-{b}.json"), "w") as f:
                json.dump(agg, f)
        print(f"[user1] answered batches written under {work}")
        print(f"seconds: {json.dumps(out['seconds'])}")
        print("TEST-CLIENT ROUND TRIP PASSED")
        return 0
    finally:
        server.stop(None)


if __name__ == "__main__":
    sys.exit(main())
