"""The served aggregator: the port's ``AggregatorService`` as
``api/server_main.build_service`` builds it from the configuration's
server flags, driven in process by the calls ``api/grpc_server.py``
dispatches: ``submit_nested_transaction`` for each nested proof of a
batch, then ``generate_aggregated_transaction``.

Inputs (from the seed, by the reference alone): one nested application,
registered once, and for each request ``batch_size`` nested proofs with
their public inputs, distinct fees and 32-byte parameters; an invalid
request carries one proof whose public input is off by one.

The deployment's keypair comes from the reference's own trusted setup
(``reference/setup.py``) over the circuit's constraints, once per
checkout: the server loads it as the port's keypair file, and the
reference keeps the verification key it computed.

The reference judges each answer: the wrapper proof, decoded from its
JSON, must verify under that verification key for the
primary inputs the reference expects, [nested vk hash, result bits, each
nested input], in the pool's order (highest fee first), where a result
bit is 1 exactly for a nested proof that verifies; and the nested
parameters must come back in that order.
"""

from __future__ import annotations

import gc
import json
import os
import pickle
import random
import time

from ..reference import groth16 as ref
from ..reference import params as RP
from ..reference import setup as ref_setup
from .common import TimedProver


class System:
    def __init__(self, cfg: dict, device: str, cache: str, rec,
                 prover=None):
        import torch
        from zecale_tpu_torch.api import server_main

        self.cfg, self.rec, self.device = cfg, rec, device
        self.parts = {}
        path = os.path.join(cache, f"{cfg['name']}.keypair.pkl")
        vk_path = os.path.join(cache, f"{cfg['name']}.vk.json")
        if not (os.path.exists(path) and os.path.exists(vk_path)):
            t0 = time.time()
            self._make_keypair(path, vk_path)
            self.parts["keypair_generation_s"] = time.time() - t0
        t0 = time.time()
        self.svc, _ = server_main.build_service(
            cfg["server_argv"] + ["--keypair", path, "--device", device])
        self.parts["build_service_s"] = time.time() - t0
        self.prover = TimedProver(prover or self.svc.prover, rec)
        self.svc.prover = self.prover
        self.fault = None
        self._circuit_prove = self.svc.circuit.prove
        self.svc.circuit.prove = self._prove_batch
        with open(vk_path) as f:
            self.vk = ref.vk_from_json(json.load(f))
        curve = RP.CURVES[cfg["wrapper_curve"]]
        bits, q = curve.r.bit_length(), curve.q
        self.msm_groups = {"g1": (bits, q, 1),
                           "g2": (bits, q, curve.g2_degree)}
        self.constraints = self.svc.circuit.r1cs.num_constraints
        self.sync = (torch.cuda.synchronize if device == "cuda"
                     else lambda: None)

    def _make_keypair(self, path: str, vk_path: str) -> None:
        """The deployment's keypair: the reference's trusted setup over the
        circuit's constraints from the configuration's fixed rng, pickled
        as the server loads it, and its verification key as the
        reference's JSON."""
        from zecale_tpu_torch.aggregator.circuit import AggregatorCircuit
        from zecale_tpu_torch.snark.groth16 import (Groth16KeyPair,
                                                    Groth16ProvingKey,
                                                    Groth16VerificationKey)

        cfg = self.cfg
        curve = cfg["wrapper_curve"]
        r1cs = AggregatorCircuit(
            cfg["inputs_per_proof"], cfg["batch_size"],
            wrapper_curve=curve, nested_snark=cfg["nested_snark"],
            wrapper_snark=cfg["wrapper_snark"]).r1cs
        kp = ref_setup.generate(curve, r1cs.constraints, r1cs.num_primary,
                                r1cs.num_aux,
                                random.Random(cfg["keypair_seed"]))
        vk = kp["vk"]
        port_kp = Groth16KeyPair(
            pk=Groth16ProvingKey(**kp["pk"]),
            vk=Groth16VerificationKey(alpha=vk.alpha, beta=vk.beta,
                                      delta=vk.delta, abc=list(vk.abc)))
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(vk_path + ".tmp", "w") as f:
            json.dump(ref.vk_json(curve, vk), f)
        with open(path + ".tmp", "wb") as f:
            pickle.dump(port_kp, f)
        os.replace(vk_path + ".tmp", vk_path)
        os.replace(path + ".tmp", path)

    def _prove_batch(self, nested_vk, nested_proofs, wpk, rng=None,
                     prover=None, check=False):
        """The circuit's prove, where the tests plant "half_batch" (the
        second half of the batch replaced by the first) and "control"
        (every result bit reported as 1)."""
        if self.fault == "half_batch":
            half = nested_proofs[: len(nested_proofs) // 2]
            nested_proofs = (half * 2)[: len(nested_proofs)]
        ep = self._circuit_prove(nested_vk, nested_proofs, wpk, rng=rng,
                                 prover=prover, check=check)
        if self.fault == "control":
            ep.inputs[1] = (1 << len(nested_proofs)) - 1
        return ep

    def set_fault(self, fault) -> None:
        self.fault = fault
        self.prover.fault = fault

    # -- inputs, drawn from the seed by the reference ----------------------
    def inputs(self, mix: dict, seed: int, specs) -> dict:
        cfg = self.cfg
        nested = cfg["nested_curve"]
        app = ref.NestedApp(nested, cfg["inputs_per_proof"],
                            random.Random(f"{seed}/app"))
        name = f"app-{seed}"
        self.svc.register_application(name, ref.vk_json(nested, app.vk))
        wr = RP.CURVES[cfg["wrapper_curve"]].r
        return {"name": name,
                "vk_hash": ref.vk_hash(nested, app.vk, wr),
                "requests": {sp["key"]: self._request(app, name, sp)
                             for sp in specs}}

    def _request(self, app, name: str, sp: dict) -> dict:
        cfg = self.cfg
        rng = random.Random(sp["rng"])
        r = RP.CURVES[cfg["nested_curve"]].r
        batch = cfg["batch_size"]
        bad = rng.randrange(batch) if sp["invalid"] else -1
        fees = rng.sample(range(1, 10 ** 9), batch)
        txs = []
        for s in range(batch):
            x = [rng.randrange(r) for _ in range(cfg["inputs_per_proof"])]
            proof = app.prove(x, rng)
            claimed = [(x[0] + 1) % r] + x[1:] if s == bad else x
            txs.append({"app_name": name,
                        "extended_proof": ref.ext_proof_json(
                            cfg["nested_curve"], proof, claimed),
                        "parameters": rng.randbytes(32).hex(),
                        "fee_in_wei": fees[s]})
        return {"txs": txs, "valid": [s != bad for s in range(batch)]}

    # -- the timed call ------------------------------------------------------
    def serve(self, inp: dict, sp: dict):
        with self.rec.annotate("service.submit"):
            for tx in inp["requests"][sp["key"]]["txs"]:
                self.svc.submit_nested_transaction(tx)
        with self.rec.annotate("service.aggregate"):
            out = self.svc.generate_aggregated_transaction(inp["name"])
        self.sync()
        return out

    def work(self, answer) -> int:
        """Nested proofs settled by one answer."""
        return self.cfg["batch_size"]

    def close(self) -> None:
        import torch

        self.svc = self.prover = self._circuit_prove = None
        gc.collect()
        if self.device == "cuda":
            torch.cuda.empty_cache()

    # -- the reference's judgement -------------------------------------------
    def expected(self, inp: dict, sp: dict) -> tuple:
        """(primary inputs, nested parameters) the answer to ``sp`` must
        carry."""
        req = inp["requests"][sp["key"]]
        txs = req["txs"]
        order = sorted(range(len(txs)),
                       key=lambda s: (-txs[s]["fee_in_wei"], s))
        bits = sum(int(req["valid"][s]) << k for k, s in enumerate(order))
        nested_in = [int(x, 16) for s in order
                     for x in txs[s]["extended_proof"]["inputs"]]
        return ([inp["vk_hash"], bits] + nested_in,
                [txs[s]["parameters"] for s in order])

    def judge(self, inp: dict, sp: dict, answer: dict) -> dict:
        """{check: 0 or 1} of one answer."""
        inputs, params = self.expected(inp, sp)
        proof, got = ref.ext_proof_from_json(answer["ext_proof"])
        return {
            "wrong_inputs": int(got != inputs
                                or answer["app_name"] != inp["name"]),
            "wrong_parameters": int(answer["nested_parameters"] != params),
            "rejected_proofs": int(not ref.verify(
                self.cfg["wrapper_curve"], self.vk, inputs, proof)),
        }
