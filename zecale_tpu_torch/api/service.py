# Copied from zecale_tpu/api/service.py (JAX-free); docstrings and the tracer's spans changed.
"""Aggregator service core — the transport-independent implementation of the
six RPCs of the reference's Aggregator service (proto/zecale/api/
aggregator.proto:9-41; server behavior aggregator_server.cpp:106-349).

Transport lives in zecale_tpu_torch.api.grpc_server; this class is directly
drivable in tests (mirroring how the reference unit-tests pool/circuit
logic beneath the gRPC shell).
"""

from __future__ import annotations

import logging
from typing import Dict, List, Optional

from ..aggregator.pool import (
    AggregatedTransaction,
    ApplicationPool,
    NestedTransaction,
)
from ..ff import params as P
from ..serialization import json_codec as jc
from ..snark.groth16 import ExtendedProof, Groth16VerificationKey
from ..utils import profiling

log = logging.getLogger("zecale.aggregator")


class ServiceError(ValueError):
    """Maps to INVALID_ARGUMENT at the RPC boundary (the reference maps
    exceptions the same way, aggregator_server.cpp:267-275)."""


class AggregatorService:
    def __init__(
        self,
        circuit,
        wrapper_keypair,
        nested_curve: Optional[str] = None,
        wrapper_curve: Optional[str] = None,
        prover=None,
    ):
        """``circuit`` must expose num_proofs, num_inputs, prove(),
        compute_nested_vk_hash(); ``wrapper_keypair`` its Groth16 keypair.
        ``prover`` optionally overrides the proving backend (e.g. the
        device prover ``Groth16Torch``); None uses the circuit's default.
        The prover is given no packed device key: a device prover packs
        the proving key on the first aggregation request and keeps it
        resident for every later one (``TorchSnarkBase.resident_pk``)."""
        self.circuit = circuit
        self.keypair = wrapper_keypair
        self.nested_curve = nested_curve or getattr(
            circuit, "NESTED_CURVE", "bls12-377"
        )
        self.wrapper_curve = wrapper_curve or getattr(
            circuit, "WRAPPER_CURVE", "bw6-761"
        )
        self.nested_snark = getattr(circuit, "nested_snark", "GROTH16")
        self.wrapper_snark = getattr(circuit, "wrapper_snark", "GROTH16")
        self.prover = prover
        self.pools: Dict[str, ApplicationPool] = {}

    # -- GetConfiguration ----------------------------------------------------
    def get_configuration(self) -> dict:
        def pairing_params(curve_name: str) -> dict:
            from ..ec import host_curve as hc

            c = P.CURVES[curve_name]
            g1g, g2g = hc.generators(curve_name)
            return {
                "name": c.name,
                "r": jc.int_to_hex(c.r, c.scalar_bytes),
                "q": jc.int_to_hex(c.q, c.coord_bytes),
                "generator_g1": jc.g1_to_json(curve_name, g1g),
                "generator_g2": jc.g2_to_json(curve_name, g2g),
            }

        return {
            "nested_snark_name": self.nested_snark,
            "wrapper_snark_name": self.wrapper_snark,
            "nested_pairing_parameters": pairing_params(self.nested_curve),
            "wrapper_pairing_parameters": pairing_params(self.wrapper_curve),
        }

    # -- GetVerificationKey --------------------------------------------------
    def get_verification_key(self) -> dict:
        _, _, vk_to, _ = jc.snark_codec(self.wrapper_snark)
        return vk_to(self.wrapper_curve, self.keypair.vk)

    def _nested_vk_from_json(self, vk_json: dict):
        _, _, _, vk_from = jc.snark_codec(self.nested_snark)
        return vk_from(self.nested_curve, vk_json)

    # -- GetNestedVerificationKeyHash ---------------------------------------
    def get_nested_verification_key_hash(self, vk_json: dict) -> str:
        vk = self._nested_vk_from_json(vk_json)
        h = self.circuit.compute_nested_vk_hash(vk)
        return jc.fr_to_json(self.wrapper_curve, h)

    # -- RegisterApplication -------------------------------------------------
    def register_application(self, name: str, vk_json: dict) -> str:
        if name in self.pools:
            raise ServiceError(f"application '{name}' already registered")
        vk = self._nested_vk_from_json(vk_json)
        n_ic = len(vk.abc if self.nested_snark == "GROTH16" else vk.ic)
        if n_ic != self.circuit.num_inputs + 1:
            raise ServiceError(
                "vk shape does not match the aggregator input count"
            )
        self._check_vk_points(vk)
        self.pools[name] = ApplicationPool(
            name, vk, self.circuit.num_proofs
        )
        h = self.circuit.compute_nested_vk_hash(vk)
        log.info("registered application %s (vk hash %s)", name, hex(h))
        return jc.fr_to_json(self.wrapper_curve, h)

    def _check_vk_points(self, vk) -> None:
        from ..ec import host_curve as hc

        with profiling.span("service.check_points"):
            g1 = hc.g1_curve(self.nested_curve)
            g2 = hc.g2_curve(self.nested_curve)
            if self.nested_snark == "GROTH16":
                ok = (
                    g1.is_on_curve(vk.alpha)
                    and g2.is_on_curve(vk.beta)
                    and g2.is_on_curve(vk.delta)
                    and all(g1.is_on_curve(p) for p in vk.abc)
                )
            else:  # PGHR13: a,c,g,gb2,z in G2; b,gb1,IC in G1
                ok = (
                    all(g2.is_on_curve(p)
                        for p in (vk.a, vk.c, vk.g, vk.gb2, vk.z))
                    and g1.is_on_curve(vk.b)
                    and g1.is_on_curve(vk.gb1)
                    and all(g1.is_on_curve(p) for p in vk.ic)
                )
        if not ok:
            raise ServiceError("vk contains points not on the curve")

    # -- SubmitNestedTransaction --------------------------------------------
    def submit_nested_transaction(self, tx_json: dict) -> None:
        with profiling.request("service.submit"):
            self._submit(tx_json)

    def _submit(self, tx_json: dict) -> None:
        name = tx_json["app_name"]
        if name not in self.pools:
            raise ServiceError(f"application '{name}' not registered")
        with profiling.span("codec.decode"):
            ep = jc.extended_proof_from_json(
                self.nested_curve, tx_json["extended_proof"],
                self.nested_snark
            )
        if len(ep.inputs) != self.circuit.num_inputs:
            raise ServiceError("wrong number of nested primary inputs")
        self._check_proof_points(ep)
        tx = NestedTransaction(
            application_name=name,
            extended_proof=ep,
            parameters=bytes.fromhex(tx_json.get("parameters", "")),
            fee_in_wei=int(tx_json.get("fee_in_wei", 0)),
        )
        self.pools[name].add_tx(tx)
        log.info(
            "pool %s <- tx (fee %d), size now %d",
            name,
            tx.fee_in_wei,
            self.pools[name].size,
        )

    def _check_proof_points(self, ep: ExtendedProof) -> None:
        from ..ec import host_curve as hc

        with profiling.span("service.check_points"):
            g1 = hc.g1_curve(self.nested_curve)
            g2 = hc.g2_curve(self.nested_curve)
            p = ep.proof
            if self.nested_snark == "GROTH16":
                ok = (
                    g1.is_on_curve(p.a)
                    and g2.is_on_curve(p.b)
                    and g1.is_on_curve(p.c)
                )
            else:  # PGHR13: b in G2, everything else in G1
                ok = g2.is_on_curve(p.b) and all(
                    g1.is_on_curve(q)
                    for q in (p.a, p.a_p, p.b_p, p.c, p.c_p, p.h, p.k)
                )
        if not ok:
            raise ServiceError("proof contains points not on the curve")

    # -- GenerateAggregatedTransaction --------------------------------------
    def generate_aggregated_transaction(self, name: str) -> dict:
        with profiling.request("service.aggregate"):
            return self._aggregate(name)

    def _aggregate(self, name: str) -> dict:
        if name not in self.pools:
            raise ServiceError(f"application '{name}' not registered")
        pool = self.pools[name]
        batch = pool.get_next_batch()
        if batch is None:
            raise ServiceError(
                f"insufficient transactions in pool '{name}' "
                f"({pool.size} < {self.circuit.num_proofs})"
            )
        nested_proofs = [tx.extended_proof for tx in batch]
        wrapped = self.circuit.prove(
            pool.vk, nested_proofs, self.keypair.pk, prover=self.prover
        )
        agg = AggregatedTransaction(
            application_name=name,
            extended_proof=wrapped,
            nested_parameters=[tx.parameters for tx in batch],
        )
        with profiling.span("codec.encode"):
            ext_proof = jc.extended_proof_to_json(
                self.wrapper_curve, agg.extended_proof, self.wrapper_snark
            )
        return {
            "app_name": agg.application_name,
            "ext_proof": ext_proof,
            "nested_parameters": [
                p.hex() for p in agg.nested_parameters
            ],
        }
