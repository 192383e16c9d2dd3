"""A stand-in for the port's device prover in the CPU tests: a Groth16
simulator with the trapdoor of a keypair these tests write, so that the
rest of a run (service, circuit witness, codecs, harness, reference)
runs on the CPU in seconds."""

from __future__ import annotations

import json
import os
import pickle
import random

from benchmark.reference import groth16 as ref


class SimProver:
    def __init__(self, app: ref.NestedApp):
        self.app = app
        self.calls = 0

    def prove(self, r1cs, pk, assignment, rng=None, timings=None,
              device_pk=None):
        from zecale_tpu_torch.snark.groth16 import Groth16Proof

        self.calls += 1
        inputs = assignment[1: 1 + r1cs.num_primary]
        p = self.app.prove(inputs, rng or random.Random(self.calls))
        if timings is not None:
            timings.update(witness=0.002, fft=0.003, digitize=0.001,
                           msm=0.004, assembly=0.001)
        return Groth16Proof(a=p.a, b=p.b, c=p.c)


def keypair(cache: str, name: str, curve: str, num_primary: int,
            seed: int = 7) -> SimProver:
    """Write the keypair files of configuration ``name`` (an empty proving
    key, a verification key with a known trapdoor, and that key as the
    reference's JSON) into ``cache`` and return the prover that knows its
    trapdoor."""
    from zecale_tpu_torch.snark.groth16 import (Groth16KeyPair,
                                                Groth16ProvingKey,
                                                Groth16VerificationKey)

    app = ref.NestedApp(curve, num_primary, random.Random(seed))
    vk = Groth16VerificationKey(alpha=app.vk.alpha, beta=app.vk.beta,
                                delta=app.vk.delta, abc=list(app.vk.abc))
    pk = Groth16ProvingKey(None, None, None, None, None, [], [], [], [], [])
    os.makedirs(cache, exist_ok=True)
    with open(os.path.join(cache, f"{name}.keypair.pkl"), "wb") as f:
        pickle.dump(Groth16KeyPair(pk=pk, vk=vk), f)
    with open(os.path.join(cache, f"{name}.vk.json"), "w") as f:
        json.dump(ref.vk_json(curve, app.vk), f)
    return SimProver(app)
