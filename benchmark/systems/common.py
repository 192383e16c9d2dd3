"""What both systems share: the timing adapter around the port's prover,
and the faults that the benchmark's tests plant in the timed path."""

from __future__ import annotations

import time

#: phases of ``Groth16Torch.prove(timings=)``, in the order they run
PHASES = ("witness", "fft", "digitize", "msm", "assembly")


class TimedProver:
    """Stands where the system calls its prover's ``prove(r1cs, pk,
    assignment, rng)``: calls the port's prover with ``device_pk`` (where
    the deployment holds a packed key) and ``timings``, and hands the
    recorder the call's seconds and phases, and each phase as a span.

    ``fault`` (set only by the benchmark's tests):
    "state_unchanged" hands back the first proof it made for every later
    call; "answer_altered" swaps the proof's A and C."""

    def __init__(self, inner, rec, device_pk=None):
        self.inner = inner
        self.rec = rec
        self.device_pk = device_pk
        self.fault = None
        self._first = None

    def prove(self, r1cs, pk, assignment, rng=None):
        if self.fault == "state_unchanged" and self._first is not None:
            return self._first
        timings = {}
        extra = {} if self.device_pk is None else {
            "device_pk": self.device_pk}
        t0 = time.time_ns()
        with self.rec.annotate("bench.prove"):
            proof = self.inner.prove(r1cs, pk, assignment, rng,
                                     timings=timings, **extra)
        t1 = time.time_ns()
        self.rec.prover_call(t0, t1, timings,
                             msms=(r1cs.num_primary, pk, assignment))
        if self._first is None:
            self._first = proof
        if self.fault == "answer_altered":
            proof = type(proof)(a=proof.c, b=proof.b, c=proof.a)
        return proof
