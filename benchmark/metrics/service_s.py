"""The service's own seconds a request: the port's spans
``service.submit`` and ``service.aggregate`` less the ``circuit.prove``
inside them, which holds the circuit witness and the prover call; left
are the JSON codecs, the on-curve checks and the pool."""

from .program import per_request, seconds


def read(record):
    return per_request(
        record, ("service.submit", "service.aggregate", "circuit.prove"),
        lambda s: -seconds(s) if s.name == "circuit.prove" else seconds(s))
