"""The per-request repack of the proving key a request: the port's span
``prove.pack_pk``, inside the prover's "witness" phase."""

from .program import per_request


def read(record):
    return per_request(record, ("prove.pack_pk",))
