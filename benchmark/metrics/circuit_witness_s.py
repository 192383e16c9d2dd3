"""The wrapper circuit's witness a request: the port's span
``circuit.witness`` (the hook replay and the nested proofs' values)."""

from .program import per_request


def read(record):
    return per_request(record, ("circuit.witness",))
