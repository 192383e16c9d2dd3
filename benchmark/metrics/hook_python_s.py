"""Seconds a request of the witness replay's Python hooks, run between
its C segments: the ``py_ns`` attribute of the port's span
``witness.replay``."""

from .program import per_request


def read(record):
    return per_request(record, ("witness.replay",),
                       lambda s: s.attrs.get("py_ns", 0) / 1e9)
