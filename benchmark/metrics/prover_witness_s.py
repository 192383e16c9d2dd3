"""The prover's "witness" phase a request: the A, B, C evaluations, and
``pack_pk`` where the system passes no packed key."""

from .common import phase_mean


def read(record):
    return phase_mean(record, "witness")
