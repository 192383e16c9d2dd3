"""The prover's "msm" phase a request: its five MSMs."""

from .common import phase_mean


def read(record):
    return phase_mean(record, "msm")
