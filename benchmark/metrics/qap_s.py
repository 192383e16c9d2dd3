"""The prover's "fft" phase a request: the QAP division on the device."""

from .common import phase_mean


def read(record):
    return phase_mean(record, "fft")
