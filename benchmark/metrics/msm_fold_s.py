"""The host's part of the msm phase a request: the port's spans
``msm.fold``, each an MSM's subset sums converted to affine and folded
by the Horner loop on the host, after the device's work is done."""

from .program import per_request


def read(record):
    return per_request(record, ("msm.fold",))
