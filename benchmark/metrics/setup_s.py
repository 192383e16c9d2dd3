"""Seconds from process start to the first timed request: imports, the
kernels' load (and build in a checkout's first run), the system's set-up
and keypair, the inputs and the warm-up requests."""


def read(record):
    return record.setup_s
