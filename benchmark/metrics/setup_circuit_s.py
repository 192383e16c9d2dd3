"""Set-up seconds of the wrapper circuit's build: the port's span
``setup.circuit`` (``api/server_main.build_service``)."""

from .program import setup_sum


def read(record):
    return setup_sum(record, ("setup.circuit",))
