"""Set-up seconds of the witness engines' builds: the port's spans
``setup.hook_program`` (the circuit's witness program flattened for the
C replay, at the first witness) and ``setup.native_r1cs`` (the R1CS
packed for the C evaluations, at the first prove)."""

from .program import setup_sum


def read(record):
    return setup_sum(record, ("setup.hook_program", "setup.native_r1cs"))
