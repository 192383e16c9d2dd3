"""Share of requests that found the proving key resident on the device:
the ``resident`` attribute (1 found, 0 packed) of the port's span
``prove.pack_pk``, in %.  A program whose span has no such attribute
gives nothing to read."""

from . import program


def read(record):
    snap = program.snapshot()
    if snap is None or not any("resident" in s.attrs for s in snap.spans
                               if s.name == "prove.pack_pk"):
        return None
    return program.per_request(
        record, ("prove.pack_pk",),
        lambda s: 100.0 * s.attrs.get("resident", 0))
