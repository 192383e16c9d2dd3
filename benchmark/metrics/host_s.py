"""Host seconds of a request outside the prover: the request's seconds
minus the seconds of its ``prove`` call (the service, the circuit's
witness, the codecs), summed over the window and divided by the
requests."""

from .common import ok


def read(record):
    done = [r for r in ok(record) if "prove_s" in r]
    if not done:
        return None
    return sum((r["t1"] - r["t0"]) / 1e9 - r["prove_s"]
               for r in done) / len(done)
