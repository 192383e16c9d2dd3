"""Share (%) of the traced window in which no kernel, copy or set ran
on the device (``trace.py``)."""


def read(record):
    if not record.trace or record.trace["window_s"] <= 0:
        return None
    t = record.trace
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
