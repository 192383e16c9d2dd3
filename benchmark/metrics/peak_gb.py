"""Peak device memory allocated in the window (GB), after a reset of the
peak at its start."""


def read(record):
    if not record.window_peak_bytes:
        return None
    return record.window_peak_bytes / 1e9
