"""The share of the traced window, in %, in which no kernel, copy or set
ran on the card (the union of the device's events in the trace)."""


def read(record):
    if record.kind != "serve":
        return None
    return 100.0 * (1.0 - record.trace.busy_s / record.window_s)
