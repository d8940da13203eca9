"""Device-to-host copy ms a served volume: the device time of the trace's
``Memcpy DtoH`` events over the volumes served in the traced window."""


def read(record):
    if record.kind != "serve" or not record.counters.get("volumes"):
        return None
    t = record.trace.device_time(lambda n: n.startswith("Memcpy DtoH"))
    return 1e3 * t / record.counters["volumes"] if t > 0 else None
