"""Host ms a served volume in the readback (the wait for the queued
synthesis, then the copy to host memory): the program's
``serve.readback`` spans over the ``volumes`` of its root
``serve.request`` spans."""
from port_bench.program_spans import ms_per


def read(record):
    if record.kind != "serve":
        return None
    return ms_per(("serve.readback",), "serve.request", "volumes")
