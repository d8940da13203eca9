"""Host ms a served volume of the finalize (the clamp, the tail and the
labels in numpy): the program's ``serve.finalize`` spans over the
``volumes`` of its root ``serve.request`` spans."""
from port_bench.program_spans import ms_per


def read(record):
    if record.kind != "serve":
        return None
    return ms_per(("serve.finalize",), "serve.request", "volumes")
