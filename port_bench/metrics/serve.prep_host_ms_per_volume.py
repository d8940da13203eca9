"""Host ms a served volume of the input's preparation and upload: the
program's ``serve.prep`` and ``serve.upload`` spans over the ``volumes``
of its root ``serve.request`` spans (``create_super_volumes``)."""
from port_bench.program_spans import ms_per


def read(record):
    if record.kind != "serve":
        return None
    return ms_per(("serve.prep", "serve.upload"), "serve.request", "volumes")
