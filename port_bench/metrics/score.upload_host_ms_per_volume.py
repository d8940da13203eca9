"""Host ms a scored volume of the uploads of the prepared stacks: the
program's ``score.upload`` spans over the ``volumes`` of its
``score.request`` spans (``evaluate_prepared``)."""
from port_bench.program_spans import ms_per


def read(record):
    if record.kind != "score":
        return None
    return ms_per(("score.upload",), "score.request", "volumes")
