"""Host ms a scored volume of the numpy means of the per-slice
metrics: the program's ``score.means`` spans over the ``volumes`` of
its ``score.request`` spans."""
from port_bench.program_spans import ms_per


def read(record):
    if record.kind != "score":
        return None
    return ms_per(("score.means",), "score.request", "volumes")
