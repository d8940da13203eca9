"""Host ms a scored volume in the VIF call: the program's ``score.vif``
spans over the ``volumes`` of its ``score.request`` spans: the host's
time to launch VIF's many small operations and to wait where they
synchronise, not their device time."""
from port_bench.program_spans import ms_per


def read(record):
    if record.kind != "score":
        return None
    return ms_per(("score.vif",), "score.request", "volumes")
