"""Host ms of one batch's gather from the device slice cache: the
mean of the program's ``data.gather`` spans
(``DeviceCachedSampler.sample_batch``) in the traced window."""
from port_bench.program_spans import mean_ms


def read(record):
    return mean_ms("data.gather") if record.kind == "train" else None
