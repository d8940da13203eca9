"""Host ms of one batch's augmentation on the card: the mean of the
program's ``data.augment`` spans (``data.device_batch``) in the traced
window."""
from port_bench.program_spans import mean_ms


def read(record):
    return mean_ms("data.augment") if record.kind == "train" else None
