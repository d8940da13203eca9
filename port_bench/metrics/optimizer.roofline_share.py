"""The optimizer's share of its roofline, in %: the least bytes of one
Adam update (``counts.vae.optimizer_least_bytes``: 28 bytes a trained
parameter) times the traced window's steps at 3.35 TB/s, over the device
time of the optimizer's kernels: those whose names hold
``multi_tensor_apply`` or ``adam`` in any case, so that a fused or
hand-written Adam is read as the same work. None where the record
counts no such bytes or the trace has no such time."""
from port_bench.counts.peaks import HBM_BYTES_PER_S


def _optimizer(name):
    low = name.lower()
    return "multi_tensor_apply" in low or "adam" in low


def read(record):
    least = record.counters.get("optimizer_least_bytes_per_step")
    if record.kind != "train" or not least or not record.counters.get(
            "steps"):
        return None
    t = record.trace.device_time(_optimizer)
    if t <= 0:
        return None
    return 100.0 * least * record.counters["steps"] / HBM_BYTES_PER_S / t
