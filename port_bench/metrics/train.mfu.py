"""The training step's share of the card's bf16 dense peak, in %: the
frozen FLOPs of a step (``counts.flops.train_step_flops``; element-wise
work counts 0) times the traced window's steps, over the window and
989 TFLOP/s. The bf16 peak bounds the step in any precision."""
from port_bench.counts.peaks import BF16_FLOPS


def read(record):
    if record.kind != "train" or not record.counters.get("steps"):
        return None
    return (100.0 * record.counters["flops_per_step"]
            * record.counters["steps"] / record.window_s / BF16_FLOPS)
