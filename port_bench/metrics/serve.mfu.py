"""Serving's share of the card's bf16 dense peak, in %: the frozen
synthesis FLOPs of a served volume (``counts.flops``; useful work only)
times the volumes served in the traced window, over the window and 989
TFLOP/s."""
from port_bench.counts.peaks import BF16_FLOPS


def read(record):
    if record.kind != "serve" or not record.counters.get("volumes"):
        return None
    return (100.0 * record.counters["flops_per_volume"]
            * record.counters["volumes"] / record.window_s / BF16_FLOPS)
