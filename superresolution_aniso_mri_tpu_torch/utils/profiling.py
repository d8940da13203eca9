"""Profiler traces and step-time statistics.

Port of ``superresolution_aniso_mri_tpu/utils/profiling.py``: ``trace``
records a ``torch.profiler`` trace of a block (in place of
``jax.profiler``), ``StepTimer`` keeps wall-clock statistics per named
phase, ``device_memory_stats`` reads the allocator's counters.
"""
from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict, Optional

import numpy as np
import torch


@contextlib.contextmanager
def trace(log_dir: str, device=None):
    """Record the block with ``torch.profiler`` (CPU activity, and CUDA
    activity when ``device`` is a CUDA device) and write its Chrome trace
    to ``<log_dir>/trace_<pid>_<time>.json`` when the block ends (open it
    in Perfetto or chrome://tracing)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device is not None and torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(
        log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


class StepTimer:
    """Wall-clock statistics per named phase (data / step / eval ...)."""

    def __init__(self):
        self._times: Dict[str, list] = defaultdict(list)

    @contextlib.contextmanager
    def measure(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._times[name].append(time.perf_counter() - t0)

    def summary(self) -> Dict[str, Dict[str, float]]:
        out = {}
        for name, vals in self._times.items():
            arr = np.asarray(vals)
            out[name] = {
                "count": int(arr.size),
                "mean_s": float(arr.mean()),
                "median_s": float(np.median(arr)),
                "p95_s": float(np.percentile(arr, 95)),
                "total_s": float(arr.sum()),
            }
        return out

    def report(self) -> str:
        lines = []
        for name, s in sorted(self.summary().items()):
            lines.append(f"{name:>12}: n={s['count']:<6} "
                         f"mean={s['mean_s'] * 1e3:8.2f}ms "
                         f"p50={s['median_s'] * 1e3:8.2f}ms "
                         f"p95={s['p95_s'] * 1e3:8.2f}ms "
                         f"total={s['total_s']:8.2f}s")
        return "\n".join(lines)


def device_memory_stats(device=None) -> Optional[Dict]:
    """The CUDA caching allocator's counters of ``device`` (None: the
    current CUDA device), ``torch.cuda.memory_stats``; None for the CPU,
    which keeps none."""
    if device is not None and torch.device(device).type != "cuda":
        return None
    return torch.cuda.memory_stats(device)
