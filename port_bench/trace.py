"""Reduction of a ``torch.profiler`` trace to what the per-layer metrics
read: the device's busy time (the union of its kernels, copies and sets
inside the traced window), device time by kernel name, and the idle
gaps named by what the host was doing.

It reads the profiler's raw event list (``kineto_results``), not
``key_averages``, whose event tree takes minutes to build for a window
of many steps.
"""
from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Dict, List, Tuple

import torch

WINDOW = "port_bench.window"
SKIP = ("Activity Buffer Request",)
SHORT_GAP_S = 10e-6
LOOKBACK = 64


def _t(e) -> Tuple[float, float]:
    start = e.start_ns() * 1e-9
    return start, start + e.duration_ns() * 1e-9


def _annotation(e) -> bool:
    """A ``record_function`` range (on either side of the trace)."""
    flag = getattr(e, "is_user_annotation", None)
    return e.name().startswith("port_bench.") or (
        flag is not None and bool(flag()))


class TraceSummary:
    """``window_s``, ``busy_s``; ``device`` (name → seconds summed),
    ``gaps`` (what the host was doing → idle seconds summed)."""

    def __init__(self, prof):
        events = prof.profiler.kineto_results.events()
        cuda = torch.autograd.DeviceType.CUDA
        device: List[Tuple[float, float, str]] = []
        host: List[Tuple[float, float, str]] = []
        window = None
        for e in events:
            name = e.name()
            if e.device_type() == cuda:
                # a range's device-side shadow is no device work
                if name not in SKIP and not _annotation(e):
                    device.append((*_t(e), name))
            elif name == WINDOW:
                window = _t(e)
            else:
                host.append((*_t(e), name))
        if window is None:
            raise RuntimeError(f"the trace has no {WINDOW!r} range")
        lo, hi = window
        self.window_s = hi - lo
        self.device: Dict[str, float] = defaultdict(float)
        spans = []
        for s, e, name in device:
            s, e = max(s, lo), min(e, hi)
            if e > s:
                self.device[name] += e - s
                spans.append((s, e))
        spans.sort()
        merged: List[List[float]] = []
        for s, e in spans:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        self.busy_s = sum(e - s for s, e in merged)
        gaps = []
        prev = lo
        for s, e in merged:
            if s > prev:
                gaps.append((prev, s))
            prev = max(prev, e)
        if hi > prev:
            gaps.append((prev, hi))
        self.gaps = self._name_gaps(gaps, host)

    @staticmethod
    def _name_gaps(gaps, host) -> Dict[str, float]:
        """Each gap of ``SHORT_GAP_S`` or more named by the host ranges
        that cover its middle: the innermost benchmark range and the
        innermost torch operation ("no torch op" where the host runs
        Python or numpy); the shorter gaps (a launch's latency) summed
        under one name."""
        def index(items):
            items.sort()
            return items, [h[0] for h in items]

        bench, b_starts = index([h for h in host
                                 if h[2].startswith("port_bench.")])
        ops, o_starts = index([h for h in host
                               if not h[2].startswith("port_bench.")])

        def innermost(items, starts, mid, default):
            i = bisect.bisect_right(starts, mid)
            for h in reversed(items[max(0, i - LOOKBACK):i]):
                if h[1] >= mid:
                    return h[2]
            return default

        out: Dict[str, float] = defaultdict(float)
        for s, e in gaps:
            if e - s < SHORT_GAP_S:
                out[f"gaps under {SHORT_GAP_S * 1e6:.0f} us"] += e - s
                continue
            mid = 0.5 * (s + e)
            out[f"{innermost(bench, b_starts, mid, '-')} > "
                f"{innermost(ops, o_starts, mid, 'no torch op')}"] += e - s
        return out

    def device_time(self, match) -> float:
        """Device seconds of the names for which ``match(name)`` holds."""
        return sum(v for k, v in self.device.items() if match(k))

    def breakdown(self, top: int = 10) -> Dict:
        def best(d):
            return [[k[:200], v] for k, v in
                    sorted(d.items(), key=lambda kv: -kv[1])[:top]]
        return {"device_ops": best(self.device), "idle_gaps": best(self.gaps)}
