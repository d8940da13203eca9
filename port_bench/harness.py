"""What every cell's run shares: the manifest and the files it names,
the run's context, the per-layer readers, the correctness verdict and
the result line."""
from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import math
import subprocess
import sys
from pathlib import Path
from typing import Callable, Dict, List, Optional

ROOT = Path(__file__).resolve().parent.parent
PKG = Path(__file__).resolve().parent
# top-level module names that a run of the port may not load
BANNED = ("jax", "jaxlib", "flax", "optax", "superresolution_aniso_mri_tpu")


@dataclasses.dataclass
class Cell:
    """A workload of the manifest with its configuration, traffic mix,
    limits and metrics."""

    name: str
    chips: int
    config: Dict
    traffic: Dict
    limits: Dict
    end_to_end: List[Dict]
    per_layer: List[Dict]


def _reported(metric: Dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json``: its configuration
    file, ``traffic/<mix>.json``, ``limits/<cell>.json`` (empty when
    absent: then no run is correct) and the metrics it reports."""
    manifest = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in manifest["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; the manifest has "
                         f"{sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in manifest["configs"]}
    config = json.loads((root / configs[w["config"]]["file"]).read_text())
    traffic = json.loads((PKG / "traffic" / f"{w['traffic']}.json")
                         .read_text())
    limits_file = PKG / "limits" / f"{name}.json"
    limits = (json.loads(limits_file.read_text()) if limits_file.exists()
              else {})
    return Cell(name, int(w["chips"]), config, traffic, limits,
                [m for m in manifest["end_to_end"] if _reported(m, name)],
                [m for m in manifest["per_layer"] if _reported(m, name)])


def driver(kind: str):
    """``drivers/<kind>.py``, the code of one kind of traffic."""
    return importlib.import_module(f"{__package__}.drivers.{kind}")


def reader(metric: str) -> Callable:
    """``read(record)`` of ``metrics/<metric>.py``."""
    path = PKG / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        f"{__package__}.metrics.{metric.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


class Stopwatch:
    """Seconds of a run's set-up by part: ``lap(name)`` ends the part
    ``name`` once the device has finished what was queued."""

    def __init__(self, device=None):
        import time

        self.device, self.parts = device, {}
        self._clock = time.perf_counter
        self._t = self._clock()

    def lap(self, name: str) -> None:
        import torch

        if self.device is not None and torch.device(self.device).type == \
                "cuda":
            torch.cuda.synchronize(self.device)
        now = self._clock()
        self.parts[name] = self.parts.get(name, 0.0) + now - self._t
        self._t = now


@dataclasses.dataclass
class Record:
    """What a traced window leaves for the per-layer readers: the kind of
    traffic, the window's length, the program's and the harness's
    counters (``counters``), the harness's host spans in seconds
    (``spans``) and the trace (``trace.TraceSummary``)."""

    kind: str
    window_s: float
    counters: Dict[str, float]
    spans: Dict[str, List[float]]
    trace: object


def per_layer(cell: Cell, record: Record) -> Dict[str, Dict]:
    out = {}
    for m in cell.per_layer:
        value = reader(m["name"])(record)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def verdict(cell: Cell, numbers: Dict[str, float],
            answers: List[Dict[str, float]]):
    """(correct, failed answers, checks): every number within its limit;
    an answer fails when one of its numbers passes its limit. A number
    without a limit, or that is not a number, fails."""
    checks, ok = {}, True
    for name, value in numbers.items():
        limit = cell.limits.get(name, {}).get("limit")
        good = (limit is not None and not math.isnan(value)
                and value <= limit)
        ok = ok and good
        checks[name] = {"value": value, "limit": limit}
    failed = sum(1 for a in answers if any(
        not (cell.limits.get(k, {}).get("limit") is not None
             and v <= cell.limits[k]["limit"]) for k, v in a.items()))
    return ok and failed == 0 and bool(numbers), failed, checks


def banned_modules() -> List[str]:
    """Loaded modules whose top-level name is in ``BANNED``, compared as
    whole names."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(BANNED))


def power_limit_w() -> Optional[float]:
    """The card's power limit by nvidia-smi, None when it cannot be read."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=30, check=True).stdout.split()
        return float(out[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


class BannedModules(RuntimeError):
    """Modules of JAX or of the JAX package were loaded."""


def _check_banned() -> None:
    banned = banned_modules()
    if banned:
        raise BannedModules(f"modules of JAX or of the JAX package are "
                            f"loaded: {banned}")


def _number(v):
    """A check's value for JSON: a float, or its repr where it is not a
    finite number."""
    ok = isinstance(v, float) and math.isfinite(v)
    return v if ok else repr(v)


def execute(cell: Cell, seed: int, seconds: float, trace: bool, device,
            t0: float) -> Dict:
    """Set up the cell from ``seed`` on ``device``, run its window and
    judge it; the result line's object (``checks`` last). ``t0`` is the
    process's start on ``time.perf_counter``'s clock."""
    import time

    import torch

    cuda = torch.device(device).type == "cuda"
    start_s = time.perf_counter() - t0
    job = driver(cell.traffic["kind"]).Job(cell, seed, device)
    if cuda:
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - t0
    # where set-up went: the process's start (imports, the CUDA context)
    # and the driver's parts
    setup_parts = {"start": start_s, **getattr(job, "setup_parts", {})}
    if trace:
        from torch.profiler import ProfilerActivity, profile

        seconds = min(float(seconds), float(cell.traffic["trace_seconds"]))
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda
                                         else [])
        with profile(activities=acts) as prof:
            win = job.window(seconds)
    else:
        win = job.window(float(seconds))
    memory_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    _check_banned()
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": cell.chips, "memory_peak_bytes": int(memory_peak),
           "power_limit_w": power_limit_w() if cuda else None}
    extra = {}
    if trace:
        from .trace import TraceSummary

        summary = TraceSummary(prof)
        del prof
        record = Record(job.kind, win["window_s"],
                        {**win["counters"], **job.work_counts()},
                        win["spans"], summary)
        metrics = per_layer(cell, record)
        dev.update(busy_s=summary.busy_s, window_s=summary.window_s)
        extra["breakdown"] = summary.breakdown()
    else:
        values = {**win["end_to_end"], "setup_s": setup_s}
        missing = sorted({m["name"] for m in cell.end_to_end} - set(values))
        if missing:
            raise RuntimeError(f"the run measured no {missing}")
        metrics = {m["name"]: {"value": float(values[m["name"]]),
                               "unit": m["unit"]} for m in cell.end_to_end}
    prog = job.program_outputs()
    job.release()
    if cuda:
        torch.cuda.empty_cache()
    numbers, answers = job.compare(prog, job.reference_outputs("float32"))
    correct, failed, checks = verdict(cell, numbers, answers)
    _check_banned()
    for c in checks.values():
        c["value"] = _number(c["value"])
    return {"correct": bool(correct), "attempted": win["attempted"],
            "failed": failed, "metrics": metrics, "device": dev, **extra,
            "setup_parts": setup_parts, "checks": checks}
