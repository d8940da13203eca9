"""The port's spans and profiler traces.

``span(name, **counts)`` marks one stage of serving, scoring, training or
building. Spans are on exactly while a ``torch.profiler`` runs (the
benchmark's ``--trace 1``, the commands' ``--profile_dir``): then each
span is stored (``spans()``) and entered as a ``record_function`` range
``sr.<name>``, so the profiler's trace carries it. Otherwise ``span``
returns one shared no-op context and records nothing.

The span sites, by layer:

- serving (``infer/super_volume.py``): ``serve.request`` (a
  ``create_super_volume(s)`` call; ``volumes``), ``serve.prep`` (the
  host's grid, label channel and padding), ``serve.upload``,
  ``synth.encode`` / ``synth.mix`` / ``synth.decode``
  (``SynthesisStages``), ``serve.readback`` (the wait for the card and
  the copy to the host; ``pinned``, ``host_allocs``), ``serve.finalize``
  (the host's tail and labels);
- scoring (``evaluate/sweep.py``): ``score.request`` (an
  ``evaluate_prepared`` call; ``volumes``, the chunks' rows),
  ``score.upload``, ``score.ssim`` / ``score.psnr`` / ``score.vif``,
  ``score.readback``, ``score.means``;
- training: ``train.dispatch`` (``Trainer.train_many``; ``steps``),
  ``train.replay`` (a CUDA graph replay with its copies),
  ``train.ema``, ``train.noise`` (``Trainer.draw_noise`` of the families
  that draw a step's noise; ``values``, the numbers drawn),
  ``data.gather`` (``DeviceCachedSampler``),
  ``data.augment`` (``data.device_batch``);
- building: ``build.graph`` (a CUDA graph capture), ``build.eager_step``
  (an eager warm-up step of a new batch signature), ``build.core`` (a
  synthesis core or sweep evaluator made), ``build.kernel`` (a native
  library, a CUDA kernel's or the data loader's, built or loaded).

Port of ``superresolution_aniso_mri_tpu/utils/profiling.py``'s
``trace``: ``torch.profiler`` in place of ``jax.profiler``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import itertools
import os
import threading
import time
from typing import Dict, List, Optional

import torch

_OFF = contextlib.nullcontext()
_STORE: List["Span"] = []
_LOCK = threading.Lock()
_OPEN = threading.local()
_REQUESTS = itertools.count()


@dataclasses.dataclass
class Span:
    """One stored span: ``start_ns`` / ``end_ns`` on ``time.time_ns()``
    (the profiler's host clock; ``end_ns`` is None while it is open),
    ``parent`` the index in ``spans()`` of the span that enclosed it
    (None for a root), ``request`` shared by a root and every span
    inside it, ``counts`` as given at the call site."""

    name: str
    start_ns: int
    end_ns: Optional[int]
    parent: Optional[int]
    request: int
    counts: Dict[str, int]
    index: int


def span(name: str, **counts: int):
    """A context that stores the span ``name`` and enters the
    ``record_function`` range ``sr.<name>`` while a profiler runs; the
    shared no-op context otherwise."""
    if not torch._C._autograd._profiler_enabled():
        return _OFF
    return _recorded(name, counts)


@contextlib.contextmanager
def _recorded(name: str, counts: Dict[str, int]):
    stack = getattr(_OPEN, "stack", None)
    if stack is None:
        stack = _OPEN.stack = []
    parent = stack[-1] if stack else None
    rng = torch.profiler.record_function("sr." + name)
    with _LOCK:
        rec = Span(name, 0, None, None if parent is None else parent.index,
                   next(_REQUESTS) if parent is None else parent.request,
                   counts, len(_STORE))
        _STORE.append(rec)
    stack.append(rec)
    try:
        # stamped next to the range's own stamps, with nothing allocated
        # in between that could start the garbage collector
        rec.start_ns = time.time_ns()
        with rng:
            yield rec
    finally:
        rec.end_ns = time.time_ns()
        stack.pop()


def spans() -> List[Span]:
    """The stored spans, in the order they were opened."""
    return _STORE


def clear_spans() -> None:
    """Empty the store."""
    with _LOCK:
        _STORE.clear()


@contextlib.contextmanager
def trace(log_dir: str, device=None):
    """Record the block with ``torch.profiler`` (CPU activity, and CUDA
    activity when ``device`` is a CUDA device) and write its Chrome trace
    to ``<log_dir>/trace_<pid>_<time>.json`` when the block ends (open it
    in Perfetto or chrome://tracing). The trace carries the port's stage
    ranges, ``sr.serve.*``, ``sr.synth.*``, ``sr.score.*``, ``sr.train.*``,
    ``sr.data.*`` and ``sr.build.*`` (``span``; this module's docstring
    lists each); the span store is emptied on entry, so ``spans()`` then
    holds the block's spans."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device is not None and torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    clear_spans()
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(
        log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))
