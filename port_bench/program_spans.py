"""What the per-layer readers take from the program's own spans
(``superresolution_aniso_mri_tpu_torch.utils.profiling``): the spans
stored while the profiler ran, which is the traced window alone. A
program without spans gives none, and every reader of them returns
None."""
from __future__ import annotations

from typing import Optional, Sequence


def stored() -> list:
    """The program's closed spans, [] where the program keeps none."""
    try:
        from superresolution_aniso_mri_tpu_torch.utils.profiling import \
            spans
    except ImportError:
        return []
    return [s for s in spans() if s.end_ns is not None]


def mean_ms(name: str) -> Optional[float]:
    """The mean duration, in ms, of the spans named ``name``."""
    ns = [s.end_ns - s.start_ns for s in stored() if s.name == name]
    return 1e-6 * sum(ns) / len(ns) if ns else None


def ms_per(names: Sequence[str], root: str, count: str) -> Optional[float]:
    """The summed duration, in ms, of the spans named in ``names`` over
    the sum of ``count`` of the root spans named ``root``."""
    spans = stored()
    n = sum(s.counts.get(count, 0) for s in spans
            if s.name == root and s.parent is None)
    ns = [s.end_ns - s.start_ns for s in spans if s.name in names]
    return 1e-6 * sum(ns) / n if n and ns else None


def builds() -> Optional[int]:
    """The number of ``build.*`` spans: what the program built (a kernel
    library, a CUDA graph, an eager warm-up step, a synthesis core)."""
    spans = stored()
    return sum(s.name.startswith("build.") for s in spans) if spans else None
