"""Benchmark the native host data loader against the numpy path.

Port of the repo's ``tools/loader_bench.py``, at its sizes, on the host
only: the two host-side hot spots the C++ runtime covers
(``csrc/srloader.cc`` through ``data/native_loader.py``):

  1. directory ingest: N gzipped NIfTI volumes decoded one after the
     other by ``utils/nifti.read_nifti`` against the native thread pool
     (``read_nifti_many``);
  2. triplet batch assembly: per-item ``np.stack`` against the threaded
     native channel-interleaving gather (``gather_triplets``).

Each pair of paths must give the same bits (else the command raises);
each time is the best of ``reps`` and stands beside the host's CPU
model and core count.

    python -m superresolution_aniso_mri_tpu_torch.cli loader-bench
"""
from __future__ import annotations

import argparse
import os
import platform
import shutil
import tempfile
import time
from typing import Dict, Sequence

import numpy as np

from ..data import native_loader as nl
from ..utils.nifti import read_nifti, write_nifti


def host() -> str:
    """The host CPU's model name (``/proc/cpuinfo``, else the machine
    type) and its core count."""
    model = platform.machine()
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("model name"):
                    model = line.split(":", 1)[1].strip()
                    break
    except OSError:
        pass
    return f"{model}, {os.cpu_count()} cores"


def _best_s(fn, reps: int) -> float:
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return min(times)


def bench_ingest(n_files: int = 12, shape: Sequence[int] = (40, 220, 220),
                 reps: int = 3) -> Dict:
    """Python against native decode of ``n_files`` seeded volumes."""
    rng = np.random.RandomState(0)
    d = tempfile.mkdtemp(prefix="sr_lb_")
    try:
        paths = []
        for i in range(n_files):
            p = os.path.join(d, f"vol{i:02d}.nii.gz")
            write_nifti(p, rng.rand(*shape).astype(np.float32),
                        spacing=[6.0, 1.0, 1.0])
            paths.append(p)
        for p, (arr, spacing, _) in zip(paths, nl.read_nifti_many(paths)):
            want = read_nifti(p)
            if not (np.array_equal(arr, want[0])
                    and np.array_equal(spacing, want[1])):
                raise AssertionError(f"native decode of {p} differs from "
                                     f"utils/nifti.read_nifti")
        py = _best_s(lambda: [read_nifti(p) for p in paths], reps)
        nat = _best_s(lambda: nl.read_nifti_many(paths), reps)
    finally:
        shutil.rmtree(d, ignore_errors=True)
    shape = tuple(shape)
    print(f"ingest {n_files} x {shape} .nii.gz: python {py:.3f}s, "
          f"native {nat:.3f}s ({py / nat:.2f}x) [host: {host()}]",
          flush=True)
    return {"n_files": n_files, "shape": list(shape), "python_s": py,
            "native_s": nat, "host": host()}


def bench_gather(b: int = 64, hw: Sequence[int] = (220, 220), c: int = 3,
                 reps: int = 20) -> Dict:
    """Python against native assembly of a [b, H, W, c] triplet batch."""
    rng = np.random.RandomState(1)
    n = 128
    vol = rng.rand(n, *hw).astype(np.float32)
    items = [[vol[rng.randint(n - 2)], vol[rng.randint(n - 2)],
              vol[rng.randint(n - 2)]][:c] for _ in range(b)]

    def numpy_batch():
        return np.stack([np.stack(ch, axis=-1) for ch in items])

    if not np.array_equal(nl.gather_triplets(items), numpy_batch()):
        raise AssertionError("the native gather differs from np.stack")
    py = _best_s(numpy_batch, reps)
    nat = _best_s(lambda: nl.gather_triplets(items), reps)
    print(f"gather [{b}, {hw[0]}x{hw[1]}, c={c}]: python {py * 1e3:.2f}ms, "
          f"native {nat * 1e3:.2f}ms ({py / nat:.2f}x) [host: {host()}]",
          flush=True)
    return {"batch": b, "hw": list(hw), "channels": c,
            "python_ms": py * 1e3, "native_ms": nat * 1e3, "host": host()}


def main(argv=None) -> Dict:
    argparse.ArgumentParser(prog="loader-bench",
                            description=__doc__.split("\n\n")[0]
                            ).parse_args(argv)
    if not nl.available():
        raise SystemExit("native runtime unavailable (SRL_DISABLE_NATIVE "
                         "is set)")
    return {"ingest": bench_ingest(), "gather": bench_gather()}
