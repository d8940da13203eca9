"""Run one cell of the port's benchmark and print its result line.

    python3 -m port_bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the cell's CUDA cards.
Set-up (``setup_s``, from the process's start: imports, the seeded
inputs and weights, the program's warm-up of the cell's shapes) is
followed by a window of ``--seconds`` in which nothing compiles. With
``--trace 0`` the result's metrics are the cell's end-to-end metrics;
with ``--trace 1`` the window (the traffic's ``trace_seconds`` at most)
runs under ``torch.profiler`` and the metrics are the cell's per-layer
metrics, read by ``metrics/<name>.py``. After the window the peak device
memory is read, the program's state is freed, and the reference judges
what the window produced: every compared number is printed beside its
limit on standard error and, under ``checks``, last in the result line,
the last line of standard output. A run that finds no CUDA card, fewer
cards than the cell asks for, or a module of JAX or of the JAX package
loaded, exits non-zero and prints no result.
"""
import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

from .harness import ROOT  # noqa: E402

# every build and kernel cache at a fixed place inside the checkout; the
# port's own nvcc builds go to its package's _build/
CACHE = ROOT / ".port_bench_cache"
for var, sub in (("CUDA_CACHE_PATH", "cuda"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton"),
                 ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
    os.environ[var] = str(CACHE / sub)


def parse(argv=None):
    ap = argparse.ArgumentParser(prog="port_bench.run",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def fail(msg: str) -> int:
    print(f"port_bench: {msg}", file=sys.stderr, flush=True)
    return 3


def main(argv=None) -> int:
    args = parse(argv)
    from .harness import load_cell

    cell = load_cell(args.workload)
    import torch

    if not torch.cuda.is_available():
        return fail("no CUDA device: the benchmark measures the card and "
                    "never falls back to the CPU")
    if torch.cuda.device_count() < cell.chips:
        return fail(f"{args.workload} needs {cell.chips} cards, "
                    f"{torch.cuda.device_count()} present")
    import superresolution_aniso_mri_tpu_torch  # noqa: F401  (the program)

    from . import harness

    try:
        result = harness.execute(cell, args.seed, args.seconds,
                                 bool(args.trace), torch.device("cuda", 0),
                                 _T0)
    except harness.BannedModules as exc:
        return fail(str(exc))
    print("setup_parts " + " ".join(f"{k}={v:.3f}" for k, v in
                                    result["setup_parts"].items()),
          file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
