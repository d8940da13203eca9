"""Readings that the limits of a cell's comparison are set from.

    python3 -m port_bench.calibrate --workload <cell> [--seeds 12]
        [--control 3] [--faults 3] [--first-seed N] [--seconds 2]

In one process, on the card, at the cell's own sizes: for each of
``--seeds`` seeds the cell is set up as a run sets it up, a short window
of ``--seconds`` serves what the traffic needs (training needs none),
and the program's outputs are compared with the float32 reference (the
lower readings). On the first ``--control`` seeds the control, the
reference in TF32 put in the program's place, is compared the same way
(the upper readings), and on the first ``--faults`` seeds each planted
fault of the driver's ``FAULTS``. A driver's ``readings``, where it has
them, adds the numbers it reads but does not compare. Prints one JSON
line per reading and a
summary: per number the largest program reading and the smallest
control and fault readings. Not run by the benchmark's runs.
"""
from __future__ import annotations

import argparse
import json
import math
import sys
import time

import torch

from . import harness


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="port_bench.calibrate")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--faults", type=int, default=3)
    ap.add_argument("--first-seed", type=int, default=3_000_000_000)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    cell = harness.load_cell(args.workload)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 3
    mod = harness.driver(cell.traffic["kind"])
    rows = []

    def emit(row):
        rows.append(row)
        print(json.dumps(row), flush=True)

    for i in range(args.seeds):
        seed = args.first_seed + 7919 * i
        t0 = time.perf_counter()
        job = mod.Job(cell, seed, device)
        if job.kind != "train":
            job.window(args.seconds)
        prog = job.program_outputs()
        ref = job.reference_outputs("float32")
        read = getattr(job, "readings", None) or (
            lambda p, r: job.compare(p, r)[0])
        emit({"seed": seed, "side": "program", "numbers": read(prog, ref),
              "s": time.perf_counter() - t0})
        if i < args.control:
            ctrl = job.as_program(job.reference_outputs("tf32"))
            emit({"seed": seed, "side": "control",
                  "numbers": read(ctrl, ref)})
        if i < args.faults:
            for fault in mod.FAULTS:
                bad = job.as_program(job.reference_outputs("float32", fault))
                emit({"seed": seed, "side": fault,
                      "numbers": read(bad, ref)})
        del job, prog, ref
        if device.type == "cuda":
            torch.cuda.empty_cache()
    summary = {}
    for side in {r["side"] for r in rows}:
        vals = {}
        for r in rows:
            if r["side"] == side:
                for k, v in r["numbers"].items():
                    vals.setdefault(k, []).append(v)
        pick = max if side == "program" else min
        summary[side] = {k: pick(v) for k, v in vals.items()}
    line = {"workload": args.workload, "summary": summary,
            "card": torch.cuda.get_device_name(device)
            if device.type == "cuda" else "cpu",
            "power_limit_w": harness.power_limit_w()}
    print(json.dumps(line), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            for r in rows + [line]:
                f.write(json.dumps({k: (v if not isinstance(v, float)
                                        or math.isfinite(v) else repr(v))
                                    for k, v in r.items()}) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
