"""End-to-end training-PIPELINE throughput benchmark.

Port of the repo's ``tools/pipeline_bench.py``. ``train-bench`` times
the train step alone; this command times what a user gets from the
whole CLI loop — host sampler, device-side augmentation, optimizer
step, per-epoch validation / flush / checkpointing — by fabricating an
OASIS-shaped tree (``real_pipeline_quality.make_textured_oasis_tree``)
and running ``python -m superresolution_aniso_mri_tpu_torch.cli
train-brain --device <device>`` on it for a few epochs per variant, with
JAX's flags. It prints the median steady-state epoch time (epoch 0
holds the warm-up) and the derived ms/step for each
``--device_data_cache`` variant (the host input path, the device slice
cache, ``auto``), beside the card's name and power limit.

This process never touches the device: the children do.

    python -m superresolution_aniso_mri_tpu_torch.cli pipeline-bench
    python -m superresolution_aniso_mri_tpu_torch.cli pipeline-bench \\
        --variants 1 --device cpu
"""
from __future__ import annotations

import argparse
import os
import re
import shutil
import subprocess
import tempfile
from typing import Dict, Tuple

import numpy as np

from ._subproc import REPO, child_env
from .real_pipeline_quality import cli_command, make_textured_oasis_tree
from .roofline import smi_line

# the train loop's epoch line: "epoch    3  loss_ae=... val=...  (0.4s)"
EPOCH_RE = re.compile(r"^epoch\s+(\d+)\s.*\(([\d.]+)s\)", re.M)


def run_variant(data_root: str, cache: str, args) -> Tuple[float, float,
                                                           int]:
    """(first epoch s, median steady epoch s, steps an epoch) of one
    training child with ``--device_data_cache cache``."""
    out = tempfile.mkdtemp(prefix=f"sr_pb_{cache}_")
    cmd = [
        *cli_command("train-brain", args.device), "-d", "OASIS",
        "-m", "ae_combined", "--downsample_steps", "3",
        "--width", str(args.inplane),
        "--latent_width", str(args.inplane // 4),
        "--latent", str(args.latent), "--depth", str(args.depth),
        "--aug_patch_size", str(args.inplane),
        "-b", str(args.batch_size), "--lr", "0.002",
        "-e", str(args.epochs), "--epoch_threshold", "999999",
        "--ex_loss_weight1", "0.001", "--volume_preview_interval", "0",
        "--seed", "7", "--image_mix_loss_func", "mse",
        "--use_batchnorm", "0", "--device_data_cache", cache,
        "-o", out, "-id", "pb",
    ]
    try:
        r = subprocess.run(cmd, cwd=REPO, env=child_env(data_root),
                           capture_output=True, text=True, timeout=3600)
        if r.returncode != 0:
            raise SystemExit(f"variant cache={cache} failed:\n"
                             + r.stdout[-2000:] + r.stderr[-2000:])
        times = {int(e): float(s) for e, s in EPOCH_RE.findall(r.stdout)}
        if len(times) < 3:
            raise SystemExit(f"variant cache={cache}: too few epoch "
                             f"lines parsed ({len(times)}):\n"
                             + r.stdout[-2000:])
        # exact steps/epoch from the run's own iteration archive
        iters = np.load(os.path.join(out, "pb", "loss_iters.npz"))
        steps = int(np.diff(iters["loss_iters"]).max())
    finally:
        shutil.rmtree(out, ignore_errors=True)
    steady = [times[e] for e in sorted(times) if e >= 1]
    return float(times[0]), float(np.median(steady)), steps


def card_of_children(device: str) -> str:
    """The card line (nvidia-smi's ``name, power.limit``) of the
    children's device, read without a CUDA context in this process."""
    if not device.startswith("cuda"):
        return f"cpu, {os.cpu_count()} cores"
    index = int(device.split(":")[1]) if ":" in device else 0
    return smi_line(index) or "power limit not read (no nvidia-smi)"


def main(argv=None) -> Dict[str, Dict]:
    p = argparse.ArgumentParser(prog="pipeline-bench",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("--inplane", type=int, default=64)
    p.add_argument("--num_slices", type=int, default=37)
    p.add_argument("--n_patients", type=int, default=24)
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--depth", type=int, default=24)
    p.add_argument("--latent", type=int, default=128)
    p.add_argument("--epochs", type=int, default=10)
    p.add_argument("--variants", nargs="+", default=["0", "1"],
                   choices=["0", "1", "auto"],
                   help="--device_data_cache values to benchmark")
    p.add_argument("--device", type=str, default="cuda",
                   help="the training children's device (cuda, or cpu)")
    args = p.parse_args(argv)

    card = card_of_children(args.device)
    print(f"card: {card}", flush=True)
    work = tempfile.mkdtemp(prefix="sr_pb_data_")
    results: Dict[str, Dict] = {}
    try:
        make_textured_oasis_tree(work, 3, args.n_patients, args.inplane,
                                 args.num_slices)
        for cache in args.variants:
            compile_s, steady_s, steps = run_variant(work, cache, args)
            ms = 1e3 * steady_s / max(1, steps)
            results[cache] = {"first_epoch_s": compile_s,
                              "steady_epoch_s": steady_s,
                              "steps_per_epoch": steps,
                              "ms_per_step": ms, "card": card}
            print(f"cache={cache:>4}: first epoch {compile_s:7.1f}s "
                  f"(warm-up) | steady {steady_s:6.2f}s/epoch "
                  f"(~{ms:6.1f} ms/step "
                  f"incl. per-epoch val/flush/checkpoint) | {card}",
                  flush=True)
        if "0" in results and "1" in results:
            speedup = (results["0"]["steady_epoch_s"]
                       / results["1"]["steady_epoch_s"])
            print(f"device cache speedup: {speedup:.2f}x steady-state")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return results
