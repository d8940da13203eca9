"""Train-step throughput on the card, with a roofline account per config.

Port of the repo's ``tools/train_bench.py``: the reference's headline
training configs (BASELINE.md) — ACDC ae_combined (12 pairs of 128²),
OASIS ae_combined (16 pairs of 64²) and dHCP (8 pairs of 256²), the
laplacian loss on — in float32 and bf16, through the port's ``Trainer``:

  * pipelined ms/step: ``--steps`` steps enqueued, one loss read back
    (the training loop's cadence);
  * sync ms/step: one step submitted and its loss read back; the
    difference is the per-step dispatch and readback cost the stream
    hides;
  * FLOPs per step (forward, backward and the optimizer update, counted
    once outside the timed loop by ``roofline.count_flops``: the
    convolutions; element-wise work counts 0) and TFLOP/s;
  * ``mfu_vs_bf16_peak``: achieved FLOP/s over the H100's 989 TFLOP/s
    bf16 peak for every row (the cross-dtype comparison);
  * the least bytes per step: the batch read once, the parameters,
    BatchNorm statistics and Adam moments read and written once;
  * the floors at the row's dtype peak (``peak_tflops_used``: 989 for
    bf16, 67 for float32, which runs with TF32 off) and at 3.35 TB/s, and
    ``gap_to_floor``, the pipelined step over the binding floor.

Every row prints beside the card's name and power limit. The row dicts
keep JAX's keys, with ``least_bytes`` in place of XLA's
``bytes_accessed`` and ``peak_tflops_used``, ``card`` added.

    python -m superresolution_aniso_mri_tpu_torch.cli train-bench \\
        [--steps 20] [--configs ACDC OASIS dHCP] [--json_out rows.json] \\
        [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import time
from typing import Dict, List

import numpy as np
import torch

from ..config.settings import apply_setting_defaults
from ..device import resolve_device
from ..models import AEConfig, build_model
from ..train import Trainer
from ..train.state import create_train_state
from ..train.steps import make_train_step
from ..train.trainer import loss_config_from_args
from . import roofline

# name, width, latent_width, depth, latent, pairs per batch
SHAPES = {
    "ACDC": ("ACDC ae_combined 128² b12", 128, 32, 32, 128, 12),
    "OASIS": ("OASIS ae_combined 64² b16", 64, 16, 32, 128, 16),
    "dHCP": ("dHCP ae_combined 256² b8", 256, 64, 32, 128, 8),
}
DTYPES = ("float32", "bfloat16")
MIX_WEIGHT = 0.05


def trainer_args(width, latent_width, depth, latent, batch_pairs,
                 compute_dtype) -> Dict:
    """JAX's ``bench_config`` settings."""
    return {
        "dataset": "MNIST3D", "model": "ae_combined",
        "ae_class": "VanillaACAI", "width": width,
        "latent_width": latent_width, "depth": depth, "latent": latent,
        "colors": 1, "lr": 1e-4, "weight_decay": 0.0,
        "batch_size": batch_pairs, "epochs": 10, "epoch_threshold": 10**9,
        "ex_loss_weight1": MIX_WEIGHT, "use_batchnorm": True,
        "use_sigmoid": True, "use_laploss": True,
        "use_percept_loss": False, "image_mix_loss_func": "mse",
        "downsample_steps": 2, "seed": 0, "output_dir": None,
        "compute_dtype": compute_dtype,
    }


def step_batch(width: int, batch_pairs: int,
               device: torch.device) -> Dict[str, torch.Tensor]:
    """JAX's batch: ``RandomState(0)`` images of the (2B ∥ B) contract,
    alphas 0.5 (values only off the meta device)."""
    if device.type == "meta":
        return {"image": torch.empty(2 * batch_pairs, 1, width, width,
                                     device=device),
                "slice_between": torch.empty(batch_pairs, 1, width, width,
                                             device=device),
                "alpha_from": torch.empty(batch_pairs, device=device),
                "alpha_to": torch.empty(batch_pairs, device=device)}
    rng = np.random.RandomState(0)

    def img(n):
        return torch.from_numpy(np.ascontiguousarray(
            rng.rand(n, width, width, 1).astype(np.float32)
            .transpose(0, 3, 1, 2))).to(device)

    return {"image": img(2 * batch_pairs),
            "slice_between": img(batch_pairs),
            "alpha_from": torch.full((batch_pairs,), 0.5, device=device),
            "alpha_to": torch.full((batch_pairs,), 0.5, device=device)}


def step_bytes(state, batch: Dict[str, torch.Tensor]) -> int:
    """Least bytes of one step: the batch read once; the parameters,
    buffers and optimizer moments read once and written once."""
    kept = (roofline.module_bytes(state.model)
            + roofline.tensor_bytes(state.opt_state))
    return roofline.tensor_bytes(batch) + 2 * kept


def meta_step_flops(args: Dict, width: int, batch_pairs: int) -> int:
    """FLOPs of one train step of the ``Trainer`` settings ``args`` on a
    batch of ``batch_pairs`` pairs of ``width``², counted on the meta
    device (shapes only, no values): the step function a ``Trainer``
    runs (``make_train_step``), on a state of the same shapes."""
    args = apply_setting_defaults(dict(args))
    meta = torch.device("meta")
    with meta:
        model = build_model(args.get("ae_class", "VanillaACAI"),
                            AEConfig.from_args(args))
    state = create_train_state(model, float(args["lr"]))
    step = make_train_step(loss_config_from_args(args))
    return roofline.count_flops(step, state,
                                step_batch(width, batch_pairs, meta),
                                MIX_WEIGHT)


def bench_config(name, width, latent_width, depth, latent, batch_pairs,
                 compute_dtype, device: torch.device, info: Dict,
                 steps=20) -> Dict:
    t = Trainer(trainer_args(width, latent_width, depth, latent,
                             batch_pairs, compute_dtype), device=device)
    batch = step_batch(width, batch_pairs, device)
    # one step counted (it also warms up: cuDNN plans, allocations)
    flops = roofline.count_flops(t.train, batch)
    least_bytes = step_bytes(t.state, batch)
    float(t.train(batch)["loss_ae"])

    sync_times = []
    for _ in range(max(5, steps // 4)):
        t0 = time.perf_counter()
        float(t.train(batch)["loss_ae"])
        sync_times.append(time.perf_counter() - t0)
    sync_step = float(np.median(sync_times))

    t0 = time.perf_counter()
    m = None
    for _ in range(steps):
        m = t.train(batch)
    float(m["loss_ae"])
    mean_step = (time.perf_counter() - t0) / steps

    peak = roofline.PEAK_FLOPS[compute_dtype]
    floor = roofline.Floor(flops, least_bytes, peak)
    tflops = flops / mean_step / 1e12
    mfu = flops / mean_step / roofline.H100_BF16_FLOPS
    gbps = least_bytes / mean_step / 1e9
    bw_frac = least_bytes / mean_step / roofline.H100_HBM_BYTES_PER_S
    ai = flops / least_bytes
    gap = mean_step / floor.bound_s
    print(f"{name:>28} [{compute_dtype:8}]: {mean_step * 1e3:8.3f} ms/step "
          f"pipelined ({batch_pairs / mean_step:7.1f} pairs/s) | "
          f"{sync_step * 1e3:8.3f} ms sync "
          f"(dispatch+readback {1e3 * (sync_step - mean_step):6.3f} ms) | "
          f"{flops / 1e9:7.2f} GFLOP -> {tflops:6.2f} TFLOP/s, "
          f"MFU {100 * mfu:5.2f}% of bf16 peak | "
          f"{least_bytes / 1e6:7.1f} MB least -> {gbps:6.1f} GB/s, "
          f"{100 * bw_frac:5.2f}% of HBM BW "
          f"(AI {ai:7.1f} FLOP/B) | "
          f"floor {1e3 * floor.bound_s:6.3f} ms at {peak / 1e12:.0f} TF/s "
          f"({'BW' if floor.bound_by == 'bytes' else 'compute'}-bound), "
          f"gap {gap:5.1f}x | {info['card']}", flush=True)
    return {"name": name, "dtype": compute_dtype,
            "pipelined_s": mean_step, "sync_s": sync_step,
            "flops": flops, "tflops": tflops, "mfu_vs_bf16_peak": mfu,
            "least_bytes": least_bytes, "gbps": gbps,
            "hbm_bw_fraction": bw_frac,
            "floor_compute_s": floor.compute_s,
            "floor_bandwidth_s": floor.bandwidth_s,
            "gap_to_floor": gap, "peak_tflops_used": peak / 1e12,
            "card": info["card"]}


def main(argv=None) -> List[Dict]:
    ap = argparse.ArgumentParser(prog="train-bench",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--json_out", type=str, default=None)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--configs", type=str, nargs="+",
                    choices=tuple(SHAPES), default=list(SHAPES))
    ap.add_argument("--device", type=str, default=None,
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    info = roofline.card(dev)
    print(f"card: {info['card']}", flush=True)
    rows = []
    for dtype in DTYPES:
        for c in args.configs:
            name, w, lw, d, lat, b = SHAPES[c]
            rows.append(bench_config(name, w, lw, d, lat, b, dtype, dev,
                                     info, steps=args.steps))
            if dev.type == "cuda":
                torch.cuda.empty_cache()
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(rows, f, indent=1)
        print(f"wrote {args.json_out}")
    return rows
