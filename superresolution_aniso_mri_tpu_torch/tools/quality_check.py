"""End-to-end quality harness: does the latent-interpolation model beat
conventional interpolation on held-out synthetic volumes?

Port of the JAX package's ``tools/quality_check.py``, with its flags,
defaults, prints and JSON row, and one more flag, ``--device`` (``cuda``
unless it says ``cpu``). It trains a small ``ae_combined`` model on
procedural phantoms through direct ``Trainer`` calls, super-resolves
held-out volumes and prints the model's and the conventional methods'
metrics (the reference's notebook benchmark: model vs conventional
interpolation SSIM / PSNR / VIF).

``--loss_mode`` selects the training configuration:
  mse            — MSE synthesis loss + laplacian (the ablation config)
  perceptual     — LPIPS synthesis loss, the reference's default for
                   ae_combined (which LPIPS weights engaged is printed
                   as ``lpips_mode``)
  perceptual+lap — LPIPS synthesis loss + laplacian pyramid term
  mse+ssim       — MSE + SSIM structural term (use_ssim_loss)

    python -m superresolution_aniso_mri_tpu_torch.cli quality-check \\
        --epochs 30 --loss_mode perceptual [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

from .real_pipeline_quality import CONVENTIONAL, SCORED

LOSS_MODES = ("mse", "perceptual", "perceptual+lap", "mse+ssim")


def loss_mode_args(mode: str) -> dict:
    """Map a --loss_mode name onto the trainer's loss flags."""
    if mode == "mse":
        return {"use_percept_loss": False, "image_mix_loss_func": "mse",
                "use_laploss": True, "use_ssim_loss": False}
    if mode == "perceptual":
        return {"use_percept_loss": False,
                "image_mix_loss_func": "perceptual",
                "use_laploss": False, "use_ssim_loss": False}
    if mode == "perceptual+lap":
        return {"use_percept_loss": False,
                "image_mix_loss_func": "perceptual",
                "use_laploss": True, "use_ssim_loss": False}
    if mode == "mse+ssim":
        return {"use_percept_loss": False, "image_mix_loss_func": "mse",
                "use_laploss": True, "use_ssim_loss": True}
    raise ValueError(f"unknown loss_mode {mode!r}")


def build_parser():
    p = argparse.ArgumentParser(
        prog="quality-check",
        description="model vs conventional interpolation on phantoms")
    p.add_argument("--epochs", type=int, default=30)
    p.add_argument("--width", type=int, default=64)
    p.add_argument("--downsample_steps", type=int, default=3)
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--num_train_volumes", type=int, default=12)
    p.add_argument("--loss_mode", type=str, default="mse",
                   choices=LOSS_MODES)
    p.add_argument("--depth", type=int, default=24)
    p.add_argument("--phantom", type=str, default="smooth",
                   choices=("smooth", "textured"),
                   help="'textured' adds band-limited fine texture to "
                        "the phantoms (what through-plane interpolation "
                        "blurs away; separates the methods on VIF)")
    p.add_argument("--latent_interp", type=str, default="linear",
                   choices=["linear", "cubic", "lanczos3", "fitted"],
                   help="latent z-mixing of the model's scoring pass; "
                        "'fitted' learns the tap table on fresh "
                        "validation phantoms before scoring")
    p.add_argument("--json_out", type=str, default=None,
                   help="append a JSON result line to this file")
    p.add_argument("--device", type=str, default="cuda",
                   help="device of the training and scoring ('cpu' only "
                        "when asked)")
    return p


def build_volumes(phantom: str, n: int, size: int, ds: int, seed: int):
    """``n`` phantoms of ``6 * ds + 1`` slices at ``size``² from
    ``seed``, smooth or textured."""
    from ..data.synthetic import (make_textured_rotated_volume,
                                  make_toy_dataset)

    if phantom == "smooth":
        return make_toy_dataset(n, size=size, num_slices=6 * ds + 1,
                                seed=seed)
    return [make_textured_rotated_volume(size=size, num_slices=6 * ds + 1,
                                         seed=seed + i) for i in range(n)]


def train_args(args) -> dict:
    """The trainer's configuration (the JAX tool's)."""
    w = args.width
    targs = {
        "dataset": "MNIST3D", "model": "ae_combined",
        "ae_class": "VanillaACAI", "width": w, "latent_width": w // 4,
        "depth": args.depth, "latent": 64, "colors": 1, "lr": 2e-3,
        "weight_decay": 0.0, "batch_size": args.batch_size,
        "epochs": args.epochs, "epoch_threshold": 10 ** 9,
        "ex_loss_weight1": 0.1, "use_batchnorm": False,
        "use_sigmoid": True,
        "downsample_steps": args.downsample_steps, "seed": 7,
        "output_dir": None,
    }
    targs.update(loss_mode_args(args.loss_mode))
    return targs


def main(argv=None):
    args = build_parser().parse_args(argv)

    from ..data import AugmentConfig, TripletSampler, device_batch
    from ..device import resolve_device
    from ..evaluate import create_hr_images
    from ..train import Trainer

    dev = resolve_device(args.device)
    ds = args.downsample_steps
    w = args.width
    train_vols = build_volumes(args.phantom, args.num_train_volumes, w, ds,
                               seed=0)
    test_vols = build_volumes(args.phantom, 3, w, ds, seed=1000)

    trainer = Trainer(train_args(args), device=dev)
    lpips_mode = trainer.args.get("lpips_mode", "n/a")
    print(f"loss_mode={args.loss_mode}  lpips_mode={lpips_mode}")
    sampler = TripletSampler(train_vols, ds, "adjacent_plus", seed=3)
    if len(sampler) < args.batch_size:
        raise SystemExit(
            f"batch_size {args.batch_size} exceeds the {len(sampler)} "
            f"available triplets ({args.num_train_volumes} volumes) — "
            f"drop-last would yield zero batches per epoch")
    # the sampler's triplets as they are: no crop, rotation or intensity
    plain = AugmentConfig(patch_size=w, random_crop=False, rot90=False,
                          intensity=False)

    t0 = time.time()
    steps = 0
    for epoch in range(args.epochs):
        for raw in sampler.epoch_batches(args.batch_size):
            m = trainer.train(device_batch(raw, plain, dev))
            steps += 1
        if epoch % 5 == 0 or epoch == args.epochs - 1:
            print(f"epoch {epoch:3d}  loss_ae={float(m['loss_ae']):.5f} "
                  f"synth={float(m['loss_ae_dist_extra']):.5f}",
                  flush=True)
    dt = time.time() - t0
    print(f"trained {steps} steps in {dt:.1f}s "
          f"({steps / dt:.1f} steps/s)")

    score_latent_interp = args.latent_interp
    if args.latent_interp == "fitted":
        # the tap table from validation phantoms disjoint from both the
        # training and the test volumes
        from ..infer.latent_taps import fit_latent_taps, save_latent_taps

        val_vols = build_volumes(args.phantom, 3, w, ds, seed=2000)
        fit = fit_latent_taps(trainer, val_vols, ds, verbose=True)
        tap_path = os.path.join(tempfile.mkdtemp(prefix="sr_taps_"),
                                "latent_taps.npz")
        save_latent_taps(tap_path, fit["offsets"], fit["alphas"],
                         fit["weights"])
        print(f"fitted taps: holdout mse {fit['loss_init']:.6f} -> "
              f"{fit['loss_final']:.6f}")
        score_latent_interp = f"fitted:{tap_path}"

    print(f"\n=== {ds}x through-plane SR on held-out volumes ===")
    rows = {"model (AESR)": create_hr_images(
        trainer, test_vols, downsample_steps=ds,
        latent_interp=score_latent_interp)["aggregate"]}
    for method in CONVENTIONAL:
        rows[method] = create_hr_images(
            None, test_vols, downsample_steps=ds, interpol_method=method,
            device=dev)["aggregate"]

    hdr = (f"{'method':>14} | {'SSIM synth':>12} | {'PSNR synth':>12} | "
           f"{'VIF synth':>12}")
    print(hdr)
    print("-" * len(hdr))
    for name, agg in rows.items():
        print(f"{name:>14} | {agg['ssim_synth'][0]:12.4f} | "
              f"{agg['psnr_synth'][0]:12.3f} | {agg['vif_synth'][0]:12.4f}")

    model = rows["model (AESR)"]
    wins = {}
    for metric in SCORED:
        best_conv = max(rows[m][metric][0] for m in CONVENTIONAL)
        wins[metric] = (model[metric][0], best_conv)
    all_beat = all(m > c for m, c in wins.values())
    for metric, (mv, cv) in wins.items():
        tag = "BEATS" if mv > cv else ("ties" if mv == cv
                                       else "does not beat")
        print(f"{metric}: model {tag} best conventional "
              f"({mv:.4f} vs {cv:.4f})")
    print(f"\nmodel {'BEATS' if all_beat else 'does not beat'} "
          f"conventional interpolation on ALL metrics")

    rec = {
        "loss_mode": args.loss_mode, "lpips_mode": lpips_mode,
        "latent_interp": args.latent_interp,
        "epochs": args.epochs, "depth": args.depth,
        "phantom": args.phantom,
        "downsample_steps": ds,
        "train_seconds": round(dt, 1),
        "model": {k: round(float(model[k][0]), 5) for k in SCORED},
        "best_conventional": {
            k: round(float(max(rows[m][k][0] for m in CONVENTIONAL)), 5)
            for k in SCORED},
        "beats_all": bool(all_beat),
    }
    if args.json_out:
        with open(args.json_out, "a") as f:
            f.write(json.dumps(rec) + "\n")
        print(f"appended result to {args.json_out}")
    return rec
