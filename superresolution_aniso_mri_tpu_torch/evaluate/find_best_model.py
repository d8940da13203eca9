"""Epoch-checkpoint sweep for model selection.

Port of ``superresolution_aniso_mri_tpu/evaluate/find_best_model.py``
(reference: evaluate/find_best_model.py:43-135): score each saved epoch
checkpoint on the validation volumes, track the best SSIM/PSNR/VIF over
all and over the synthesized slices, write ``model_perf_ds<k>.npz``.
"""
from __future__ import annotations

import glob
import os
import re
from typing import Dict, Iterable, List, Optional

import numpy as np

from ..data.volume import Volume
from .create_hr_images import create_hr_images

METRICS_TRACKED = ("ssim", "psnr", "vif", "ssim_synth", "psnr_synth",
                   "vif_synth")


def list_epoch_checkpoints(exper_dir: str) -> List[int]:
    files = glob.glob(os.path.join(exper_dir, "models", "*.models"))
    epochs = []
    for f in files:
        m = re.fullmatch(r"(\d+)\.models", os.path.basename(f))
        if m:
            epochs.append(int(m.group(1)))
    return sorted(epochs)


def find_best_val_model(exper_dir: str, volumes: Iterable[Volume],
                        downsample_steps: int,
                        epoch_range: Optional[Iterable[int]] = None,
                        batched: bool = False,
                        verbose: bool = False,
                        latent_interp: str = "linear",
                        device=None) -> Dict:
    """Sweep checkpoints on ``device`` (None: the CUDA device); returns
    per-epoch aggregates and the argmax per tracked metric, and saves
    ``model_perf_ds<downsample_steps>.npz`` into the experiment dir.

    One trainer is built and each checkpoint is loaded into it in place.
    ``batched=True`` scores every shape group of volumes with one
    synthesis and one SSIM launch per chunk (``evaluate/sweep.py``)."""
    from ..train import get_trainer

    volumes = list(volumes)
    if epoch_range is None:
        epoch_range = list_epoch_checkpoints(exper_dir)
    epoch_range = list(epoch_range)
    if not epoch_range:
        raise ValueError(f"no epoch checkpoints in {exper_dir}/models")

    history: Dict[str, List[float]] = {k: [] for k in METRICS_TRACKED}
    trainer = get_trainer(exper_dir, model_nbr=None, eval_mode=True,
                          device=device)
    prep = None
    if batched:
        from .sweep import evaluate_prepared, prepare_sweep_batches
        prep = prepare_sweep_batches(trainer, volumes, downsample_steps)
    for epoch in epoch_range:
        trainer.load(os.path.join(exper_dir, "models", f"{epoch}.models"))
        if batched:
            # per-frame entries, so multi-frame patients weigh like the
            # reference's per-frame lists; nanmean drops NaN entries
            per_vol = evaluate_prepared(trainer, prep, latent_interp)
            for k in METRICS_TRACKED:
                history[k].append(float(np.nanmean(
                    [m[k] for m in per_vol.values()])))
        else:
            res = create_hr_images(trainer, volumes, downsample_steps,
                                   save_volumes=False,
                                   latent_interp=latent_interp)
            for k in METRICS_TRACKED:
                history[k].append(res["aggregate"][k][0])
        if verbose:
            print(f"epoch {epoch}: " + " ".join(
                f"{k}={history[k][-1]:.4f}" for k in METRICS_TRACKED))

    # NaN-robust argmax: an epoch whose metric is NaN is never "best"; a
    # metric NaN at EVERY epoch reports epoch=None/value=nan; +inf values
    # (exact reconstruction → PSNR) survive as inf
    best = {}
    for k, v in history.items():
        vals = np.asarray(v, np.float64)
        usable = ~np.isnan(vals)
        if not usable.any():
            best[k] = {"epoch": None, "value": float("nan")}
            continue
        cmp = np.where(usable, vals, -np.inf)
        idx = int(np.argmax(cmp))
        best[k] = {"epoch": int(epoch_range[idx]),
                   "value": float(vals[idx])}
    out_file = os.path.join(exper_dir,
                            f"model_perf_ds{downsample_steps}.npz")
    np.savez(out_file, epochs=np.array(epoch_range),
             **{k: np.array(v) for k, v in history.items()})
    return {"epochs": epoch_range, "history": history, "best": best}
