"""Per-volume metric aggregation (all slices + synthesized-only).

Port of ``superresolution_aniso_mri_tpu/evaluate/metrics_driver.py``:
one batched call per metric per volume on the device; SSIM goes through
``ssim_volume_fused`` (the CUDA kernel on the card).
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ..device import resolve_device
from ..ops.cuda_kernels import ssim_volume_fused
from ..ops.metrics import masked_mean, psnr_volume, synth_slice_mask, vif_volume


def compute_volume_metrics(reference: np.ndarray, upsampled: np.ndarray,
                           downsample_steps: Optional[int] = None,
                           conv_interpol: bool = False,
                           eval_axis: int = 0,
                           lpips_params=None,
                           data_range: float = 1.0,
                           device=None) -> Dict[str, float]:
    """SSIM/PSNR/VIF/MSE over a [S, H, W] volume pair on ``device``
    (None: the CUDA device). '<metric>' averages all slices,
    '<metric>_synth' only the synthesized ones; for ``eval_axis != 0``
    the volume is re-sliced along that axis, all-black slices are
    skipped and '_synth' equals the all-slice value."""
    if lpips_params is not None:
        raise NotImplementedError(
            "LPIPS scoring is not ported to the PyTorch package yet "
            "(ROADMAP.md, S6)")
    dev = resolve_device(device)
    ref = np.asarray(reference, np.float32)
    up = np.asarray(upsampled, np.float32)
    if ref.ndim == 4:
        ref = ref[:, 0] if ref.shape[1] == 1 else ref.squeeze()
    if up.ndim == 4:
        up = up[:, 0] if up.shape[1] == 1 else up.squeeze()
    if ref.ndim != 3 or up.ndim != 3:
        raise ValueError(
            f"compute_volume_metrics expects [S, H, W] volumes (got "
            f"{ref.shape} vs {up.shape}); score true 4D cine volumes "
            f"frame by frame")

    if eval_axis != 0:
        ref = np.ascontiguousarray(np.swapaxes(ref, 0, eval_axis))
        up = np.ascontiguousarray(np.swapaxes(up, 0, eval_axis))

    s = ref.shape[0]
    all_mask = np.ones(s, bool)
    if eval_axis != 0:
        all_mask &= ref.reshape(s, -1).sum(axis=1) > 0
    if downsample_steps is not None and eval_axis == 0:
        synth = synth_slice_mask(s, downsample_steps, conv_interpol)
    else:
        synth = all_mask.copy()
    synth = synth & all_mask

    ref_t = torch.from_numpy(ref).to(dev)
    up_t = torch.from_numpy(up).to(dev)
    # thin long-axis views: shrink to an odd window that fits
    m = min(ref.shape[1], ref.shape[2])
    win = 7 if m >= 8 else min(5, m)
    if win % 2 == 0:
        win -= 1
    if win >= 3:
        ssim_s = ssim_volume_fused(ref_t, up_t, data_range, win)
    else:
        # SSIM is undefined below a 3x3 window; NaN drops out below
        ssim_s = torch.full((s,), float("nan"), device=dev)
    psnr_s = psnr_volume(ref_t, up_t, data_range)
    vif_s = vif_volume(ref_t, up_t, data_range=data_range)
    d = ref_t - up_t
    mse_s = (d * d).mean(dim=(1, 2))

    stats = torch.stack([
        masked_mean(ssim_s, all_mask), masked_mean(psnr_s, all_mask),
        masked_mean(vif_s, all_mask), masked_mean(ssim_s, synth),
        masked_mean(psnr_s, synth), masked_mean(vif_s, synth),
    ]).cpu().numpy()
    mse_host = mse_s.cpu().numpy()
    out = dict(zip(("ssim", "psnr", "vif", "ssim_synth", "psnr_synth",
                    "vif_synth"), (float(v) for v in stats)))
    out["mse"] = (float(np.mean(mse_host[all_mask])) if all_mask.any()
                  else float("nan"))
    return out


def aggregate_metrics(per_volume: list) -> Dict[str, tuple]:
    """mean ± std across volumes, non-finite entries dropped."""
    keys = per_volume[0].keys()
    out = {}
    for k in keys:
        vals = np.asarray([m[k] for m in per_volume], np.float64)
        finite = vals[np.isfinite(vals)]
        if finite.size:
            out[k] = (float(np.mean(finite)), float(np.std(finite)))
        else:
            out[k] = (float("nan"), float("nan"))
    return out


class IdUniquifier:
    """'pid', 'pid#2', 'pid#3'... keys for duplicate patient ids."""

    def __init__(self):
        self._seen: dict = {}

    def take(self, pid: str) -> str:
        pid = str(pid)
        self._seen[pid] = self._seen.get(pid, 0) + 1
        n = self._seen[pid]
        return pid if n == 1 else f"{pid}#{n}"
