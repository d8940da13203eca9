"""Perceptual path length over latent interpolations.

Port of ``superresolution_aniso_mri_tpu/evaluate/ppl.py`` (reference:
evaluate/perceptual_path_length.py:58-120): sample pairs of slices, mix
their latents at t and t + eps, LPIPS distance / eps², 1-99 percentile
filter, mean. The pairs and the t draws come from
``np.random.RandomState(seed)`` in JAX's order; encode and decode go
through the SR model when one is loaded; LPIPS is ``ops/lpips.py``'s
VGG16 (float32, TF32 off) on the trainer's device.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..ops.lpips import get_lpips_params, lpips_distance

# LPIPS weights resolved once per process and device
_PPL_LPIPS: Dict[str, dict] = {}


def _lpips_params(trainer) -> dict:
    """The trainer's own weights when it has them (a training trainer of
    a perceptual loss), else the resolved VGG LPIPS weights on its
    device, cached for the process."""
    params = getattr(trainer, "lpips_params", None)
    if params is not None:
        return params
    key = str(trainer.device)
    if key not in _PPL_LPIPS:
        _PPL_LPIPS[key] = get_lpips_params(device=trainer.device)
    return _PPL_LPIPS[key]


def compute_ppl(trainer, images: np.ndarray, num_pairs: int = 64,
                epsilon: float = 1e-4, seed: int = 0) -> float:
    """``images``: [N, H, W] pool of slices in [0, 1]; the mean LPIPS
    path length of ``num_pairs`` random pairs, decoded in chunks of the
    synthesis path's decode budget."""
    from ..infer.patches import _image_plane, _widen_tiles
    from ..infer.super_volume import _auto_decode_batch

    lpips_params = _lpips_params(trainer)
    rs = np.random.RandomState(seed)
    n = images.shape[0]
    idx1 = rs.randint(0, n, num_pairs)
    idx2 = rs.randint(0, n, num_pairs)
    t = rs.uniform(0, 1, num_pairs).astype(np.float32)

    h, w = images.shape[1], images.shape[2]
    depth = getattr(getattr(trainer, "model_config", None), "depth", 32)
    cap = _auto_decode_batch(num_pairs, h, w, depth) or num_pairs
    dev = trainer.device
    pool = np.asarray(images, np.float32)
    d_parts = []
    for i in range(0, num_pairs, cap):
        j1, j2 = idx1[i:i + cap], idx2[i:i + cap]
        # colors >= 2 stems (ACDCLBL) take an [image, label] pair; PPL
        # measures the image manifold, so the labels ride as zeros
        x1 = _widen_tiles(trainer, torch.from_numpy(pool[j1][:, None]).to(dev))
        x2 = _widen_tiles(trainer, torch.from_numpy(pool[j2][:, None]).to(dev))
        z1 = trainer.encode(x1, use_sr_model=True)
        z2 = trainer.encode(x2, use_sr_model=True)
        tt = torch.from_numpy(t[i:i + cap]).to(dev).reshape(
            (-1,) + (1,) * (z1.ndim - 1))
        z_a = tt * z2 + (1 - tt) * z1
        z_b = (tt + epsilon) * z2 + (1 - (tt + epsilon)) * z1
        img_a = _image_plane(trainer.decode(z_a, use_sr_model=True))
        img_b = _image_plane(trainer.decode(z_b, use_sr_model=True))
        d = lpips_distance(lpips_params, img_a[:, :1].float(),
                           img_b[:, :1].float(), normalize=True)
        d_parts.append(d.cpu().numpy() / (epsilon ** 2))
    d = np.concatenate(d_parts)
    lo, hi = np.percentile(d, [1, 99])
    d = d[(d >= lo) & (d <= hi)]
    return float(np.mean(d))
