"""Batch shaping on the device: padding, center crops, the (2B ∥ B) split.

Port of ``superresolution_aniso_mri_tpu/data/transforms.py`` for its
deterministic recipe, NCHW: ``pad_to_size`` (numpy, host),
``center_crop``, ``AugmentConfig``, ``augment_batch`` (pad, the
``aug_patch_size`` center crop, then pad or center crop to
``patch_size``; the JAX package's validation and MNIST3D recipe) and
``prepare_batch_pairs/quintets/septets``. The random ops (crop, rot90,
intensity, any-angle rotation, noise, blur, mirror, elastic,
perspective, crop next to the center) draw from ``jax.random`` streams
that cannot be reproduced; they raise until ROADMAP item 6 ports them.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F


def pad_to_size(x: np.ndarray, size: int) -> np.ndarray:
    """Zero-pad the trailing H/W dims up to (size, size), centered; never
    crops."""
    h, w = x.shape[-2], x.shape[-1]
    ph = max(0, size - h)
    pw = max(0, size - w)
    pads = [(0, 0)] * (x.ndim - 2) + [(ph // 2, ph - ph // 2),
                                      (pw // 2, pw - pw // 2)]
    if ph == 0 and pw == 0:
        return x
    return np.pad(x, pads, mode="constant")


def center_crop(x: torch.Tensor, size: int) -> torch.Tensor:
    """Center crop of the trailing H, W dims of [..., H, W]."""
    h, w = x.shape[-2], x.shape[-1]
    if h < size or w < size:
        raise ValueError(f"center_crop: size {size} exceeds spatial dims "
                         f"({h}, {w}) — pad first (pad_to_size)")
    top = (h - size) // 2
    left = (w - size) // 2
    return x[..., top:top + size, left:left + size]


def _pad_batch_to_at_least(x: torch.Tensor, size: int) -> torch.Tensor:
    """Centered zero pad of [B, C, H, W] so that H, W >= size."""
    h, w = x.shape[-2], x.shape[-1]
    ph, pw = max(0, size - h), max(0, size - w)
    if ph == 0 and pw == 0:
        return x
    return F.pad(x, (pw // 2, pw - pw // 2, ph // 2, ph - ph // 2))


@dataclasses.dataclass(frozen=True)
class AugmentConfig:
    """The JAX package's augmentation switches (same fields and
    defaults); the port runs only configs whose switches are off."""

    patch_size: int
    aug_patch_size: Optional[int] = None
    random_crop: bool = True
    rot90: bool = True
    intensity: bool = True
    rotate_any: bool = False
    max_degree: int = 45
    noise: bool = False
    blur: bool = False
    mirror: bool = False
    elastic: bool = False
    elastic_alpha: float = 10.0
    crop_next_to_center: bool = False
    max_translation: int = 35
    perspective: bool = False


def _random_ops(cfg: AugmentConfig, need_crop: bool) -> list:
    """The random ops that ``cfg`` would run on a batch."""
    ops = [name for name in ("rot90", "intensity", "noise", "blur",
                             "mirror", "elastic", "perspective")
           if getattr(cfg, name)]
    if cfg.rotate_any and cfg.max_degree > 0:
        ops.append("rotate_any")
    if need_crop and cfg.crop_next_to_center:
        ops.append("crop_next_to_center")
    elif need_crop and cfg.random_crop:
        ops.append("random_crop")
    return ops


def augment_batch(triplet: torch.Tensor, cfg: AugmentConfig) -> torch.Tensor:
    """[B, kC, H, W] → [B, kC, p, p] with the deterministic recipe:
    pad to ``aug_patch_size`` and center crop to it, then pad and
    center crop to ``patch_size``. Raises NotImplementedError when
    ``cfg`` asks for a random op that would run."""
    x = triplet
    if cfg.aug_patch_size is not None:
        ap = cfg.aug_patch_size
        x = _pad_batch_to_at_least(x, ap)
        if x.shape[-2] > ap or x.shape[-1] > ap:
            x = center_crop(x, ap)
    x = _pad_batch_to_at_least(x, cfg.patch_size)
    p = cfg.patch_size
    need_crop = x.shape[-2] > p or x.shape[-1] > p
    ops = _random_ops(cfg, need_crop)
    if ops:
        raise NotImplementedError(
            f"random augmentation {ops} is not ported yet (ROADMAP item "
            f"6); set the switches off for the deterministic recipe")
    return center_crop(x, p) if need_crop else x


def _split(x: torch.Tensor, slots: int):
    """Channel slots of [B, slots*C, H, W], each [B, C, H, W]."""
    if x.shape[1] % slots != 0:
        raise ValueError(
            f"expected {slots}C channels (one C-channel slot per slice), "
            f"got {x.shape[1]}")
    return torch.chunk(x, slots, dim=1)


def prepare_batch_pairs(triplet: torch.Tensor):
    """[B, 3C, H, W] (from | to | between) → (image [2B, C, H, W] =
    from ∥ to, slice_between [B, C, H, W])."""
    a, b, between = _split(triplet, 3)
    return torch.cat([a, b]), between


def prepare_batch_quintets(quintet: torch.Tensor):
    """[B, 5C, H, W] (from | to | outer_from | outer_to | between) →
    (image [2B], outer [2B], slice_between [B])."""
    a, b, oa, ob, between = _split(quintet, 5)
    return torch.cat([a, b]), torch.cat([oa, ob]), between


def prepare_batch_septets(septet: torch.Tensor):
    """[B, 7C, H, W] (from | to | outer_from | outer_to | outer2_from |
    outer2_to | between) → (image [2B], outer [2B], outer2 [2B],
    slice_between [B])."""
    a, b, oa, ob, o2a, o2b, between = _split(septet, 7)
    return (torch.cat([a, b]), torch.cat([oa, ob]), torch.cat([o2a, o2b]),
            between)


def device_batch(raw: Dict[str, np.ndarray], cfg: AugmentConfig,
                 device, latent_taps: int = 2) -> Dict[str, torch.Tensor]:
    """A sampler batch (``TripletSampler``: ``triplet`` [B, H, W, kC]) as
    the train step's NCHW batch on ``device``: upload, augment, split
    into ``image`` / ``slice_between`` (+ ``outer`` / ``outer2`` for 4 /
    6 latent taps), with ``alpha_from``, ``alpha_to``, ``is_inbetween``."""
    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    x = augment_batch(put(raw["triplet"]).permute(0, 3, 1, 2), cfg)
    batch = {}
    if latent_taps == 6:
        (batch["image"], batch["outer"], batch["outer2"],
         batch["slice_between"]) = prepare_batch_septets(x)
    elif latent_taps == 4:
        (batch["image"], batch["outer"],
         batch["slice_between"]) = prepare_batch_quintets(x)
    else:
        batch["image"], batch["slice_between"] = prepare_batch_pairs(x)
    batch = {k: v.contiguous() for k, v in batch.items()}
    for key in ("alpha_from", "alpha_to", "is_inbetween"):
        if key in raw:
            batch[key] = put(raw[key])
    return batch
