"""Patch-tiled reconstruction and interpolation.

Port of ``superresolution_aniso_mri_tpu/infer/patches.py``: a volume is
cut into non-overlapping patches by a reshape and a permute, every patch
of every slice goes through the model in one batch, and the inverse
reshape puts them back. The trainer is an eval-mode ``train.Trainer``
(its ``encode`` / ``decode`` / ``predict``); a model with more input
channels than the image plane gets zeros for the rest, with a warning.
"""
from __future__ import annotations

import warnings

import numpy as np
import torch


def extract_patches(volume: torch.Tensor, patch: int) -> torch.Tensor:
    """[S, H, W] → [S * (H // p) * (W // p), 1, p, p]; H and W must be
    multiples of ``patch`` (a silent crop would return a smaller volume
    than the input)."""
    s, h, w = volume.shape
    if h % patch or w % patch:
        raise ValueError(
            f"spatial dims ({h}, {w}) must be multiples of patch "
            f"{patch} — pad the volume first (data.pad_to_size)")
    gh, gw = h // patch, w // patch
    x = volume.reshape(s, gh, patch, gw, patch).permute(0, 1, 3, 2, 4)
    return x.reshape(s * gh * gw, 1, patch, patch)


def assemble_patches(patches: torch.Tensor, s: int, h: int, w: int,
                     patch: int) -> torch.Tensor:
    """The inverse of ``extract_patches`` for [N, p, p] patches →
    [S, gh * p, gw * p]."""
    gh, gw = h // patch, w // patch
    x = patches.reshape(s, gh, gw, patch, patch).permute(0, 1, 3, 2, 4)
    return x.reshape(s, gh * patch, gw * patch)


def _widen_tiles(trainer, tiles: torch.Tensor) -> torch.Tensor:
    """``tiles`` [N, 1, p, p] with zero planes up to the model's input
    channels (the label plane of the ACDCLBL models), as the volume
    pipeline does when no labels are given."""
    colors = int(getattr(getattr(trainer, "model_config", None),
                         "colors", 1) or 1)
    if colors <= tiles.shape[1]:
        return tiles
    warnings.warn(
        f"patch helpers: model expects {colors} input channels but only "
        f"the image plane is available — feeding zeros for the rest "
        f"(same fallback as create_super_volume without labels)")
    pad = tiles.new_zeros((tiles.shape[0], colors - tiles.shape[1])
                          + tuple(tiles.shape[2:]))
    return torch.cat([tiles, pad], dim=1)


def _image_plane(out) -> torch.Tensor:
    """The image of a decode (MultiChannelAE decodes to ``{"image",
    "soft_probs"}``)."""
    return out["image"] if isinstance(out, dict) else out


def reconstruct_in_patches(trainer, volume, patch: int = 32) -> np.ndarray:
    """A [S, H, W] volume reconstructed through the autoencoder in
    ``patch``² tiles (e.g. smaller than it was trained on); the tiles
    move to the trainer's device in ``predict``."""
    volume = torch.as_tensor(volume, dtype=torch.float32)
    s, h, w = volume.shape
    tiles = _widen_tiles(trainer, extract_patches(volume, patch))
    recon = _image_plane(trainer.predict(tiles))
    return assemble_patches(recon[:, 0], s, h, w, patch).cpu().numpy()


def interpolate_in_patches(trainer, img1, img2, alpha: float,
                           patch: int = 32) -> np.ndarray:
    """Latent interpolation of one [H, W] slice pair in ``patch``²
    tiles, through the SR model when one is loaded (else the
    autoencoder). ``alpha`` weights ``img1``, as ``latent_space_interp``
    does (the reference's helper weights ``img2``: sweep ``1 - alpha``
    to reproduce it)."""
    a = torch.as_tensor(img1, dtype=torch.float32)[None]
    b = torch.as_tensor(img2, dtype=torch.float32)[None]
    h, w = a.shape[1:3]
    pa = _widen_tiles(trainer, extract_patches(a, patch))
    pb = _widen_tiles(trainer, extract_patches(b, patch))
    z = (alpha * trainer.encode(pa, use_sr_model=True)
         + (1.0 - alpha) * trainer.encode(pb, use_sr_model=True))
    dec = _image_plane(trainer.decode(z, use_sr_model=True))
    return assemble_patches(dec[:, 0], 1, h, w, patch)[0].cpu().numpy()
