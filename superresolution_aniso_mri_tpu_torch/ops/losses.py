"""Elementary losses, latent mixing and the tap-weight kernels of the
multi-tap schemes.

Port of ``superresolution_aniso_mri_tpu/ops/losses.py`` (``mse``,
``latent_mix``, ``catmull_rom_weights``, ``LANCZOS3_OFFSETS``,
``lanczos3_weights``, ``latent_mix_cubic``, ``latent_mix_lanczos3``).
Weights are computed in the dtype of ``t`` (float32 at every caller).
"""
from __future__ import annotations

import math
from typing import Optional

import torch


def mse(pred: torch.Tensor, target: torch.Tensor,
        mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean squared error, optionally times an elementwise loss mask
    (the mean still runs over every element)."""
    d = (pred - target) ** 2
    if mask is not None:
        d = d * mask
    return d.mean()


def latent_mix(z: torch.Tensor, alpha_from, alpha_to) -> torch.Tensor:
    """Mix the two batch halves of ``z`` [2B, ...]:
    ``alpha_from * z[:B] + alpha_to * z[B:]`` with alphas [B] or [B, 1]."""
    b = z.shape[0] // 2
    shape = (b,) + (1,) * (z.ndim - 1)
    a_f = torch.as_tensor(alpha_from, dtype=z.dtype, device=z.device)
    a_t = torch.as_tensor(alpha_to, dtype=z.dtype, device=z.device)
    return a_f.reshape(shape) * z[:b] + a_t.reshape(shape) * z[b:]


def catmull_rom_weights(t: torch.Tensor) -> torch.Tensor:
    """[...] fractional positions → [..., 4] Catmull-Rom weights over
    taps (z[i-1], z[i], z[i+1], z[i+2]) for a sample at t between z[i]
    (t=0) and z[i+1] (t=1)."""
    t2, t3 = t * t, t * t * t
    return 0.5 * torch.stack(
        [-t3 + 2.0 * t2 - t,
         3.0 * t3 - 5.0 * t2 + 2.0,
         -3.0 * t3 + 4.0 * t2 + t,
         t3 - t2], dim=-1)


# tap offsets of the 6-tap lanczos3 scheme, relative to the kept pair
LANCZOS3_OFFSETS = (-2, -1, 0, 1, 2, 3)


def lanczos3_weights(alphas: torch.Tensor) -> torch.Tensor:
    """[...] fractional positions → [..., 6] normalised lanczos (radius
    3) weights over taps at ``LANCZOS3_OFFSETS``; a delta at t=0 / t=1."""
    t = alphas[..., None]
    x = torch.tensor(LANCZOS3_OFFSETS, dtype=t.dtype, device=t.device) - t
    r = 3.0
    px = math.pi * torch.where(x == 0, torch.full_like(x, 1e-12), x)
    w = torch.where(x.abs() < r,
                    r * torch.sin(px) * torch.sin(px / r) / (px * px),
                    torch.zeros_like(x))
    w = torch.where(x == 0, torch.ones_like(w), w)
    return w / w.sum(dim=-1, keepdim=True)


def _tap_weights(weights: torch.Tensor, b: int, ndim: int) -> torch.Tensor:
    """[B, T] tap weights → [B, T, 1, ...] for latents of rank ``ndim``."""
    return weights.reshape((b, weights.shape[-1]) + (1,) * (ndim - 1))


def latent_mix_cubic(z: torch.Tensor, z_outer: torch.Tensor,
                     alpha_to: torch.Tensor) -> torch.Tensor:
    """4-tap Catmull-Rom mix of ``z`` [2B, ...] (from ∥ to) with the
    outward neighbours ``z_outer`` [2B, ...] (outer_from ∥ outer_to) at
    the in-between position ``alpha_to`` [B]; the training twin of
    serving's ``latent_interp='cubic'``."""
    b = z.shape[0] // 2
    w = _tap_weights(catmull_rom_weights(alpha_to.reshape(b)), b, z.ndim)
    return (w[:, 0] * z_outer[:b] + w[:, 1] * z[:b]
            + w[:, 2] * z[b:] + w[:, 3] * z_outer[b:])


def latent_mix_lanczos3(z: torch.Tensor, z_outer: torch.Tensor,
                        z_outer2: torch.Tensor,
                        alpha_to: torch.Tensor) -> torch.Tensor:
    """6-tap lanczos3 mix in the order of ``LANCZOS3_OFFSETS``:
    (outer2_from, outer_from, from, to, outer_to, outer2_to); ``z_outer2``
    holds the neighbours two pair steps out."""
    b = z.shape[0] // 2
    w = _tap_weights(lanczos3_weights(alpha_to.reshape(b)), b, z.ndim)
    return (w[:, 0] * z_outer2[:b] + w[:, 1] * z_outer[:b]
            + w[:, 2] * z[:b] + w[:, 3] * z[b:]
            + w[:, 4] * z_outer[b:] + w[:, 5] * z_outer2[b:])
