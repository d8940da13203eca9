"""Latent mixing and the tap-weight kernels of the multi-tap schemes.

Port of ``superresolution_aniso_mri_tpu/ops/losses.py:48-100``
(``latent_mix``, ``catmull_rom_weights``, ``LANCZOS3_OFFSETS``,
``lanczos3_weights``). Weights are computed in the dtype of ``t``
(float32 at every caller).
"""
from __future__ import annotations

import math

import torch


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
