"""Laplacian-pyramid L1 loss, NCHW.

Port of ``superresolution_aniso_mri_tpu/ops/lap_pyramid.py``: 3 levels
built with the separable 5-tap binomial (/16 per axis), reflect padding,
stride-2 decimation and a zero-stuffed upsample blurred with gain 4; the
loss sums the per-level mean |difference|.
"""
from __future__ import annotations

from typing import List

import torch
import torch.nn.functional as F

_K1D = (1.0, 4.0, 6.0, 4.0, 1.0)


def _blur(x: torch.Tensor, gain: float = 1.0) -> torch.Tensor:
    """Depthwise 5x5 binomial blur with reflect padding, as a 5x1 then a
    1x5 convolution."""
    c = x.shape[1]
    k = torch.tensor(_K1D, dtype=x.dtype, device=x.device) / 16.0
    x = F.pad(x, (2, 2, 2, 2), mode="reflect")
    x = F.conv2d(x, k.view(1, 1, 5, 1).repeat(c, 1, 1, 1), groups=c)
    x = F.conv2d(x, k.view(1, 1, 1, 5).repeat(c, 1, 1, 1), groups=c)
    return x * gain


def _upsample_zero_stuff(x: torch.Tensor) -> torch.Tensor:
    """Samples at the even positions of a 2x grid, zeros between, then
    the blur with 4x the kernel."""
    n, c, h, w = x.shape
    up = x.new_zeros(n, c, h, 2, w, 2)
    up[:, :, :, 0, :, 0] = x
    return _blur(up.reshape(n, c, 2 * h, 2 * w), gain=4.0)


def laplacian_pyramid(img: torch.Tensor,
                      max_levels: int = 3) -> List[torch.Tensor]:
    """Band-pass residuals of ``img`` [N, C, H, W], finest first."""
    current = img
    pyr = []
    for _ in range(max_levels):
        down = _blur(current)[:, :, ::2, ::2]
        # odd sizes upsample to one more row/column: crop back
        up = _upsample_zero_stuff(down)[:, :, :current.shape[2],
                                        :current.shape[3]]
        pyr.append(current - up)
        current = down
    return pyr


def lap_loss(pred: torch.Tensor, target: torch.Tensor,
             max_levels: int = 3) -> torch.Tensor:
    """Sum over levels of the mean |pyramid difference|."""
    pairs = zip(laplacian_pyramid(pred, max_levels),
                laplacian_pyramid(target, max_levels))
    return sum((a - b).abs().mean() for a, b in pairs)


def lap_loss_per_sample(pred: torch.Tensor, target: torch.Tensor,
                        max_levels: int = 3) -> torch.Tensor:
    """[N] losses: ``lap_loss`` of each sample on its own."""
    pairs = zip(laplacian_pyramid(pred, max_levels),
                laplacian_pyramid(target, max_levels))
    return sum((a - b).abs().mean(dim=(1, 2, 3)) for a, b in pairs)
