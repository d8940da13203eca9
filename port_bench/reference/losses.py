"""The ``ae_combined`` losses: MSE, the Laplacian-pyramid L1 and the
weighted synthesis loss.

The pyramid (Burt and Adelson; the reference repository's
``lap_pyramid_loss``): 3 levels; each blurs with the separable 5-tap
binomial (1, 4, 6, 4, 1) / 16 over a reflect-padded image (a 5x1 then a
1x5 depthwise convolution), keeps every second row and column, and
upsamples back by placing the samples on the even positions of a zero
grid and blurring with 4x the kernel; a level's band is the image minus
that upsample (cropped to the image), and the next level starts from the
decimated image. The loss sums, over the levels, the mean absolute
difference of the two pyramids.
"""
from __future__ import annotations

from typing import List, Optional

import torch
import torch.nn.functional as F

from .precision import operands

_BINOMIAL = (1.0, 4.0, 6.0, 4.0, 1.0)
LEVELS = 3


def mse(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return ((a - b) ** 2).mean()


def _blur(x: torch.Tensor, mode: str, gain: float = 1.0) -> torch.Tensor:
    c = x.shape[1]
    k = torch.tensor(_BINOMIAL, dtype=x.dtype, device=x.device) / 16.0
    x = F.pad(x, (2, 2, 2, 2), mode="reflect")
    for shape in ((1, 1, 5, 1), (1, 1, 1, 5)):
        xi, w = operands(mode, x.device, x, k.view(shape).repeat(c, 1, 1, 1))
        x = F.conv2d(xi, w, groups=c)
    return x * gain


def pyramid(img: torch.Tensor, mode: str = "float32") -> List[torch.Tensor]:
    cur, bands = img, []
    for _ in range(LEVELS):
        down = _blur(cur, mode)[:, :, ::2, ::2]
        n, c, h, w = down.shape
        up = down.new_zeros(n, c, h, 2, w, 2)
        up[:, :, :, 0, :, 0] = down
        up = _blur(up.reshape(n, c, 2 * h, 2 * w), mode, 4.0)
        bands.append(cur - up[:, :, :cur.shape[2], :cur.shape[3]])
        cur = down
    return bands


def lap_loss(pred: torch.Tensor, target: torch.Tensor,
             mode: str = "float32") -> torch.Tensor:
    return sum((a - b).abs().mean()
               for a, b in zip(pyramid(pred, mode), pyramid(target, mode)))


def lap_loss_per_sample(pred: torch.Tensor, target: torch.Tensor,
                        mode: str = "float32") -> torch.Tensor:
    return sum((a - b).abs().mean(dim=(1, 2, 3))
               for a, b in zip(pyramid(pred, mode), pyramid(target, mode)))


def weighted(per_sample: torch.Tensor,
             weight: Optional[torch.Tensor]) -> torch.Tensor:
    """The mean of ``per_sample`` weighted by ``weight`` (over at least
    one unit of weight); the plain mean without weights."""
    if weight is None:
        return per_sample.mean()
    return (per_sample * weight).sum() / weight.sum().clamp_min(1.0)
