"""Soft Dice loss of the multi-channel (image + labels) model, NCHW.

Port of ``superresolution_aniso_mri_tpu/ops/dice.py`` (reference:
kwatsch/dice_loss.py:4-30). Classes live on dim 1 and the sums run over
the spatial dims (2, 3), per (batch, class).
"""
from __future__ import annotations

import torch

from ..parallel.distributed import global_mean


def soft_dice_score(probs: torch.Tensor, one_hot: torch.Tensor,
                    eps: float = 1.0e-6) -> torch.Tensor:
    """Negative mean per-(batch, class) soft Dice of ``[B, C, H, W]``
    probabilities against a ``[B, C, H, W]`` one-hot target (the mean
    over every rank's batch in a sharded train step)."""
    nominator = 2.0 * (one_hot * probs).sum(dim=(2, 3))
    denominator = one_hot.sum(dim=(2, 3)) + probs.sum(dim=(2, 3)) + eps
    return -global_mean(nominator / denominator)


def one_hot(labels: torch.Tensor, n_classes: int,
            dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``[B, H, W]`` integer maps → ``[B, n_classes, H, W]`` one-hot, with
    all-zero columns for ids outside ``[0, n_classes)`` (as
    ``jax.nn.one_hot``). A comparison against the class ids, so it reads
    nothing back to the host and a CUDA graph can capture it (torch's
    ``one_hot`` checks the range on the host)."""
    ids = torch.arange(n_classes, device=labels.device, dtype=labels.dtype)
    return (labels[:, None] == ids.view(1, -1, 1, 1)).to(dtype)


def dice_loss(probs: torch.Tensor, labels: torch.Tensor,
              n_classes: int) -> torch.Tensor:
    """Soft Dice of ``[B, C, H, W]`` probabilities against ``[B, H, W]``
    integer ``labels``."""
    return soft_dice_score(probs, one_hot(labels, n_classes, probs.dtype))
