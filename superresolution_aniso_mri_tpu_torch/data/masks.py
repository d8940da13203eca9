"""Loss-mask generation from cardiac segmentations (``--get_masks``).

A numpy + scipy copy of ``superresolution_aniso_mri_tpu/data/masks.py``
(reference: datasets/ACDC/data4d_simple.py:454-502 get_4d_acdc_masks):
dilated binary masks of the RV/MYO/LV structures, used as elementwise
loss masks.
"""
from __future__ import annotations

import numpy as np
import scipy.ndimage


def make_loss_mask(labels: np.ndarray, dilation_iters: int = 5,
                   include_labels=(1, 2, 3)) -> np.ndarray:
    """Binary foreground mask dilated by ``dilation_iters`` voxels
    (reference masks are "Dilated 5 times", data4d_simple.py:458).

    ``labels``: integer map [..., H, W] (ACDC: 1=RV, 2=MYO, 3=LV).
    Returns float32 mask of the same shape (2-D dilation per slice);
    ``dilation_iters=0`` means no dilation (scipy's iterations<=0 would
    dilate until convergence — the whole slice).
    """
    fg = np.isin(labels, include_labels)
    if dilation_iters <= 0:
        return fg.astype(np.float32)
    if fg.ndim == 2:
        mask = scipy.ndimage.binary_dilation(fg, iterations=dilation_iters)
        return mask.astype(np.float32)
    out = np.zeros_like(fg, dtype=np.float32)
    flat = fg.reshape(-1, fg.shape[-2], fg.shape[-1])
    out_flat = out.reshape(flat.shape)
    for i in range(flat.shape[0]):
        if flat[i].any():
            out_flat[i] = scipy.ndimage.binary_dilation(
                flat[i], iterations=dilation_iters)
    return out


def masks_for_volume(labels3d: np.ndarray, dilation_iters: int = 5,
                     include_labels=(1, 2, 3)) -> np.ndarray:
    """Per-slice loss masks for a [S, H, W] label volume; slices without
    any INCLUDED structure get an all-ones mask (no loss suppression),
    matching the reference's behaviour for unlabeled slices. The empty
    test must use the included-foreground mask, not labels.any() — a
    slice carrying only excluded labels would otherwise keep an all-zero
    mask and silently suppress its entire loss."""
    masks = make_loss_mask(labels3d, dilation_iters,
                           include_labels=include_labels)
    fg = np.isin(labels3d, include_labels)
    empty = ~fg.reshape(labels3d.shape[0], -1).any(axis=1)
    masks[empty] = 1.0
    return masks
