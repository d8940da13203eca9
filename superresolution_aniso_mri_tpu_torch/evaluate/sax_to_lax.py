"""Reslice SR short-axis volumes into long-axis views (grid sampling).

Port of ``superresolution_aniso_mri_tpu/evaluate/sax_to_lax.py``
(reference: evaluate/cardiac/resample_sax_to_lax.py:8-80): build a
homogeneous world grid for the LAX geometry, map it through the SAX
inverse affine, normalise to [-1, 1] and sample trilinearly. The grid
helpers are numpy, copied; ``grid_sample_3d`` is the JAX package's own
gather formula (align_corners=True, zeros outside) as torch ops, in the
same float32 operations and order, so it lands where JAX's lands.
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device


def make_identity_grid(shape) -> np.ndarray:
    """[z, y, x] shape → grid of (x, y, z) coords, stacked last
    (reference: resample_sax_to_lax.py:44-59)."""
    coords = [np.arange(s, dtype=np.float32) for s in shape]
    grids = np.meshgrid(*coords, indexing="ij")
    return np.stack(grids[::-1], axis=-1)


def make_lax_identity_grid(target_shape) -> np.ndarray:
    """Identity grid with homogeneous coordinate appended
    (reference: resample_sax_to_lax.py:62-68)."""
    grid = make_identity_grid(target_shape)
    ones = np.ones(grid.shape[:-1] + (1,), np.float32)
    return np.concatenate([grid, ones], axis=-1)


def make_transform(ident_grid: np.ndarray, lax_shape, sax_shape,
                   tr_S_lax, tr_R_lax, tr_T_lax,
                   tr_S_sax, tr_R_sax, tr_T_sax) -> np.ndarray:
    """LAX voxel grid → normalised SAX sampling coords in [-1, 1]
    (reference: resample_sax_to_lax.py:26-41)."""
    flat = ident_grid.reshape(lax_shape[0], -1, 4)
    world = flat @ tr_S_lax.T @ tr_R_lax.T @ tr_T_lax.T
    sax = world @ np.linalg.inv(tr_T_sax).T @ np.linalg.inv(tr_R_sax).T \
        @ np.linalg.inv(tr_S_sax).T
    denom = (np.r_[np.asarray(sax_shape)[::-1], 2].astype(np.float32)
             [None, None] - 1) / 2
    # a singleton SAX axis has (size-1)/2 == 0; align_corners=True maps
    # its only slice to coordinate 0, so the normalised coordinate is
    # identically 0 (not inf/nan)
    safe = np.where(denom == 0.0, 1.0, denom)
    scaled = np.where(denom == 0.0, 0.0, sax / safe - 1.0)
    scaled = scaled.reshape(tuple(lax_shape) + (4,))
    return scaled[..., :3]


def grid_sample_3d(volume: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """Trilinear sampling of a [D, H, W] float32 volume at normalised
    (x, y, z) coords ``grid`` [..., 3] in [-1, 1] (align_corners=True,
    zeros outside: a corner off the volume, such as ``x0 + 1`` at
    exactly +1, weighs in as 0), on the volume's device."""
    d, h, w = volume.shape
    x = (grid[..., 0] + 1.0) * (w - 1) / 2.0
    y = (grid[..., 1] + 1.0) * (h - 1) / 2.0
    z = (grid[..., 2] + 1.0) * (d - 1) / 2.0
    x0, y0, z0 = torch.floor(x), torch.floor(y), torch.floor(z)
    dx, dy, dz = x - x0, y - y0, z - z0
    flat = volume.reshape(-1)
    zero = flat.new_zeros(())

    def gather(zi, yi, xi):
        valid = ((zi >= 0) & (zi < d) & (yi >= 0) & (yi < h)
                 & (xi >= 0) & (xi < w))
        zc = zi.clamp(0, d - 1).to(torch.int64)
        yc = yi.clamp(0, h - 1).to(torch.int64)
        xc = xi.clamp(0, w - 1).to(torch.int64)
        return torch.where(valid, flat[(zc * h + yc) * w + xc], zero)

    acc = 0.0
    for oz, wz in ((z0, 1 - dz), (z0 + 1, dz)):
        for oy, wy in ((y0, 1 - dy), (y0 + 1, dy)):
            for ox, wx in ((x0, 1 - dx), (x0 + 1, dx)):
                acc = acc + wz * wy * wx * gather(oz, oy, ox)
    return acc


@torch.inference_mode()
def resample_sax_to_lax(sax_4d: np.ndarray, target_shape,
                        transformed_ident_grid: np.ndarray,
                        device=None) -> np.ndarray:
    """Resample every frame of a [t, z, y, x] SAX volume onto the LAX
    grid (reference: resample_sax_to_lax.py:8-24) on ``device`` (None:
    the CUDA device); returns float32 numpy of ``target_shape``."""
    assert len(target_shape) == 4
    if sax_4d.shape[0] != target_shape[0]:
        raise ValueError(
            f"frame-count mismatch: SAX has {sax_4d.shape[0]} frames, "
            f"target_shape asks for {target_shape[0]} — align the cines "
            f"first (silent zero-fill would be scored as real data)")
    dev = resolve_device(device)
    grid = torch.from_numpy(np.ascontiguousarray(
        transformed_ident_grid, np.float32)).to(dev)
    out = np.zeros(target_shape, np.float32)
    for t in range(sax_4d.shape[0]):
        frame = torch.from_numpy(np.ascontiguousarray(
            sax_4d[t], np.float32)).to(dev)
        out[t] = grid_sample_3d(frame, grid).cpu().numpy()
    return out
