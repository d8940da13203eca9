"""Image-grid construction + PNG save for train/val previews.

Port of ``superresolution_aniso_mri_tpu/utils/grids.py`` (reference:
kwatsch/acai_utils.py:26-39 generate_recon_grid,
kwatsch/training_utils.py:9-26 save_image_grid / batch compare grid,
evaluate/evaluate_image.py:82-107 create_compare_image). The grids are
the JAX package's numpy code; the PNG is written here with ``zlib`` and
``struct`` (8-bit grayscale, filter type 0) instead of PIL, which the
port does not depend on.
"""
from __future__ import annotations

import os
import struct
import zlib

import numpy as np


def make_grid(images: np.ndarray, nrow: int = 8, pad: int = 2,
              pad_value: float = 0.0) -> np.ndarray:
    """[N, H, W] (or [N, H, W, 1]) → single [GH, GW] grid image."""
    imgs = np.asarray(images)
    if imgs.ndim == 4:
        imgs = imgs[..., 0]
    n, h, w = imgs.shape
    if n == 0:
        raise ValueError("make_grid: empty image stack")
    ncol = min(nrow, n)
    nrows = int(np.ceil(n / ncol))
    grid = np.full((nrows * (h + pad) + pad, ncol * (w + pad) + pad),
                   pad_value, np.float32)
    for i in range(n):
        r, c = divmod(i, ncol)
        top = r * (h + pad) + pad
        left = c * (w + pad) + pad
        grid[top:top + h, left:left + w] = imgs[i]
    return grid


def generate_recon_grid(originals: np.ndarray, recons: np.ndarray,
                        max_items: int = 8) -> np.ndarray:
    """Two-row compare grid: originals on top, reconstructions below
    (reference: acai_utils.py:26-39)."""
    o = np.asarray(originals)[:max_items]
    r = np.asarray(recons)[:max_items]
    if o.ndim == 4:
        o = o[..., 0]
    if r.ndim == 4:
        r = r[..., 0]
    return make_grid(np.concatenate([o, r], axis=0), nrow=len(o))


def generate_batch_compare_grid(image: np.ndarray, between: np.ndarray,
                                synthesized: np.ndarray,
                                reconstruction: np.ndarray,
                                max_items: int = 6) -> np.ndarray:
    """Rows: slice_from, slice_to, true between, synthesized between,
    reconstruction (reference: training_utils.py:16-26). ``image`` is
    the (2B ∥ B) layout [from ∥ to]: the to-slices are those of the
    same first items, ``image[half:half + b]``."""
    b = min(max_items, between.shape[0])
    image = np.asarray(image)
    half = image.shape[0] // 2
    rows = [image[:b], image[half:half + b],
            np.asarray(between)[:b], np.asarray(synthesized)[:b],
            np.asarray(reconstruction)[:b]]
    rows = [r[..., 0] if r.ndim == 4 else r for r in rows]
    return make_grid(np.concatenate(rows, axis=0), nrow=b)


def create_compare_image(orig_slices: np.ndarray,
                         synth_slices: np.ndarray,
                         num_cols: int = 7) -> np.ndarray:
    """Original-vs-synthesized volume preview grid
    (reference: evaluate/evaluate_image.py:82-107)."""
    o = np.asarray(orig_slices)
    s = np.asarray(synth_slices)
    if o.ndim == 4:
        o = o[..., 0]
    if s.ndim == 4:
        s = s[..., 0]
    n = min(num_cols, o.shape[0], s.shape[0])
    sel = np.linspace(0, min(o.shape[0], s.shape[0]) - 1, n).astype(int)
    return make_grid(np.concatenate([o[sel], s[sel]], axis=0), nrow=n)


def _png_chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def encode_png_gray8(pixels: np.ndarray) -> bytes:
    """An [H, W] uint8 array as an 8-bit grayscale PNG: IHDR, one IDAT of
    the zlib-compressed rows (each with filter byte 0), IEND."""
    pixels = np.ascontiguousarray(pixels, np.uint8)
    if pixels.ndim != 2:
        raise ValueError(f"encode_png_gray8 takes [H, W], got "
                         f"{pixels.shape}")
    h, w = pixels.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8), pixels], axis=1)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + _png_chunk(b"IHDR", ihdr)
            + _png_chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + _png_chunk(b"IEND", b""))


def save_image_grid(grid: np.ndarray, filename: str) -> None:
    """Save a [H, W] float grid (0..1 or 0..255) as PNG
    (reference: training_utils.py:9-14)."""
    was_integer = np.issubdtype(np.asarray(grid).dtype, np.integer)
    g = np.asarray(grid, np.float32)
    # [0,1]-ish FLOAT grids (allowing slight sigmoid-free overshoot)
    # scale to 0..255; a hard max<=1.0 gate turned a single 1.02 pixel
    # into an all-black PNG. Integer grids are already 0..255 — the
    # heuristic must not blow a near-black uint8 image up to white.
    if not was_integer and g.max() <= 2.0:
        g = np.clip(g, 0.0, 1.0) * 255.0
    data = encode_png_gray8(np.clip(g, 0, 255).astype(np.uint8))
    os.makedirs(os.path.dirname(filename) or ".", exist_ok=True)
    with open(filename, "wb") as f:
        f.write(data)
