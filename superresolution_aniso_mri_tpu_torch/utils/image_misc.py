"""Misc image utilities: mosaics, pixelation, DICOM→NIfTI (gated).

A numpy copy of ``superresolution_aniso_mri_tpu/utils/image_misc.py``.

Reference: kwatsch/kylemcdonald_img_utils.py (mosaic helpers),
kwatsch/pixelated.py (block pixelation),
kwatsch/create_nifti_from_dicom.py:13-284 (DICOM series → NIfTI; needs
pydicom, which is gated here since it is not bundled).
"""
from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np


def find_rectangle(n: int):
    """Smallest (rows, cols) rectangle holding n tiles."""
    cols = int(np.ceil(np.sqrt(n)))
    rows = int(np.ceil(n / cols))
    return rows, cols


def make_mosaic(images: np.ndarray, nx: Optional[int] = None,
                ny: Optional[int] = None) -> np.ndarray:
    """[N, H, W] → mosaic [ny*H, nx*W], row-major, zero-filled tail."""
    imgs = np.asarray(images)
    n, h, w = imgs.shape
    if nx is None and ny is None:
        ny, nx = find_rectangle(n)
    elif nx is None:
        nx = int(np.ceil(n / ny))
    elif ny is None:
        ny = int(np.ceil(n / nx))
    out = np.zeros((ny * h, nx * w), imgs.dtype)
    for i in range(min(n, nx * ny)):
        r, c = divmod(i, nx)
        out[r * h:(r + 1) * h, c * w:(c + 1) * w] = imgs[i]
    return out


def unmake_mosaic(mosaic: np.ndarray, h: int, w: int) -> np.ndarray:
    """Inverse of make_mosaic for tiles of shape (h, w)."""
    ny = mosaic.shape[0] // h
    nx = mosaic.shape[1] // w
    tiles = []
    for r in range(ny):
        for c in range(nx):
            tiles.append(mosaic[r * h:(r + 1) * h, c * w:(c + 1) * w])
    return np.stack(tiles)


def pixelate(img: np.ndarray, block: int = 8) -> np.ndarray:
    """Block-average pixelation (reference: kwatsch/pixelated.py)."""
    h, w = img.shape[:2]
    hh = h - h % block
    ww = w - w % block
    x = img[:hh, :ww].reshape(hh // block, block, ww // block, block,
                              *img.shape[2:])
    means = x.mean(axis=(1, 3), keepdims=True)
    out = np.broadcast_to(means, x.shape).reshape(hh, ww, *img.shape[2:])
    full = np.array(img, copy=True)
    full[:hh, :ww] = out
    return full


def dicom_series_to_nifti(dicom_dir: str, output_file: str) -> str:
    """Convert a DICOM series directory into a NIfTI volume
    (reference kwatsch/create_nifti_from_dicom.py:13-284).

    Uses pydicom when importable; otherwise falls back to the built-in
    dependency-free reader (utils/dicom.py — implicit/explicit little
    endian, uncompressed PixelData).
    """
    try:
        import pydicom
    except ImportError:
        from .dicom import read_dicom_series
        from .nifti import write_nifti

        vol, spacing = read_dicom_series(dicom_dir)
        write_nifti(output_file, vol.astype(np.float32), spacing=spacing)
        return output_file

    files = sorted(
        os.path.join(dicom_dir, f) for f in os.listdir(dicom_dir)
        if not f.startswith("."))
    slices = []
    for f in files:
        try:
            ds = pydicom.dcmread(f)
            # hasattr only swallows AttributeError — an undecodable
            # payload (compressed transfer syntax without a handler)
            # raises RuntimeError out of pixel_array and must ALSO skip
            # the file, not abort the conversion
            ds.pixel_array
        except Exception:
            continue
        slices.append(ds)
    if not slices:
        raise ValueError(f"no DICOM images in {dicom_dir}")
    # z-position when available, else InstanceNumber — without a
    # fallback a position-less series would keep lexicographic filename
    # order (1, 10, 11, 2, ...) and scramble the volume
    def _order(d):
        pos = getattr(d, "ImagePositionPatient", None)
        if pos is not None:
            return (0, float(pos[2]))
        return (1, float(getattr(d, "InstanceNumber", 0)))

    slices.sort(key=_order)

    # pydicom does NOT auto-apply rescale; match the built-in reader so
    # both paths emit identical voxel values
    def _rescaled(d):
        arr = d.pixel_array.astype(np.float32)
        slope = float(getattr(d, "RescaleSlope", 1.0) or 1.0)
        inter = float(getattr(d, "RescaleIntercept", 0.0) or 0.0)
        if slope != 1.0 or inter != 0.0:
            arr = arr * slope + inter
        return arr

    vol = np.stack([_rescaled(s) for s in slices])
    ps = [float(v) for v in getattr(slices[0], "PixelSpacing", (1.0, 1.0))]
    try:
        z0 = float(slices[0].ImagePositionPatient[2])
        z1 = float(slices[1].ImagePositionPatient[2])
        dz = abs(z1 - z0)
    except Exception:
        dz = float(getattr(slices[0], "SliceThickness", 1.0))
    from .nifti import write_nifti
    write_nifti(output_file, vol, spacing=np.array([dz, ps[0], ps[1]]))
    return output_file
