"""brainMASI dataset preparation tools.

A numpy/scipy copy of ``superresolution_aniso_mri_tpu/data/masi.py``:
the same crops, splits and written files from the same inputs.

Rebuild of the reference's brainMASI pipeline helpers
(reference: datasets/brainMASI/common.py find_bbox_object/BoundingBox,
datasets/brainMASI/create_cropped_set.py create_cropped_dataset /
create_low_resolution_dataset). Vectorised scipy replaces the per-column
loops; the per-slice convex hull is replaced by a filled binary mask —
axis extents (all the crop uses) are identical for hull and mask.
"""
from __future__ import annotations

import glob
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import scipy.ndimage

from ..utils.nifti import read_image, write_image
from .transforms import pad_to_size


def find_bbox(mask2d: np.ndarray, threshold: float = 0.0,
              padding: int = 0) -> Dict:
    """Bounding box of the nonzero region of a 2-D mask
    (reference: brainMASI/common.py:7-20 find_bbox_object). Returns
    {'slice_y', 'slice_x', 'box_four' [y0, x0, y1, x1], 'empty'}."""
    binary = np.asarray(mask2d) > threshold
    if np.count_nonzero(binary):
        h, w = binary.shape
        sy, sx = scipy.ndimage.find_objects(binary.astype(np.int8))[0]
        # clamp the padded window inside the array: a negative start
        # would wrap the slice and silently crop an empty region
        sy = slice(max(sy.start - padding, 0), min(sy.stop + padding, h))
        sx = slice(max(sx.start - padding, 0), min(sx.stop + padding, w))
        empty = (sy.stop - sy.start == 0) or (sx.stop - sx.start == 0)
    else:
        sy, sx, empty = slice(0, 0), slice(0, 0), True
    return {"slice_y": sy, "slice_x": sx, "empty": empty,
            "box_four": np.array([sy.start, sx.start, sy.stop, sx.stop])}


def mask_axis_extent(mask: np.ndarray, axis: int) -> Tuple[int, int]:
    """(min, max) nonzero coordinate along ``axis``
    (reference: create_cropped_set.py:15-18 determine_mask_for_axis)."""
    nz = np.nonzero(mask != 0)
    return int(nz[axis].min()), int(nz[axis].max())


def foreground_mask(ref_labels: np.ndarray) -> np.ndarray:
    """Foreground mask of a label volume (reference:
    create_cropped_set.py:30-39 get_foreground_mask uses a per-slice
    convex hull; crop_to_brain only consumes axis min/max extents, which
    neither hull nor hole-filling can change, so the raw nonzero mask is
    extent-identical and avoids a per-slice scipy loop)."""
    return (np.asarray(ref_labels) != 0).astype(np.int32)


def crop_to_brain(img: np.ndarray, ref_labels: np.ndarray,
                  patch_size: int = 256) -> np.ndarray:
    """Crop a raw brainMASI volume to the labelled brain region, reorient
    axial-first, pad in-plane to ``patch_size``
    (reference: create_cropped_set.py:69-101: extents per axis with the
    half-gap relaxation on axes 0/2, transpose (1, 0, 2), flip axis 0,
    pad to 256)."""
    img = np.asarray(img, np.float32)
    mask = foreground_mask(ref_labels)
    ax0, ax1, ax2 = img.shape
    # extents are inclusive indices → +1 for exclusive slice stops
    lo1, hi1 = mask_axis_extent(mask, 1)
    hi1 += 1
    lo0, hi0 = mask_axis_extent(mask, 0)
    hi0 += 1
    if ax0 - hi0 != 0:
        hi0 += int((ax0 - hi0) * 0.5)
    if lo0 != 0:
        lo0 -= int(lo0 * 0.5)
    lo2, hi2 = mask_axis_extent(mask, 2)
    hi2 += 1
    if ax2 - hi2 != 0:
        hi2 += int((ax2 - hi2) * 0.5)
    if lo2 != 0:
        lo2 -= int(lo2 * 0.5)
    img = img[lo0:hi0, lo1:hi1, lo2:hi2]
    img = np.transpose(img, (1, 0, 2))
    img = np.flip(img, axis=0)
    return pad_to_size(img, patch_size)


def masi_train_test_split(patient_ids: Sequence[int], n_train: int = 15,
                          seed: int = 1234) -> Tuple[np.ndarray, np.ndarray]:
    """Seeded shuffle split, 15 train / rest test
    (reference: create_cropped_set.py:42-46)."""
    ids = np.array(sorted(patient_ids))
    np.random.RandomState(seed).shuffle(ids)
    return ids[:n_train], ids[n_train:]


def create_masi_cropped_dataset(src_path: str, out_path: str,
                                limited_load: bool = False,
                                patch_size: int = 256) -> List[str]:
    """Crop every raw MASI volume to the brain bbox of its 6-class manual
    reference and write train/test splits
    (reference: create_cropped_set.py:49-107). Layout:
    ``<src>/images/<id>.nii`` + ``<src>/manual_references/6classes/
    <id>.mhd`` → ``<out>/{training,test}/images/<id>.nii``."""
    files = sorted(glob.glob(os.path.join(src_path, "images", "*.nii*")))
    if limited_load:
        files = files[:2]
    ids = [int(os.path.basename(f).split(".")[0]) for f in files]
    train_ids, _ = masi_train_test_split(ids)
    written = []
    for fname, pid in zip(files, ids):
        img, spacing, _ = read_image(fname)
        base = os.path.basename(fname)
        stem = base.replace(".nii.gz", "").replace(".nii", "")
        ref_dir = os.path.join(src_path, "manual_references", "6classes")
        for ext in (".mhd", ".mha", ".nii.gz", ".nii"):
            ref_name = os.path.join(ref_dir, stem + ext)
            if os.path.isfile(ref_name):
                break
        else:
            raise FileNotFoundError(
                f"no manual reference for {base} under {ref_dir}")
        ref, _, _ = read_image(ref_name)
        cropped = crop_to_brain(np.asarray(img, np.float32),
                                np.asarray(ref, np.int32), patch_size)
        sub = "training" if pid in train_ids else "test"
        out_dir = os.path.join(out_path, sub, "images")
        os.makedirs(out_dir, exist_ok=True)
        out_file = os.path.join(out_dir, base)
        # crop_to_brain transposes (1, 0, 2): permute the spacing so the
        # header follows the array axes
        sp = np.asarray(spacing, np.float64)
        write_image(out_file, cropped, spacing=sp[[1, 0, 2]])
        written.append(out_file)
    return written


def create_masi_lr_dataset(src_path: str, out_path: str,
                           new_spacing_z: float = 5.0,
                           limited_load: bool = False) -> List[str]:
    """Simulate thick-slice LR volumes: 1-D z gaussian with
    sigma = spacing_z / 2.355 (FWHM = slice thickness), then z-resample
    to ``new_spacing_z`` (reference: create_cropped_set.py:110-157
    create_low_resolution_dataset — vectorised instead of per-(y,x)
    loops)."""
    written = []
    for sub in ("training", "test"):
        files = sorted(glob.glob(os.path.join(src_path, sub, "images",
                                              "*.nii*")))
        if limited_load:
            files = files[:2]
        out_dir = os.path.join(out_path, sub, "images")
        os.makedirs(out_dir, exist_ok=True)
        for fname in files:
            img, spacing, _ = read_image(fname)
            img = np.asarray(img, np.float32)
            spacing = np.asarray(spacing, np.float64)
            z_factor = spacing[0] / float(new_spacing_z)
            # FWHM = the SIMULATED slice thickness, expressed in source
            # voxels (sigma_mm = new_z / 2.355, / source z-spacing)
            sigma = float(new_spacing_z) / (2.355 * spacing[0])
            blurred = scipy.ndimage.gaussian_filter1d(img, sigma, axis=0)
            # z-only resample; in-plane grid unchanged
            lr = scipy.ndimage.zoom(blurred, (z_factor, 1.0, 1.0), order=1)
            out_file = os.path.join(out_dir, os.path.basename(fname))
            write_image(out_file, lr,
                        spacing=np.array([new_spacing_z, spacing[1],
                                          spacing[2]]))
            written.append(out_file)
    return written
