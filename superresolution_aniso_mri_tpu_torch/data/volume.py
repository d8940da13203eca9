"""Host-side volume container, intensity and in-plane resampling
helpers, and the slice-pairing helpers of the triplet sampler.

A numpy/scipy copy of ``superresolution_aniso_mri_tpu/data/volume.py``
(``Volume``, ``rescale_intensities``, ``simulate_thick_slices``,
``create_lr_volume``, ``apply_2d_zoom_3d/_4d``,
``get_random_adjacent_slice``, ``determine_interpol_coefficients``,
``get_paired_frames``, ``get_paired_slices``), so
the port imports nothing of the JAX package.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import scipy.ndimage


@dataclasses.dataclass
class Volume:
    """A 3-D (or per-frame 3-D) image with physical metadata.

    ``image``: [slices, H, W] float32; ``spacing``: (z, y, x) mm.
    ``origin``/``direction`` follow the ITK conventions so NIfTI round
    trips preserve geometry (reference: generate_hr_volumes.py:114-127).
    """

    image: np.ndarray
    spacing: np.ndarray
    patient_id: str = ""
    origin: Optional[tuple] = None
    direction: Optional[tuple] = None
    image_hr: Optional[np.ndarray] = None  # paired HR ground truth, if any
    labels: Optional[np.ndarray] = None
    # scanner-native (z, y, x) spacing before model-space resampling —
    # used by the evaluation's resample-back-to-original option
    # (reference: evaluate/create_HR_images.py:81-107)
    original_spacing: Optional[np.ndarray] = None
    # cine position for per-frame Volumes (4-D cardiac loaders): feeds
    # the alpha-probe feature rows (data/pairs.py alpha_features) so the
    # normalized-frame feature matches what inference computes
    # (infer/alpha_interp.py synthesize_cardiac_features)
    frame_id: int = 0
    num_frames: int = 1

    @property
    def num_slices(self) -> int:
        return int(self.image.shape[0])


def rescale_intensities(im: np.ndarray, percs=(0, 100),
                        dtype=np.float32) -> np.ndarray:
    """Percentile intensity rescale to [0,1]
    (reference: datasets/common.py:408-416).

    NaN voxels (registration/resampling fill) are treated as background:
    percentiles ignore them and they map to 0 — fixing only the
    percentile SCALARS would still let NaN voxels flow into training
    batches and NaN the run."""
    if np.isnan(im).any():
        min_val, max_val = np.nanpercentile(im, percs)
        im = np.nan_to_num(im, nan=float(min_val)
                           if np.isfinite(min_val) else 0.0)
    else:
        min_val, max_val = np.percentile(im, percs)
    if np.isnan(min_val):
        min_val = 0.0
    if np.isnan(max_val):
        max_val = 1.0
    if max_val - min_val == 0:
        # constant input (blank/padded frame): dividing by 0 would fill
        # the training batch with NaNs
        return np.zeros_like(im, dtype=dtype)
    return ((im.astype(dtype) - min_val) / (max_val - min_val)).clip(0, 1)


def simulate_thick_slices(img3d: np.ndarray,
                          slice_thickness: float) -> np.ndarray:
    """Through-plane PSF simulation: a 1-D gaussian along z with
    sigma = thickness / 2.355 (the FWHM relation; reference:
    datasets/common_brains.py:37-44)."""
    sigma = slice_thickness / 2.355
    return scipy.ndimage.gaussian_filter1d(
        img3d.astype(np.float32), sigma, axis=0)


def create_lr_volume(img3d: np.ndarray, downsample_steps: int,
                     subsample: bool = False) -> np.ndarray:
    """Blur to a ``downsample_steps`` mm-equivalent thickness; optionally
    keep every ds-th slice (reference: datasets/OASIS/dataset.py:104-122)."""
    lr = simulate_thick_slices(img3d, float(downsample_steps))
    if subsample:
        lr = lr[::downsample_steps]
    return lr


def apply_2d_zoom_3d(arr3d: np.ndarray, spacing, new_spacing,
                     order: int = 1, do_blur: bool = True,
                     as_type=np.float32) -> np.ndarray:
    """In-plane resample of a [S, H, W] stack to ``new_spacing`` (y, x)
    with an anti-alias gaussian pre-blur of sigma = 0.25/zoom
    (reference: datasets/common.py:178-206)."""
    spacing = np.asarray(spacing, np.float64)[-2:]
    new_spacing = np.asarray(new_spacing, np.float64)[-2:]
    zoom = spacing / new_spacing
    arr3d = arr3d.astype(np.float32).copy()
    if do_blur:
        sigma = 0.25 / zoom
        # vectorised: blur y/x only (sigma_z = 0)
        arr3d = scipy.ndimage.gaussian_filter(arr3d, (0.0, sigma[0], sigma[1]))
    resized = scipy.ndimage.zoom(arr3d, (1.0,) + tuple(zoom), order=order)
    if np.issubdtype(np.dtype(as_type), np.integer):
        resized = np.round(resized).astype(as_type)
    else:
        resized = resized.astype(as_type)
    return resized


def apply_2d_zoom_4d(arr4d: np.ndarray, spacing, new_spacing,
                     order: int = 1, do_blur: bool = True,
                     as_type=np.float32) -> np.ndarray:
    """Per-frame variant of apply_2d_zoom_3d
    (reference: datasets/common.py:157-175)."""
    return np.stack([
        apply_2d_zoom_3d(arr4d[t], spacing, new_spacing, order=order,
                         do_blur=do_blur, as_type=as_type)
        for t in range(arr4d.shape[0])
    ], axis=0)


def get_random_adjacent_slice(slice_id: int, num_slices: int, rs, step: int = 1) -> int:
    """Pick a +/- step neighbour with edge handling
    (reference: datasets/common.py:34-44). The final clamp guards the
    degenerate case the reference mishandles (slice_id < step AND
    slice_id + step > last would return a negative index that numpy
    would silently wrap to the volume tail)."""
    last = num_slices - 1
    if slice_id + step > last:
        res = slice_id - step
    elif slice_id == 0:
        res = step
    elif slice_id - step < 0:
        res = slice_id + step
    else:
        res = int(rs.choice([slice_id - step, slice_id + step]))
    return int(np.clip(res, 0, last))


def determine_interpol_coefficients(sliceid_from: int, sliceid_to: int,
                                    sliceid_between: int):
    """alpha_from/alpha_to from relative slice positions
    (reference: datasets/common_brains.py:117-119)."""
    gap = sliceid_to - sliceid_from
    a_from = 1.0 - (sliceid_between - sliceid_from) / gap
    a_to = 1.0 - (sliceid_to - sliceid_between) / gap
    return float(a_from), float(a_to)


def get_paired_frames(num_frames: int, rs):
    """Temporal frame pairing: anchor all pairs on frame 0 or the last
    frame, chosen at random (reference: datasets/common.py:47-56)."""
    if int(rs.randint(2)) == 0:
        frames_from = np.repeat(np.array([0]), num_frames)
        frames_to = np.append(np.arange(1, num_frames),
                              np.array([num_frames - 1]))
    else:
        frames_from = np.repeat(np.array([num_frames - 1]), num_frames)
        frames_to = np.append(np.arange(0, num_frames - 1), np.array([0]))
    return frames_from, frames_to


def get_paired_slices(num_slices: int, rs=None):
    """Adjacent slice pairing (+one random 'joker' self-pair), randomly
    reversed (reference: datasets/common.py:59-69). ``rs`` defaults to a
    fresh ``RandomState(1234)``, so the pairing is deterministic."""
    rand = rs if rs is not None else np.random.RandomState(1234)
    joker = int(rand.randint(num_slices))
    s1 = np.append(np.arange(0, num_slices - 1), np.array([joker]))
    s2 = np.append(np.arange(1, num_slices), np.array([joker]))
    if int(rand.randint(2)) == 0:
        return s1, s2
    return s2, s1
