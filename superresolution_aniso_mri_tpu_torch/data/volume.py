"""Host-side volume container and the slice-pairing helpers of the
triplet sampler.

A numpy copy of ``superresolution_aniso_mri_tpu/data/volume.py``
(``Volume``, ``get_random_adjacent_slice``,
``determine_interpol_coefficients``), so the port imports nothing of
the JAX package.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


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
