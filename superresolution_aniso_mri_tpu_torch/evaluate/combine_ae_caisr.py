"""Merge AE reconstructions with CAISR-synthesized slices.

Port of ``superresolution_aniso_mri_tpu/evaluate/combine_ae_caisr.py``
(numpy, copied; reference: evaluate/combine_ae_caisr.py:8-57): take the
grid (reconstructed/original) slices from the AE model's SR volumes and
the in-between slices from the CAISR model's volumes.
"""
from __future__ import annotations

from typing import Dict

import numpy as np

from ..ops.metrics import synth_slice_mask


def combine_volumes(ae_volume: np.ndarray, caisr_volume: np.ndarray,
                    downsample_steps: int) -> np.ndarray:
    """Copy recon-grid slices of the AE volume into the CAISR volume.

    Works for [z, y, x] or [t, z, y, x] arrays (slice axis 0 / 1)."""
    slice_axis = 0 if ae_volume.ndim == 3 else 1
    num_slices = ae_volume.shape[slice_axis]
    recon_mask = ~synth_slice_mask(num_slices, downsample_steps)
    out = caisr_volume.copy()
    if slice_axis == 0:
        out[recon_mask] = ae_volume[recon_mask]
    else:
        out[:, recon_mask] = ae_volume[:, recon_mask]
    return out


def create_combined_images(ae_volumes: Dict[str, Dict],
                           caisr_volumes: Dict[str, Dict],
                           downsample_steps: int) -> Dict[str, Dict]:
    """Per-patient dict variant mirroring the reference driver."""
    out = {}
    for patid, ae_item in ae_volumes.items():
        caisr_item = caisr_volumes[patid]
        out[patid] = {
            "image": combine_volumes(np.asarray(ae_item["image"]),
                                     np.asarray(caisr_item["image"]),
                                     downsample_steps),
            "patient_id": patid,
            "spacing": ae_item.get("spacing"),
        }
    return out
