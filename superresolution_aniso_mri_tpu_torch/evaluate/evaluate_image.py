"""During-training validation volume synthesis + previews.

Port of ``superresolution_aniso_mri_tpu/evaluate/evaluate_image.py``
(reference: evaluate/evaluate_image.py:36-107): synthesize full
validation frames at ds=2 and build original-vs-synth compare grids.
"""
from __future__ import annotations

from typing import Dict

import numpy as np

from ..data.transforms import pad_to_size
from ..infer import create_super_volume
from ..utils.grids import create_compare_image


def evaluate_image(trainer, image_dict: Dict, frame_id: int = 0,
                   downsample_steps: int = 2,
                   eval_patch_size: int | None = None) -> Dict:
    """Synthesize one frame of a (4D or 3D) validation volume.

    ``image_dict`` carries 'image' as [t, z, y, x] or [z, y, x].
    Returns {'orig_images', 'synth_images', 'pred_alphas'} keyed by
    frame_id, like the reference.
    """
    img = np.asarray(image_dict["image"], np.float32)
    # 3D volumes have a single "frame"; the result keeps the CALLER's
    # frame_id as its key
    frame = img[frame_id] if img.ndim == 4 else img
    if eval_patch_size is not None:
        frame = pad_to_size(frame, eval_patch_size)
        h, w = frame.shape[-2:]
        top = (h - eval_patch_size) // 2
        left = (w - eval_patch_size) // 2
        frame = frame[:, top:top + eval_patch_size,
                      left:left + eval_patch_size]
    alpha_range = np.linspace(0, 1, downsample_steps + 1)[1:-1]
    result = create_super_volume(trainer, frame, alpha_range=alpha_range,
                                 downsample_steps=downsample_steps,
                                 generate_inbetween_slices=True)
    return {"orig_images": {frame_id: frame},
            "synth_images": {frame_id: result["upsampled_image"]},
            "pred_alphas": {frame_id: result["pred_alphas"]}}


def generate_val_volume_grids(trainer, image_dicts: Dict, frame_id: int = 0,
                              eval_patch_size: int | None = None) -> Dict:
    """Per-patient compare grids for end-of-epoch previews
    (reference: base_trainer.py:149-162 _generate_val_volumes)."""
    grids, alphas = {}, {}
    for p_id, image_dict in image_dicts.items():
        rd = evaluate_image(trainer, image_dict, frame_id=frame_id,
                            downsample_steps=2,
                            eval_patch_size=eval_patch_size)
        grids[p_id] = create_compare_image(rd["orig_images"][frame_id],
                                           rd["synth_images"][frame_id])
        alphas[p_id] = rd["pred_alphas"][frame_id]
    return {"grids": grids, "alphas": alphas}
