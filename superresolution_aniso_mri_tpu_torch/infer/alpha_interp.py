"""Latent interpolation with probe-predicted mixing coefficients.

Port of ``superresolution_aniso_mri_tpu/infer/alpha_interp.py``: the
numpy feature rows (normalised slice ids, frame id, spacing, slice
count) are copied; ``latent_space_interp_pred_alpha`` runs the trained
probe on the concatenated latents and mixes with its coefficients
(``train/steps.py::alpha_mix``) instead of fixed alphas. Images are NCHW.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ..train.steps import alpha_mix


def synthesize_cardiac_features(normalized_frame_id: float,
                                orig_num_slices: int, spacing: float,
                                downsample_steps: int = 2) -> np.ndarray:
    """Per-adjacent-pair feature rows [K-1, 5]: (normalised slice id
    from, normalised slice id to, normalised frame id, z spacing,
    original slice count)."""
    slice_range = np.arange(0, orig_num_slices)[::downsample_steps]
    id_from = (slice_range[:-1] + 1) / orig_num_slices
    id_to = (slice_range[1:] + 1) / orig_num_slices
    n = id_from.shape[0]
    return np.concatenate([
        id_from[:, None], id_to[:, None],
        np.full((n, 1), normalized_frame_id),
        np.full((n, 1), spacing),
        np.full((n, 1), orig_num_slices),
    ], axis=1).astype(np.float32)


def create_features(feature_dict: Dict,
                    downsample_steps: int = 2) -> np.ndarray:
    """The feature rows of ``feature_dict`` (cardiac is the only anatomy
    the reference implements)."""
    if feature_dict.get("anatomy") == "cardiac":
        return synthesize_cardiac_features(
            feature_dict["norm_frame_id"], feature_dict["orig_num_slices"],
            feature_dict["spacing"], downsample_steps=downsample_steps)
    raise NotImplementedError(
        f"anatomy {feature_dict.get('anatomy')!r} not supported")


def get_alpha_probe_features(feature_dict: Dict, batch_item: Dict
                             ) -> np.ndarray:
    """Train-time feature rows of a batch: its ``alpha_features`` [B, 5]
    (``TripletSampler``'s) as they are, else rows built from the raw
    slice metadata normalised like the training rows (``(id + 1) /
    num_slices``); a batch with neither raises KeyError, since zero
    features would train or evaluate the probe on garbage."""
    if "alpha_features" in batch_item:
        return np.asarray(batch_item["alpha_features"], np.float32)
    meta_keys = ("slice_id_from", "slice_id_to", "num_slices")
    if not any(k in batch_item for k in meta_keys):
        raise KeyError(
            "batch carries neither 'alpha_features' nor raw slice "
            "metadata (slice_id_from/slice_id_to/num_slices) — probe "
            "features cannot be constructed")
    size_src = next(k for k in ("alpha_from",) + meta_keys
                    if k in batch_item)
    b = np.asarray(batch_item[size_src]).shape[0]
    n = np.asarray(batch_item.get("num_slices", np.full(
        b, feature_dict.get("orig_num_slices", 0))), np.float64)
    n_safe = np.where(n > 0, n, 1.0)
    s_from = np.asarray(batch_item.get("slice_id_from", np.zeros(b)),
                        np.float64)
    s_to = np.asarray(batch_item.get("slice_id_to", np.zeros(b)),
                      np.float64)
    return np.concatenate([
        ((s_from + 1.0) / n_safe)[:, None],
        ((s_to + 1.0) / n_safe)[:, None],
        np.asarray(batch_item.get("frame_id", np.full(
            b, feature_dict.get("norm_frame_id", 0.0))))[:, None],
        np.asarray(batch_item.get("spacing", np.full(
            b, feature_dict.get("spacing", 1.0))))[:, None],
        n[:, None],
    ], axis=1).astype(np.float32)


def latent_space_interp_pred_alpha(trainer, img1, img2,
                                   downsample_steps: int,
                                   feature_dict: Optional[Dict] = None):
    """Mix adjacent slices' latents with the coefficients the trained
    probe predicts and decode. ``img1`` / ``img2``: [K-1, C, H, W]
    adjacent-slice stacks (arrays or tensors); ``feature_dict``:
    ``{'anatomy': 'cardiac', 'norm_frame_id', 'orig_num_slices',
    'spacing'}``. Returns (the decoded [K-1, C, H, W] tensor on the
    trainer's device, the coefficients [K-1, num_out] as numpy)."""
    if feature_dict is None:
        raise ValueError(
            "latent_space_interp_pred_alpha requires a feature_dict "
            "({'anatomy': 'cardiac', 'norm_frame_id', 'orig_num_slices', "
            "'spacing'}) — the probe's coefficients depend on slice "
            "geometry")
    z1 = trainer.encode(img1)
    z2 = trainer.encode(img2)
    features = create_features(feature_dict, downsample_steps)
    alphas = trainer.predict_alpha(torch.cat([z1, z2], dim=1), features)
    z_mix = alpha_mix(alphas, z1, z2, trainer.num_alphas,
                      int(trainer.args["latent"]),
                      getattr(trainer.loss_config, "alpha_scheme", ""))
    return trainer.decode(z_mix), alphas.cpu().numpy()
