"""Reconstruction-only model evaluation (no synthesis).

Port of ``superresolution_aniso_mri_tpu/evaluate/reconstruction.py``
(reference: evaluate/evaluate_reconstruction.py:7-34). Every slice goes
through ``trainer.predict`` (the primary model, in eval mode) in chunks
of the synthesis path's decode budget and is scored with
``compute_volume_metrics`` (SSIM through the CUDA kernel on the card).
JAX pads the slice count to a bucket to bound its recompiles; eval-mode
BatchNorm makes every slice independent of the others, so the port
predicts the slices as they are.
"""
from __future__ import annotations

from typing import Dict, Iterable

import numpy as np
import torch

from ..data.volume import Volume
from .metrics_driver import (IdUniquifier, aggregate_metrics,
                             compute_volume_metrics)


def _image_of(pred) -> torch.Tensor:
    """predict() output → image planes (MultiChannelAE decodes to
    ``{"image", "soft_probs"}``)."""
    return pred["image"] if isinstance(pred, dict) else pred


def evaluate_model_reconstruction(trainer, volumes: Iterable[Volume]
                                  ) -> Dict:
    """SSIM/PSNR/VIF/MSE of each volume's reconstruction against the
    volume, on the trainer's device: {'per_volume', 'aggregate'}. A
    ``colors >= 2`` model (the ACDCLBL families) takes the volume's
    labels as its second input plane when they lie on the image grid,
    zeros otherwise."""
    from ..infer.super_volume import _auto_decode_batch, model_label_semantics

    needs_label_channel, _ = model_label_semantics(trainer)
    depth = getattr(getattr(trainer, "model_config", None), "depth", 32)
    uniq = IdUniquifier()
    per_volume, ids = [], []
    for vol in volumes:
        img = np.asarray(vol.image, np.float32)
        s, h, w = img.shape
        x = img[:, None]
        if needs_label_channel:
            lbl = getattr(vol, "labels", None)
            plane = (np.asarray(lbl, np.float32)
                     if lbl is not None and np.asarray(lbl).shape == img.shape
                     else np.zeros_like(img))
            x = np.concatenate([x, plane[:, None]], axis=1)
        x = torch.from_numpy(np.ascontiguousarray(x))
        chunk = _auto_decode_batch(s, h, w, depth) or s
        recon = torch.cat([_image_of(trainer.predict(x[i:i + chunk]))[:, 0]
                           for i in range(0, s, chunk)])
        per_volume.append(compute_volume_metrics(
            img, recon.float().cpu().numpy(), device=trainer.device))
        ids.append(uniq.take(vol.patient_id))
    if not per_volume:
        raise ValueError("evaluate_model_reconstruction: no volumes to "
                         "evaluate (empty dataset/split?)")
    return {"per_volume": dict(zip(ids, per_volume)),
            "aggregate": aggregate_metrics(per_volume)}
