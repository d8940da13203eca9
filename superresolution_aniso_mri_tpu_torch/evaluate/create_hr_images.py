"""Dataset-level evaluation driver: synthesize HR volumes, score, save.

Port of ``superresolution_aniso_mri_tpu/evaluate/create_hr_images.py``
(reference: evaluate/create_HR_images.py:239-424): loop over patient
volumes, super-resolve with the model or a conventional interpolator
(``FILTER_BENCH``, on the host), compute SSIM/PSNR/VIF (+ LPIPS with
``compute_percept_metrics``) on all and on the synthesized slices (on
the trainer's device; SSIM through the CUDA kernel on the card), save
NIfTI volumes, aggregate mean ± std, dump the metrics as npz.
"""
from __future__ import annotations

import os
from typing import Dict, Iterable, List, Optional

import numpy as np

from ..data.volume import Volume, apply_2d_zoom_3d, apply_2d_zoom_4d
from ..device import resolve_device
from ..infer import create_simple_interpolation, create_super_volume
from ..ops.lpips import get_lpips_params, lpips_weights_info
from ..utils import write_image
from .metrics_driver import (IdUniquifier, aggregate_metrics,
                             compute_volume_metrics)

FILTER_BENCH = ("linear", "bspline", "lanczos", "nearest")


def save_3d_volume(image: np.ndarray, patient_id: str, output_dir: str,
                   sr_spacing, file_suffix: Optional[str] = None,
                   model: Optional[str] = None,
                   original_spacing=None, resample: bool = False,
                   labels: Optional[np.ndarray] = None,
                   output_dir_labels: Optional[str] = None) -> str:
    """Save a super-resolved 3D volume with the reference's on-disk
    contract: per-patient subdirectory,
    ``<pat>_<file_suffix or model>.nii.gz``; with ``resample=True`` the
    volume is resampled in-plane back to ``original_spacing`` — a
    3-vector (z, y, x) whose z entry is ignored (z keeps the SR
    spacing) — before saving."""
    sr_spacing = np.asarray(sr_spacing, np.float64).copy()
    if original_spacing is not None and len(original_spacing) != 3:
        raise ValueError("original_spacing must be a (z, y, x) 3-vector")
    spacing_img = sr_spacing.copy()
    if resample:
        if original_spacing is None:
            raise ValueError("resample=True requires original_spacing")
        image = apply_2d_zoom_3d(image, sr_spacing, original_spacing,
                                 do_blur=True, as_type=np.float32)
        spacing_img[1:] = np.asarray(original_spacing, np.float64)[1:]
    pat_dir = os.path.join(output_dir, patient_id)
    os.makedirs(pat_dir, exist_ok=True)
    fname = f"{patient_id}_{file_suffix if file_suffix else model}.nii.gz"
    path = os.path.join(pat_dir, fname)
    write_image(path, np.asarray(image, np.float32), spacing=spacing_img)
    if labels is not None:
        lbl_spacing = sr_spacing.copy()
        if resample:
            labels = apply_2d_zoom_3d(labels, sr_spacing, original_spacing,
                                      do_blur=False, order=0,
                                      as_type=np.int32)
            lbl_spacing[1:] = np.asarray(original_spacing, np.float64)[1:]
        lbl_dir = os.path.join(output_dir_labels or output_dir + "_labels",
                               patient_id)
        os.makedirs(lbl_dir, exist_ok=True)
        write_image(os.path.join(lbl_dir, fname),
                    np.asarray(labels, np.int32), spacing=lbl_spacing,
                    dtype=np.int32)
    return path


def save_4d_volume(volume4d: np.ndarray, patient_id: str, output_dir: str,
                   sr_spacing, file_suffix: Optional[str] = None,
                   model: Optional[str] = None,
                   original_spacing=None, resample: bool = False,
                   labels4d: Optional[np.ndarray] = None,
                   output_dir_labels: Optional[str] = None) -> str:
    """Save a [t, z, y, x] SR volume: filename ``<pat>_4d_<model>.nii.gz``
    (or ``<pat>_<file_suffix>``); optional per-frame in-plane resample
    back to the original (z, y, x) spacing's in-plane entries with
    nearest-order label resampling."""
    sr_spacing = np.asarray(sr_spacing, np.float64).copy()
    if original_spacing is not None and len(original_spacing) != 3:
        raise ValueError("original_spacing must be a (z, y, x) 3-vector")
    spacing_img = sr_spacing.copy()
    if resample:
        if original_spacing is None:
            raise ValueError("resample=True requires original_spacing")
        volume4d = apply_2d_zoom_4d(volume4d, sr_spacing, original_spacing,
                                    do_blur=True, as_type=np.float32)
        spacing_img[1:] = np.asarray(original_spacing, np.float64)[1:]
    pat_dir = os.path.join(output_dir, patient_id)
    os.makedirs(pat_dir, exist_ok=True)
    suffix = file_suffix if file_suffix else f"4d_{model}"
    fname = f"{patient_id}_{suffix}.nii.gz"
    path = os.path.join(pat_dir, fname)
    write_image(path, np.asarray(volume4d, np.float32), spacing=spacing_img)
    if labels4d is not None:
        lbl_spacing = sr_spacing.copy()
        if resample:
            labels4d = apply_2d_zoom_4d(labels4d, sr_spacing,
                                        original_spacing, do_blur=False,
                                        order=0, as_type=np.int32)
            lbl_spacing[1:] = np.asarray(original_spacing, np.float64)[1:]
        lbl_dir = os.path.join(output_dir_labels or output_dir + "_labels",
                               patient_id)
        os.makedirs(lbl_dir, exist_ok=True)
        write_image(os.path.join(lbl_dir, fname),
                    np.asarray(labels4d, np.int32), spacing=lbl_spacing,
                    dtype=np.int32)
    return path


def create_hr_images(trainer, volumes: Iterable[Volume],
                     downsample_steps: int,
                     output_dir: Optional[str] = None,
                     interpol_method: str = "model",
                     save_volumes: bool = False,
                     use_original: bool = False,
                     eval_axis: int = 0,
                     compute_percept_metrics: bool = False,
                     resample: bool = False,
                     original_spacing=None,
                     verbose: bool = False,
                     tta: Optional[str] = None,
                     latent_interp: str = "linear",
                     device=None) -> Dict:
    """Evaluate SR quality over a dataset of HR volumes.

    ``interpol_method``: 'model' → the latent-interpolation synthesis of
    ``trainer`` (a ``Trainer`` or ``ServingModel``); any of
    ``FILTER_BENCH`` → the conventional z-interpolation baseline on the
    host, clipped to [0, 1] (``trainer`` may be None). Scores on the
    trainer's device, else on ``device`` (None: the CUDA device).
    ``compute_percept_metrics`` adds LPIPS with the trainer's
    ``lpips_params``, else ``get_lpips_params()``, and records their
    ``lpips_mode``. Volumes whose ``image`` is 4D ([t, z, y, x]) are
    super-resolved and scored frame by frame and saved as one 4D NIfTI.
    Returns {'per_volume': {...}, 'aggregate': {...}[, 'lpips_mode']};
    see the JAX package's ``create_hr_images`` for every option."""
    dev = (trainer.device if getattr(trainer, "device", None) is not None
           else resolve_device(device))
    lpips_params = None
    lpips_mode = None
    if compute_percept_metrics:
        lpips_params = getattr(trainer, "lpips_params", None)
        if lpips_params is not None:
            # the trainer recorded its own weights' mode at resolution
            lpips_mode = trainer.args.get("lpips_mode")
        else:
            # baselines and models trained without the perceptual loss
            # still get the requested metric; the mode is captured at
            # this resolution
            lpips_params = get_lpips_params(device=dev)
            lpips_mode = lpips_weights_info()["mode"]
    alpha_range = np.linspace(0, 1, downsample_steps + 1)[1:-1]
    per_volume: List[Dict] = []
    per_volume_ids = []
    # samples for the aggregate: one entry per FRAME for 4D volumes
    # (patients with more frames weigh more, as in the reference);
    # per_volume keeps the per-patient mean for reporting
    agg_samples: List[Dict] = []
    if trainer is None:
        model_name = interpol_method
    else:
        model_name = trainer.args.get("model", "model") \
            if hasattr(trainer, "args") else "model"
    conv = interpol_method != "model"

    def _synthesize(img3d, lbl3d=None):
        if not conv:
            result = create_super_volume(
                trainer, img3d, alpha_range=alpha_range,
                downsample_steps=downsample_steps,
                generate_inbetween_slices=True,
                use_original=use_original, labels=lbl3d, tta=tta,
                latent_interp=latent_interp)
            return result["upsampled_image"], result["upsampled_labels"]
        # clip like the reference: cubic / lanczos taps ring outside [0, 1]
        return np.clip(create_simple_interpolation(
            img3d, downsample_steps, method=interpol_method,
            generate_inbetween_slices=True), 0.0, 1.0), lbl3d

    # metrics stop at the last on-grid slice: the (S-1) % ds tail slices
    # are verbatim ground-truth copies and must not inflate the scores
    def _n_scored(s):
        return ((s - 1) // downsample_steps) * downsample_steps + 1

    def _score(ref, up):
        n = min(len(ref), len(up), _n_scored(len(up)))
        return compute_volume_metrics(
            ref[:n], up[:n], downsample_steps=downsample_steps,
            conv_interpol=conv, eval_axis=eval_axis,
            lpips_params=lpips_params, device=dev)

    for vol in volumes:
        hr = vol.image_hr if vol.image_hr is not None else vol.image
        hr = np.asarray(hr, np.float32)
        img = np.asarray(vol.image, np.float32)
        is_4d = img.ndim == 4
        # input labels on the image grid (None when absent/mismatched)
        lbl_in = (np.asarray(vol.labels)
                  if getattr(vol, "labels", None) is not None else None)
        if lbl_in is not None and lbl_in.shape != img.shape:
            lbl_in = None

        if is_4d:
            frames, up_lbls, frame_metrics = [], [], []
            for t in range(img.shape[0]):
                up_t, uplbl_t = _synthesize(
                    img[t], None if lbl_in is None else lbl_in[t])
                frames.append(up_t)
                up_lbls.append(uplbl_t)
                frame_metrics.append(_score(hr[t], up_t))
            upsampled = np.stack(frames, axis=0)
            up_lbl = (np.stack(up_lbls, axis=0)
                      if all(u is not None for u in up_lbls) else None)
            agg_samples.extend(frame_metrics)
            metrics = {k: float(np.mean([m[k] for m in frame_metrics]))
                       for k in frame_metrics[0]}
        else:
            upsampled, up_lbl = _synthesize(img, lbl_in)
            metrics = _score(hr, upsampled)
            agg_samples.append(metrics)
        per_volume.append(metrics)
        per_volume_ids.append(vol.patient_id)
        if verbose:
            print(f"{vol.patient_id}: "
                  + " ".join(f"{k}={v:.4f}" for k, v in metrics.items()))
        if save_volumes and output_dir:
            os.makedirs(output_dir, exist_ok=True)
            # in-between-slices SR reconstructs onto the INPUT z-grid, so
            # the z-spacing does not change
            new_spacing = np.array(vol.spacing, np.float64).copy()
            orig_sp = (original_spacing if original_spacing is not None
                       else getattr(vol, "original_spacing", None))
            suffix = (f"{interpol_method}_{downsample_steps}x" if conv
                      else f"{model_name}_{downsample_steps}x")
            lbl = up_lbl if up_lbl is not None else (
                np.asarray(vol.labels)
                if getattr(vol, "labels", None) is not None else None)
            if lbl is not None and lbl.shape != upsampled.shape:
                lbl = None
            if is_4d:
                save_4d_volume(
                    upsampled, vol.patient_id, output_dir, new_spacing,
                    file_suffix=f"4d_{suffix}", model=model_name,
                    original_spacing=orig_sp, resample=resample,
                    labels4d=lbl)
            else:
                save_3d_volume(
                    upsampled, vol.patient_id, output_dir, new_spacing,
                    file_suffix=suffix, model=model_name,
                    original_spacing=orig_sp, resample=resample,
                    labels=lbl)

    if not per_volume:
        raise ValueError("create_hr_images: no volumes to evaluate "
                         "(empty dataset/split?)")
    agg = aggregate_metrics(agg_samples)
    if verbose:
        for k, (m, s) in agg.items():
            print(f"  {k}: {m:.4f} ({s:.4f})")
    uniq = IdUniquifier()
    uids = [uniq.take(pid) for pid in per_volume_ids]
    result = {"per_volume": dict(zip(uids, per_volume)), "aggregate": agg}
    if lpips_params is not None and lpips_mode:
        result["lpips_mode"] = lpips_mode
    if output_dir:
        save_metrics(output_dir, None, result, downsample_steps,
                     interpol_method, eval_axis)
    return result


def save_metrics(output_dir: str, eval_dataset, metrics_dict: Dict,
                 downsample_steps: int, interpol_method: str,
                 eval_axis: int) -> None:
    """npz metric dump naming scheme (reference: evaluate/common.py:11-27)."""
    results_dir = os.path.join(output_dir, "results")
    os.makedirs(results_dir, exist_ok=True)
    if eval_axis == 0:
        fname = f"{interpol_method}_{downsample_steps}x.npz"
    else:
        fname = f"{interpol_method}_{downsample_steps}x_axis{eval_axis}.npz"
    if eval_dataset is not None:
        fname = f"{eval_dataset}_" + fname
    flat = {}
    for pid, m in metrics_dict["per_volume"].items():
        for k, v in m.items():
            flat.setdefault(k, []).append(v)
    extra = {}
    if metrics_dict.get("lpips_mode"):
        extra["lpips_mode"] = np.array(metrics_dict["lpips_mode"])
    np.savez(os.path.join(results_dir, fname),
             patient_ids=np.array(list(metrics_dict["per_volume"].keys())),
             **{k: np.array(v) for k, v in flat.items()}, **extra)
