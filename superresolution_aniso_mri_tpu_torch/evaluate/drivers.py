"""Dataset-level eval drivers (brain / cardiac) + interp-performance
wrappers.

Port of ``superresolution_aniso_mri_tpu/evaluate/drivers.py``; every
driver ends in ``create_hr_images`` (synthesis and scoring on the
trainer's device). Reference: evaluate/brain/evaluate_model.py:14-170 (create_brain_volumes
+ conventional variant), evaluate/cardiac/evaluate_model.py:14-120,
evaluate/evaluate_interpolations.py:9-63 (evaluate_interpolation_performance,
test_interpolation_with_rigid_transformations).
"""
from __future__ import annotations

from typing import Dict, Iterable, Optional

import numpy as np
import scipy.ndimage

from ..data.volume import Volume
from .create_hr_images import create_hr_images


def evaluate_interpolation_performance(trainer, volumes: Iterable[Volume],
                                       downsample_steps: int,
                                       **kwargs) -> Dict:
    """Thin wrapper used by the best-model sweep
    (reference: evaluate_interpolations.py:42-63)."""
    kwargs.setdefault("save_volumes", False)
    return create_hr_images(trainer, volumes, downsample_steps, **kwargs)


def test_interpolation_with_rigid_transformations(
        trainer, volume: Volume, downsample_steps: int,
        angles=(0, 5, 10, 15, 20)) -> Dict[int, Dict]:
    """Rotate the volume in-plane by each angle, evaluate, report the
    metric sensitivity (reference: evaluate_interpolations.py:9-39)."""
    if np.asarray(volume.image).ndim != 3:
        # a 4D [t,z,y,x] volume's img[s] is a FRAME, and rotate's
        # default axes would spin the through-plane (z,y) — reject
        # rather than silently measure the wrong rotation
        raise ValueError(
            "test_interpolation_with_rigid_transformations needs a 3D "
            f"[z,y,x] volume, got shape {np.asarray(volume.image).shape} "
            "— pass one cardiac frame at a time")
    results = {}
    for angle in angles:
        img = volume.image
        hr = volume.image_hr
        lbl = volume.labels
        if angle:
            def _rot(v):
                return np.clip(np.stack([
                    scipy.ndimage.rotate(v[s], angle, reshape=False,
                                         order=1, mode="constant")
                    for s in range(v.shape[0])
                ]).astype(np.float32), 0.0, 1.0)
            img = _rot(img)
            # the paired references must rotate WITH the input — scoring
            # a rotated synthesis against an unrotated HR (or silently
            # dropping the HR so the degraded input becomes the
            # reference) invalidates the whole sensitivity table
            hr = _rot(hr) if hr is not None else None
            lbl = (np.stack([
                scipy.ndimage.rotate(lbl[s], angle, reshape=False,
                                     order=0, mode="constant")
                for s in range(lbl.shape[0])]).astype(np.float32)
                if lbl is not None else None)
        vol = Volume(image=img, spacing=volume.spacing,
                     image_hr=hr, labels=lbl,
                     patient_id=f"{volume.patient_id}_rot{angle}")
        res = create_hr_images(trainer, [vol], downsample_steps,
                               save_volumes=False)
        results[angle] = res["aggregate"]
    return results


# a library function, not a test: keep pytest from collecting it where a
# test module imports it
test_interpolation_with_rigid_transformations.__test__ = False


def create_brain_volumes(trainer, dataset: str, downsample_steps: int,
                         split: str = "test",
                         output_dir: Optional[str] = None,
                         limited_load: bool = False,
                         save_volumes: bool = True,
                         interpol_method: str = "model",
                         **kwargs) -> Dict:
    """Brain SR volume generation + scoring
    (reference: evaluate/brain/evaluate_model.py:58-170)."""
    from ..data.datasets import get_datasets, load_brain_volumes

    width = kwargs.pop("width", 64)  # consumed on every path — a brain
    # dataset call passing width must not leak it into create_hr_images
    if dataset in ("MNIST3D", "MNISTRoto"):
        _train, val = get_datasets({
            "dataset": dataset, "downsample_steps": downsample_steps,
            "use_synthetic_data": True, "limited_load": limited_load,
            "width": width, "seed": 0})
        # the toy backend has no separate test split; the validation
        # phantoms stand in for every split name
        volumes = val
    else:
        volumes = load_brain_volumes(dataset, downsample_steps, split,
                                     limited_load=limited_load,
                                     include_hr_images=True)
    return create_hr_images(trainer, volumes, downsample_steps,
                            output_dir=output_dir,
                            interpol_method=interpol_method,
                            save_volumes=save_volumes, **kwargs)


def create_cardiac_volumes(trainer, downsample_steps: int,
                           split: str = "test",
                           output_dir: Optional[str] = None,
                           limited_load: bool = False,
                           save_volumes: bool = True,
                           interpol_method: str = "model",
                           **kwargs) -> Dict:
    """Cardiac (ACDC) SR volume generation + scoring
    (reference: evaluate/cardiac/evaluate_model.py:14-120)."""
    from ..data.datasets import load_acdc_volumes

    volumes = load_acdc_volumes(split, limited_load=limited_load)
    return create_hr_images(trainer, volumes, downsample_steps,
                            output_dir=output_dir,
                            interpol_method=interpol_method,
                            save_volumes=save_volumes, **kwargs)
