"""Compare saved SR volumes of any method against HR references.

Port of ``superresolution_aniso_mri_tpu/evaluate/quantitative_comparison.py``
(reference: evaluate/quantitative_comparison.py:10-258): the same four
metrics (+MSE) on all and on the synthesized slices, scored on the
device (SSIM through the CUDA kernel on the card), latex table
formatting, npz load/save. NIfTI goes through ``utils/nifti.py``.
"""
from __future__ import annotations

import os
from typing import Dict, Iterable, List, Optional

import numpy as np

from ..data.volume import rescale_intensities
from ..ops.metrics import synth_slice_mask
from ..utils import read_image
from .metrics_driver import (IdUniquifier, aggregate_metrics,
                             compute_volume_metrics)


def generate_synth_slices_mask(num_slices: int, downsample_steps: int
                               ) -> np.ndarray:
    """Boolean synth-slice mask (reference:
    quantitative_comparison.py:10-17)."""
    return synth_slice_mask(num_slices, downsample_steps)


def compare_quantitative(reference_files: Iterable[str],
                         method_files: Iterable[str],
                         downsample_steps: int,
                         conv_interpol: bool = False,
                         output_file: Optional[str] = None,
                         normalize: bool = False, device=None) -> Dict:
    """Score one method's saved volumes vs matching HR volumes
    (reference: quantitative_comparison.py:20-195). ``normalize``
    rescales the METHOD volume only, like the reference ("we assume
    l_images is always normalized"). 4D saved volumes (the framework's
    own save_4d_volume output) score frame by frame; verbatim tail
    slices are excluded like create_hr_images. Scores on ``device``
    (None: the CUDA device)."""
    reference_files = list(reference_files)
    method_files = list(method_files)
    if len(reference_files) != len(method_files):
        raise ValueError(
            f"{len(reference_files)} reference vs {len(method_files)} "
            f"method files — the lists must pair one-to-one")
    if not reference_files:
        raise ValueError("compare_quantitative: no volumes to compare")

    ds = int(downsample_steps)

    def _score3d(ref3d, up3d):
        n = min(len(ref3d), len(up3d))
        # exclude verbatim-copied tail slices (same rule as
        # create_hr_images: determine_last_slice + 1)
        n = min(n, ((len(up3d) - 1) // ds) * ds + 1)
        return compute_volume_metrics(
            ref3d[:n], up3d[:n], downsample_steps=ds,
            conv_interpol=conv_interpol, device=device)

    per_volume: List[Dict] = []
    agg_samples: List[Dict] = []
    ids = []
    for ref_path, m_path in zip(reference_files, method_files):
        ref, _, _ = read_image(ref_path)
        up, _, _ = read_image(m_path)
        ref = np.asarray(ref, np.float32)
        up = np.asarray(up, np.float32)
        if normalize:
            up = rescale_intensities(up, percs=(0, 100))
        # degenerate single-frame 4D files (t=1 — a common NIfTI writer
        # shape, incl. save_4d_volume for a 1-frame cine) score as 3D;
        # without the squeeze a 3D/4D mixed pair conflated the t-axis
        # with z and failed the metrics on mismatched shapes
        if ref.ndim == 4 and ref.shape[0] == 1 and up.ndim != 4:
            ref = ref[0]
        if up.ndim == 4 and up.shape[0] == 1 and ref.ndim != 4:
            up = up[0]
        if float(ref.min()) < -1e-3 or float(ref.max()) > 1.0 + 1e-3:
            import warnings
            warnings.warn(
                f"{os.path.basename(ref_path)}: reference intensities "
                f"outside [0, 1] ({ref.min():.3g}..{ref.max():.3g}) — "
                f"metrics assume normalized references", stacklevel=2)
        if ref.ndim == 4 and up.ndim == 4:
            t = min(ref.shape[0], up.shape[0])
            frames = [_score3d(ref[i], up[i]) for i in range(t)]
            agg_samples.extend(frames)
            metrics = {k: float(np.mean([f[k] for f in frames]))
                       for k in frames[0]}
        else:
            metrics = _score3d(ref, up)
            agg_samples.append(metrics)
        per_volume.append(metrics)
        ids.append(os.path.basename(ref_path))
    agg = aggregate_metrics(agg_samples)
    # uniquify duplicate basenames (per-patient dirs often share names)
    # — shared convention (metrics_driver.IdUniquifier)
    uniq = IdUniquifier()
    uids = [uniq.take(i) for i in ids]
    result = {"per_volume": dict(zip(uids, per_volume)), "aggregate": agg}
    if output_file:
        flat = {}
        for m in per_volume:
            for k, v in m.items():
                flat.setdefault(k, []).append(v)
        # carry the volume ids so rows stay traceable on reload (same
        # convention as create_hr_images.save_metrics)
        np.savez(output_file, patient_ids=np.array(uids),
                 **{k: np.array(v) for k, v in flat.items()})
    return result


def load_results(npz_file: str) -> Dict[str, np.ndarray]:
    # the files written above hold only numeric/str arrays — never
    # enable pickle loading (arbitrary code execution on a crafted npz)
    data = np.load(npz_file, allow_pickle=False)
    return {k: data[k] for k in data.files}


def format_latex_string(agg: Dict[str, tuple],
                        keys=("ssim_synth", "psnr_synth", "vif_synth")) -> str:
    """mean (std) latex row (reference:
    quantitative_comparison.py:237-258)."""
    cells = [f"{agg[k][0]:.3f} ({agg[k][1]:.2f})" for k in keys]
    return " & ".join(cells) + r" \\"
