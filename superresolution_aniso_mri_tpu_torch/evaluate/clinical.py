"""Cardiac clinical metrics from segmentations of SR volumes.

Port of ``superresolution_aniso_mri_tpu/evaluate/clinical.py`` (numpy,
copied). Reference: evaluate/cardiac/compute_clinical_metrics.py:195-280 —
phase volumes (EDV/ESV/SV/EF per LV/RV), peak ejection / filling rates
from the volume-time curve, base/apex slice exchange for robustness
analysis, Bland-Altman arrays.

Label convention (ACDC): 0=BG, 1=RV, 2=MYO, 3=LV.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np

ACDC_LABELS = {"RV": 1, "MYO": 2, "LV": 3}


def structure_volume(labels3d: np.ndarray, label: int,
                     voxel_volume_ml: float) -> float:
    """Volume (ml) of one structure in a [z, y, x] label map."""
    return float(np.count_nonzero(labels3d == label) * voxel_volume_ml)


def volumes_over_time(labels4d: np.ndarray, voxel_volume_ml: float,
                      labels: Dict[str, int] = ACDC_LABELS
                      ) -> Dict[str, np.ndarray]:
    """Per-frame structure volumes from a [t, z, y, x] label sequence."""
    return {name: np.array([structure_volume(labels4d[t], lbl,
                                             voxel_volume_ml)
                            for t in range(labels4d.shape[0])])
            for name, lbl in labels.items()}


def compute_phase_volumes(vol_curves: Dict[str, np.ndarray],
                          ed_frame: Optional[int] = None,
                          es_frame: Optional[int] = None) -> Dict:
    """EDV/ESV/SV/EF per structure (reference:
    compute_clinical_metrics.py:201-232). If frames aren't given, ED is
    the max-LV-volume frame and ES the min-LV-volume frame."""
    if ed_frame is None or es_frame is None:
        # the LV curve only matters for phase DETECTION — explicitly
        # provided frames must work for RV-only/custom-label curves
        lv = vol_curves["LV"]
        if ed_frame is None:
            ed_frame = int(np.argmax(lv))
        if es_frame is None:
            es_frame = int(np.argmin(lv))
    out = {}
    for name, curve in vol_curves.items():
        edv = float(curve[ed_frame])
        esv = float(curve[es_frame])
        sv = edv - esv
        ef = 100.0 * sv / edv if edv else np.nan
        out[name] = {"EDV": edv, "ESV": esv, "SV": sv, "EF": ef}
    out["ed_frame"] = ed_frame
    out["es_frame"] = es_frame
    return out


def peak_rates(vol_curve: np.ndarray, frame_duration_s: float = 1.0
               ) -> Dict[str, float]:
    """Peak ejection (max -dV/dt) and filling (max +dV/dt) rates
    (reference: compute_clinical_metrics.py:233-260)."""
    vol_curve = np.asarray(vol_curve, np.float64)
    if vol_curve.size < 2:
        # a single-frame curve has no rates; NaN keeps aggregates honest
        return {"peak_ejection_rate": float("nan"),
                "peak_ejection_frame": -1,
                "peak_filling_rate": float("nan"),
                "peak_filling_frame": -1}
    dv = np.diff(vol_curve) / frame_duration_s
    # rates are magnitudes: a curve that only fills has no ejection
    # phase (rate 0, frame -1 — a real frame index would point at the
    # slowest opposite-phase frame, a meaningless location), and vice
    # versa
    ej = float(np.max(-dv))
    fi = float(np.max(dv))
    return {
        "peak_ejection_rate": max(ej, 0.0),
        "peak_ejection_frame": int(np.argmax(-dv)) if ej > 0 else -1,
        "peak_filling_rate": max(fi, 0.0),
        "peak_filling_frame": int(np.argmax(dv)) if fi > 0 else -1,
    }


def exchange_base_apex(labels3d_a: np.ndarray, labels3d_b: np.ndarray,
                       num_slices: int = 1) -> np.ndarray:
    """Replace the basal+apical slices of ``a`` with those of ``b``
    (reference: compute_clinical_metrics.py:343-383 — used to test
    sensitivity of clinical indices to boundary slices)."""
    out = labels3d_a.copy()
    if num_slices <= 0:
        return out  # out[-0:] would alias the WHOLE array, not none
    out[:num_slices] = labels3d_b[:num_slices]
    out[-num_slices:] = labels3d_b[-num_slices:]
    return out


def bland_altman_arrays(values_a: np.ndarray, values_b: np.ndarray) -> Dict:
    """Mean/diff arrays + bias and limits of agreement."""
    a = np.asarray(values_a, np.float64)
    b = np.asarray(values_b, np.float64)
    mean = (a + b) / 2.0
    diff = a - b
    bias = float(np.mean(diff))
    # sample SD (ddof=1): Bland-Altman limits of agreement use the
    # sample estimate; population SD narrows the interval at small n
    sd = float(np.std(diff, ddof=1)) if diff.size > 1 else 0.0
    return {"mean": mean, "diff": diff, "bias": bias,
            "loa_low": bias - 1.96 * sd, "loa_high": bias + 1.96 * sd}
