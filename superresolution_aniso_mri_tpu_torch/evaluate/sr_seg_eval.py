"""Segmentation-quality evaluation over super-resolved volumes.

A numpy copy of ``superresolution_aniso_mri_tpu/evaluate/sr_seg_eval.py``
over the port's ``data/acdc_aux.py`` and ``evaluate/seg_metrics.py``:
the same per-case and aggregate dicts, NaN placement included.

Completes the reference's SR-segmentation workflow: the sr_seg_test
loaders provide reference labels for the SR evaluation fold
(data/acdc_aux.py), external segmentations of the SR volumes land in a
prediction directory (get_data.py layout), and the vendored-medpy
metric definitions score them (reference: datasets/ACDC/sr_seg_test/
dataset.py + datasets/ACDC/get_data.py + kwatsch/medpy_metrics.py, used
together by the journal's segmentation experiments).
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np

from ..data.acdc_aux import acdc_sr_seg_fold, load_uncertainty_data
from .seg_metrics import (assd_from_pair, dc, hd95_from_pair,
                          surface_distance_pair)

ACDC_STRUCTURES = {1: "RV", 2: "MYO", 3: "LV"}


def score_segmentation(pred: np.ndarray, reference: np.ndarray,
                       voxelspacing=None,
                       structures: Optional[Dict[int, str]] = None
                       ) -> Dict[str, Dict[str, float]]:
    """Per-structure Dice / HD95 / ASSD between integer label volumes."""
    pred = np.asarray(pred)
    reference = np.asarray(reference)
    # fail fast on shape mismatches: broadcastable ones (e.g. a leading
    # singleton frame axis) would silently score a meaningless broadcast
    # and non-broadcastable ones crash deep inside the distance metrics
    if pred.shape == (1,) + reference.shape:
        pred = pred[0]
    if reference.shape == (1,) + pred.shape:
        reference = reference[0]
    if pred.shape != reference.shape:
        raise ValueError(
            f"score_segmentation: pred shape {pred.shape} != reference "
            f"shape {reference.shape}")
    structures = structures or ACDC_STRUCTURES
    out: Dict[str, Dict[str, float]] = {}
    for lbl, name in structures.items():
        p = pred == lbl
        r = reference == lbl
        if not p.any() and not r.any():
            # structure absent from BOTH volumes: perfect agreement on
            # absence — dc() would return 0.0 and drag the cohort mean
            # down; NaN excludes it like hd95/assd
            out[name] = {"dice": float("nan"), "hd95": float("nan"),
                         "assd": float("nan")}
            continue
        scores = {"dice": dc(p, r)}
        if p.any() and r.any():
            # one surface-distance computation feeds both metrics (the
            # EDTs dominate cohort eval cost; hd95+assd separately would
            # run them twice)
            d1, d2 = surface_distance_pair(p, r,
                                           voxelspacing=voxelspacing)
            scores["hd95"] = hd95_from_pair(d1, d2)
            scores["assd"] = assd_from_pair(d1, d2)
        else:
            scores["hd95"] = float("nan")
            scores["assd"] = float("nan")
        out[name] = scores
    return out


def evaluate_sr_segmentation(pred_dir: str, root_dir: str, fold: int = 0,
                             cardiac_phases: Sequence[str] = ("ED", "ES"),
                             mc_dropout: bool = False,
                             limited_load: bool = False,
                             resample: bool = False) -> Dict:
    """Score predicted segmentations of SR volumes against the SR-seg
    fold's reference labels.

    ``pred_dir`` follows the get_data.py layout:
    ``<pred_dir>/pred_labels[_mc]/<patient>_<ED|ES>.nii.gz``.
    Returns {'per_case': {(patient, phase): {structure: scores}},
    'aggregate': {structure: {metric: (mean, std)}}}.
    """
    refs = {}
    spacings = {}
    for d in acdc_sr_seg_fold(fold, root_dir, limited_load=limited_load,
                              resample=resample):
        if d["reference"] is None:
            continue
        refs[(d["patient_id"], d["cardiac_phase"])] = d["reference"]
        spacings[(d["patient_id"], d["cardiac_phase"])] = d["spacing"]

    per_case: Dict = {}
    n_preds = 0
    for phase in cardiac_phases:
        preds = load_uncertainty_data(pred_dir, phase, "pred_labels",
                                      mc_dropout=mc_dropout)["pred_labels"]
        n_preds += len(preds)
        for pid, pred in preds.items():
            key = (pid, phase)
            if key not in refs:
                continue
            per_case[key] = score_segmentation(
                np.asarray(pred, np.int32), refs[key],
                voxelspacing=spacings[key])

    # a cohort that scored NOTHING must not look like one that ran —
    # typo'd pred_dir / wrong mc_dropout subdir / disjoint patient ids
    # would otherwise return empty dicts and crash far downstream
    if not per_case:
        sub = "pred_labels_mc" if mc_dropout else "pred_labels"
        raise ValueError(
            f"evaluate_sr_segmentation scored 0 cases: {n_preds} "
            f"prediction file(s) under {pred_dir}/{sub} matched "
            f"{len(refs)} fold-{fold} reference(s) — wrong pred_dir, "
            f"mc_dropout flag, or patient-id naming?")

    agg: Dict[str, Dict[str, tuple]] = {}
    if per_case:
        any_case = next(iter(per_case.values()))
        for name in any_case:
            agg[name] = {}
            for metric in any_case[name]:
                vals = np.array([c[name][metric]
                                 for c in per_case.values()], np.float64)
                vals = vals[np.isfinite(vals)]
                agg[name][metric] = (float(vals.mean()) if len(vals) else
                                     float("nan"),
                                     float(vals.std()) if len(vals) else
                                     float("nan"))
    return {"per_case": per_case, "aggregate": agg}
