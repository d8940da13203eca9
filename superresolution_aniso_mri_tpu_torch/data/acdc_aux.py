"""ACDC auxiliary evaluation datasets and tools.

A numpy/scipy copy of ``superresolution_aniso_mri_tpu/data/acdc_aux.py``,
its bug-for-bug branches kept (the patient029 pin that the
sub-millimetre clause bypasses; the 2-phase frame map).

Three reference components live here, rebuilt on the framework's own
NIfTI reader and scipy host utilities (no SimpleITK / cv2 / torch):

  * the SR-segmentation test set — ED/ES phases with reference labels,
    4-fold patient split, optional in-plane resample to 1.4 mm
    (reference: datasets/ACDC/sr_seg_test/dataset.py:60-251,
    acdctestsr_validation_fold at :18-52);
  * uncertainty-map / prediction loaders for segmentation-quality
    studies over SR volumes (reference: datasets/ACDC/get_data.py);
  * centered-dataset generation — rotate + translate every 4D volume so
    the LV/RV midpoint sits at the image center with RV left of LV
    (reference: datasets/ACDC/generate_centered_dataset.py).
"""
from __future__ import annotations

import glob
import os
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import scipy.ndimage

from ..utils.nifti import read_image, write_image
from .volume import apply_2d_zoom_3d, rescale_intensities

ACDC_NEW_SPACING = (1.0, 1.4, 1.4)
# resampling patient029 changes its shape; the reference pins it
# (sr_seg_test/dataset.py:172-176)
_NO_RESAMPLE_PATIENTS = (29,)


# ---------------------------------------------------------------------------
# 4-fold split (reference: datasets/ACDC/data.py:198-212)
# ---------------------------------------------------------------------------

def get_acdc_fold_patient_ids(fold: int, dataset: str = "validation",
                              limited_load: bool = False,
                              max_limit_load: int = 2) -> np.ndarray:
    """Patients 1..100 split into 4 folds with the reference's mask
    ``tile(arange(4)[::-1].repeat(5), 5)``."""
    assert dataset in ("training", "validation", "full")
    all_nums = np.arange(1, 101)
    foldmask = np.tile(np.arange(4)[::-1].repeat(5), 5)
    if dataset == "training":
        nums = all_nums[foldmask != fold]
    elif dataset == "validation":
        nums = all_nums[foldmask == fold]
    else:
        nums = all_nums
    return nums[:max_limit_load] if limited_load else nums


def parse_info_cfg(path: str) -> Dict[str, str]:
    """Parse an ACDC Info.cfg ('key: value' lines)."""
    info: Dict[str, str] = {}
    with open(path) as f:
        for line in f:
            if ":" in line:
                k, v = line.split(":", 1)
                info[k.strip()] = v.strip()
    return info


# ---------------------------------------------------------------------------
# SR-segmentation test set
# ---------------------------------------------------------------------------

class ACDCSRSegImage:
    """One patient of the SR-segmentation evaluation set: a [frames, z,
    y, x] image NIfTI (ED/ES phases), optional label NIfTI, Info.cfg
    frame ids (reference: sr_seg_test/dataset.py:151-247
    ACDCTESTSRImage)."""

    def __init__(self, number: int, root_dir: str,
                 image_dir: str = "images_sr",
                 label_dir: Optional[str] = "ref_labels",
                 info_dir: Optional[str] = None,
                 rescale: bool = False, resample: bool = False,
                 file_suffix: str = ".nii.gz"):
        self.patient_id = f"patient{number:03d}"
        self._number = number
        self._rescale = rescale
        self._resample = resample and number not in _NO_RESAMPLE_PATIENTS
        img_path = os.path.join(root_dir, image_dir,
                                self.patient_id + file_suffix)
        self.im, sp, _ = read_image(img_path)
        self.im = np.asarray(self.im, np.float32)
        # spacing of a 4D nifti: keep the spatial (z, y, x) part
        self.original_spacing = np.asarray(sp, np.float64)[-3:]
        self.spacing = self.original_spacing.copy()
        self.lbl = None
        if label_dir is not None:
            lbl_path = os.path.join(root_dir, label_dir,
                                    self.patient_id + file_suffix)
            if os.path.isfile(lbl_path):
                self.lbl = np.asarray(read_image(lbl_path)[0], np.int32)
        self._info: Optional[Dict[str, str]] = None
        self._info_path = os.path.join(
            info_dir or os.path.join(root_dir, "info"),
            self.patient_id, "Info.cfg")

    def info(self) -> Dict[str, str]:
        if self._info is None:
            if os.path.isfile(self._info_path):
                self._info = parse_info_cfg(self._info_path)
            else:
                # SR eval sets store exactly two phases: ED=0, ES=1
                # (reference: sr_seg_test/dataset.py:43 "STRONG ASSUMPTION")
                self._info = {"ED": "0", "ES": "1"}
        return self._info

    def get_frame_id(self, phase: str) -> int:
        return int(self.info()[phase])

    def _frame_index(self, phase: str) -> int:
        fid = self.get_frame_id(phase)
        # 2-phase files: honor an Info.cfg that genuinely indexes the
        # two frames ({ED,ES} == {0,1} — derived sets can store ES
        # first); otherwise the metadata is the ORIGINAL acquisition's
        # 1-based frame numbering and position is the only valid map
        # (the reference's "STRONG ASSUMPTION", ED=0/ES=1)
        if self.im.ndim == 4 and self.im.shape[0] == 2:
            ids = {k: int(v) for k, v in self.info().items()
                   if k in ("ED", "ES")
                   and str(v).lstrip("-").isdigit()}
            if sorted(ids.get(k, -1) for k in ("ED", "ES")) == [0, 1]:
                return ids[phase]
            return 0 if phase == "ED" else 1
        if self.im.ndim == 4:
            # raw ACDC Info.cfg frame ids are 1-based (they match the
            # frameNN file numbering): detect the base from the smallest
            # id over the phases so ES == NbFrame indexes the last frame
            # instead of raising, while 0-based derived sets pass through
            ids = [int(v) for k, v in self.info().items()
                   if k in ("ED", "ES") and str(v).lstrip("-").isdigit()]
            base = 0 if (ids and min(ids) == 0) else 1
            idx = fid - base
            if not 0 <= idx < self.im.shape[0]:
                raise IndexError(
                    f"{self.patient_id}: Info.cfg {phase} frame {fid} "
                    f"(base {base}) outside 4D range "
                    f"[0, {self.im.shape[0]})")
            return idx
        return fid

    def phase(self, phase: str) -> Dict:
        idx = self._frame_index(phase)
        im = self.im[idx] if self.im.ndim == 4 else self.im
        gt = None
        if self.lbl is not None:
            gt = self.lbl[idx] if self.lbl.ndim == 4 else self.lbl
        spacing = self.original_spacing.copy()
        if self._rescale:
            im = rescale_intensities(im).astype(np.float32)
        # NOTE: the sub-millimeter clause bypasses both resample=False
        # and the patient029 pin — reference-faithful bug-for-bug
        # (sr_seg_test/dataset.py:205 has the identical `or` even though
        # its line 172-176 pinned 029's _resample to False)
        if self._resample or self.original_spacing[-1] < 1.0:
            im = apply_2d_zoom_3d(im, spacing, ACDC_NEW_SPACING,
                                  do_blur=True)
            if gt is not None:
                gt = apply_2d_zoom_3d(gt, spacing, ACDC_NEW_SPACING,
                                      order=0, do_blur=False,
                                      as_type=np.int32)
            spacing = np.array([self.original_spacing[0],
                                ACDC_NEW_SPACING[1], ACDC_NEW_SPACING[2]],
                               np.float64)
        self.spacing = spacing
        return {"image": im, "reference": gt, "spacing": spacing}

    def ed(self) -> Dict:
        return self.phase("ED")

    def es(self) -> Dict:
        return self.phase("ES")


def acdc_sr_seg_fold(fold: int, root_dir: str, dataset: str = "validation",
                     limited_load: bool = False, resample: bool = False,
                     patid: Optional[int] = None,
                     **image_kwargs) -> Iterator[Dict]:
    """Yield per-phase dicts of the SR-segmentation fold — the
    generator-style API the evaluation drivers consume
    (reference: sr_seg_test/dataset.py:18-52
    acdctestsr_validation_fold)."""
    if isinstance(patid, str):
        patid = int(patid.replace("patient", ""))
    # when a specific patient is requested, skip the limited_load
    # truncation — truncating first made valid fold members look absent
    nums = get_acdc_fold_patient_ids(
        fold, dataset, limited_load and patid is None, max_limit_load=3)
    if patid is not None:
        nums = [n for n in nums if n == patid]
        if not nums:
            raise ValueError(f"patid {patid} not in {dataset} fold {fold}")
    for num in nums:
        img = ACDCSRSegImage(num, root_dir, rescale=True,
                             resample=resample, **image_kwargs)
        for phase in ("ED", "ES"):
            d = img.phase(phase)
            yield {"image": d["image"], "reference": d["reference"],
                   "spacing": d["spacing"], "patient_id": img.patient_id,
                   "frame_id": img.get_frame_id(phase),
                   "cardiac_phase": phase,
                   "original_spacing": img.original_spacing}


def load_acdc_sr_seg_slices(fold: int, root_dir: str,
                            dataset: str = "validation",
                            limited_load: bool = False,
                            resample: bool = False,
                            **image_kwargs) -> List[Dict]:
    """Flat per-slice sample list (the reference's Dataset __getitem__
    contract, sr_seg_test/dataset.py:135-150): one dict per (patient,
    phase, slice)."""
    samples: List[Dict] = []
    for d in acdc_sr_seg_fold(fold, root_dir, dataset, limited_load,
                              resample, **image_kwargs):
        for s in range(d["image"].shape[0]):
            samples.append({
                "image": d["image"][s], "spacing": d["spacing"],
                # per-slice reference labels — the whole point of the
                # SR-segmentation test set (sr_seg_test/dataset.py:46)
                "reference": (d["reference"][s]
                              if d.get("reference") is not None else None),
                "cardiac_phase": d["cardiac_phase"],
                "frame_id": d["frame_id"],
                "patient_id": d["patient_id"],
                "original_spacing": d["original_spacing"],
            })
    return samples


# ---------------------------------------------------------------------------
# uncertainty-map / prediction loaders (reference: datasets/ACDC/get_data.py)
# ---------------------------------------------------------------------------

_UNCERTAINTY_DIRS = {
    "pred_labels": "pred_labels",
    "pred_probs": "pred_probs",
    "umaps": "umaps",
    "ref_labels": "ref_labels",
    "images": "images",
}
_MC_SUFFIX = "_mc"


def _uncertainty_glob(src_data_path: str, kind: str, cardiac_phase: str,
                      mc_dropout: bool = False,
                      patient_id: Optional[str] = None) -> str:
    # the '_mc' suffix marks MC-dropout MODEL OUTPUTS; input images and
    # ground-truth labels have no MC variants in the get_data.py layout
    has_mc = kind in ("pred_labels", "pred_probs", "umaps")
    d = _UNCERTAINTY_DIRS[kind] + (_MC_SUFFIX if mc_dropout and has_mc
                                   else "")
    pat = patient_id if patient_id else "*"
    return os.path.join(src_data_path, d, f"{pat}_{cardiac_phase}.nii.gz")


def _load_kind(src_data_path: str, kind: str, cardiac_phase: str,
               mc_dropout: bool = False,
               patient_id: Optional[str] = None,
               one_hot: bool = False, nclasses: int = 4,
               meta_info: bool = False) -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    pattern = _uncertainty_glob(src_data_path, kind, cardiac_phase,
                                mc_dropout, patient_id)
    for path in sorted(glob.glob(pattern)):
        pid = os.path.basename(path).replace(f"_{cardiac_phase}.nii.gz", "")
        arr, spacing, _ = read_image(path)
        if kind in ("pred_labels", "ref_labels"):
            arr = np.asarray(arr, np.int32)
            if one_hot:
                arr = (arr[None] == np.arange(nclasses)[:, None, None, None]
                       ).astype(np.float32)
        else:
            arr = np.asarray(arr, np.float32)
        out[pid] = ({"data": arr, "spacing": np.asarray(spacing)}
                    if meta_info else arr)
    return out


def load_uncertainty_data(src_data_path: str, cardiac_phase: str,
                          type_of_data, mc_dropout: bool = False,
                          patient_id: Optional[str] = None,
                          one_hot: bool = False, nclasses: int = 4,
                          meta_info: bool = False) -> Dict:
    """Load any combination of pred_labels / pred_probs / umaps /
    ref_labels / images keyed by patient id
    (reference: datasets/ACDC/get_data.py:32-110 load_data). Directory
    layout: ``<src>/<kind>[_mc]/<patient>_<ED|ES>.nii.gz``."""
    if not isinstance(type_of_data, (list, tuple)):
        type_of_data = [type_of_data]
    result: Dict = {"src_data_path": src_data_path,
                    "mc_dropout": mc_dropout,
                    "cardiac_phase": cardiac_phase}
    for kind in type_of_data:
        if kind not in _UNCERTAINTY_DIRS:
            raise ValueError(f"unknown data type {kind!r}")
        result[kind] = _load_kind(src_data_path, kind, cardiac_phase,
                                  mc_dropout, patient_id, one_hot,
                                  nclasses, meta_info)
    return result


# ---------------------------------------------------------------------------
# centered-dataset generation
# (reference: datasets/ACDC/generate_centered_dataset.py)
# ---------------------------------------------------------------------------

def center_of_mass_segmentation(labels: np.ndarray, lv_lbl: int = 3,
                                rv_lbl: int = 1) -> Tuple[np.ndarray, np.ndarray]:
    masks = {"LV": labels == lv_lbl, "RV": labels == rv_lbl}
    for name, m in masks.items():
        if not m.any():
            # an empty structure would make center_of_mass return NaN,
            # which np.round(...).astype(int) turns into INT64_MIN-scale
            # garbage indices far from the real cause
            raise ValueError(
                f"center_of_mass_segmentation: no {name} voxels "
                f"(labels present: {sorted(np.unique(labels).tolist())})")
    cms_lv = np.round(scipy.ndimage.center_of_mass(masks["LV"])).astype(int)
    cms_rv = np.round(scipy.ndimage.center_of_mass(masks["RV"])).astype(int)
    return cms_lv, cms_rv


def centering_rotation_degrees(cms_lv: np.ndarray,
                               cms_rv: np.ndarray) -> float:
    """Rotation (degrees, scipy.ndimage.rotate convention) that puts the
    LV–RV axis horizontal with RV LEFT of LV in every quadrant.

    The reference formula (generate_centered_dataset.py:17-28) uses
    absolute deltas with a y-only sign rule, which flattens only two of
    the four quadrant configurations and never enforces its own
    documented "RV left of LV" 180-degree normalisation; this signed
    form agrees with the reference where the reference is correct and
    fixes the other quadrants. cms vectors are [z, y, x]."""
    dy = float(cms_rv[1]) - float(cms_lv[1])
    dx = float(cms_rv[2]) - float(cms_lv[2])
    theta = np.degrees(np.arctan2(dy, dx))   # axis angle in (y, x)
    degree = theta - 180.0                   # rotate(+d) maps θ → θ - d
    while degree <= -180.0:
        degree += 360.0
    while degree > 180.0:
        degree -= 360.0
    return float(degree)


def _rotate_then_center(sl: np.ndarray, degrees: float,
                        target_center: np.ndarray,
                        border_value: float) -> np.ndarray:
    rot = scipy.ndimage.rotate(sl, degrees, reshape=False, order=1,
                               mode="constant", cval=border_value)
    shift = (np.asarray(sl.shape) * 0.5).astype(int) - target_center
    return scipy.ndimage.shift(rot, shift, order=1, mode="constant",
                               cval=border_value)


def center_4d_volume(img4d: np.ndarray,
                     labels3d: np.ndarray) -> np.ndarray:
    """Rotate + translate all frames/slices so the LV/RV midpoint is at
    the in-plane center (reference: generate_centered_dataset.py:59-113).
    ``labels3d``: ES segmentation [z, y, x]."""
    cms_lv, cms_rv = center_of_mass_segmentation(labels3d)
    avg_cms = (0.5 * (cms_lv + cms_rv)).astype(int)
    degrees = centering_rotation_degrees(cms_lv, cms_rv)
    # rotated position of the midpoint: rotate a delta image and locate it
    dummy = np.zeros(labels3d.shape[1:], np.float32)
    dummy[avg_cms[1], avg_cms[2]] = 1.0
    dummy_rot = scipy.ndimage.rotate(dummy, degrees, reshape=False,
                                     order=1, mode="constant")
    ys, xs = np.nonzero(dummy_rot > 1e-6)
    if ys.size == 0:
        # the midpoint rotated out of the frame (corner anatomy + a
        # large centering angle): int(mean([])) would die on a cryptic
        # NaN-conversion — name the real cause
        raise ValueError(
            f"center_4d_volume: the LV/RV midpoint {tuple(avg_cms[1:])} "
            f"leaves the field of view under the {degrees:.1f} deg "
            f"centering rotation — segmentation too close to the "
            f"image border to center")
    new_cms = np.array([int(np.mean(ys)), int(np.mean(xs))])

    out = np.zeros_like(img4d, np.float32)
    for f in range(img4d.shape[0]):
        for s in range(img4d.shape[1]):
            sl = img4d[f, s].astype(np.float32)
            out[f, s] = _rotate_then_center(sl, degrees, new_cms,
                                            float(sl.min()))
    return out


def create_centered_dataset(src_dir: str, out_dir: str,
                            patient_ids: Optional[Sequence[str]] = None
                            ) -> List[str]:
    """Write centered copies of every ``<pat>/<pat>_4d.nii.gz``
    (ES labels from ``<pat>_frame01_gt.nii.gz``, falling back to frame04
    like the reference's patient090 special case)."""
    os.makedirs(out_dir, exist_ok=True)
    if patient_ids is None:
        patient_ids = sorted(
            os.path.basename(p) for p in glob.glob(
                os.path.join(src_dir, "patient*")) if os.path.isdir(p))
    written = []
    for pid in patient_ids:
        pat_dir = os.path.join(src_dir, pid)
        fname_img = os.path.join(pat_dir, f"{pid}_4d.nii.gz")
        fname_es = os.path.join(pat_dir, f"{pid}_frame01_gt.nii.gz")
        if not os.path.isfile(fname_es):
            fname_es = os.path.join(pat_dir, f"{pid}_frame04_gt.nii.gz")
        img4d, spacing, _ = read_image(fname_img)
        labels, _, _ = read_image(fname_es)
        centered = center_4d_volume(np.asarray(img4d, np.float32),
                                    np.asarray(labels, np.int32))
        pat_out = os.path.join(out_dir, pid)
        os.makedirs(pat_out, exist_ok=True)
        out_path = os.path.join(pat_out, f"{pid}_4d.nii.gz")
        write_image(out_path, centered, spacing=np.asarray(spacing)[-3:])
        written.append(out_path)
    return written


# ---------------------------------------------------------------------------
# label-only volumes for label-interpolation experiments
# (reference: datasets/ACDC/data_simple.py ACDCLabels)
# ---------------------------------------------------------------------------

def normalize_cardiac_label(labels: np.ndarray,
                            cardiac_label: Optional[int] = None
                            ) -> np.ndarray:
    """One structure → intensity 2.0, everything else 0
    (reference: data_simple.py:215-218 _normalize_labels); with
    ``cardiac_label=None`` all foreground labels keep their value."""
    labels = np.asarray(labels)
    if cardiac_label is None:
        return labels.astype(np.float32)
    out = np.zeros(labels.shape, np.float32)
    out[labels == cardiac_label] = 2.0
    return out


def load_acdc_label_volumes(root_dir: str, fold: int = 0,
                            dataset: str = "training",
                            cardiac_label: Optional[int] = None,
                            resample: bool = True,
                            limited_load: bool = False) -> List[Dict]:
    """Per-(patient, frame) LABEL volumes for label-SR experiments
    (reference: data_simple.py:77-292 ACDCLabels — slices of one cardiac
    structure, trained like images). Reads every
    ``patientXXX/patientXXX_frameYY_gt.nii.gz`` of the fold split,
    optionally resamples in-plane to 1.4 mm (order 0) and normalizes the
    chosen structure to intensity 2.0. Feed the returned volumes to the
    standard TripletSampler for training."""
    nums = get_acdc_fold_patient_ids(fold, dataset, limited_load,
                                     max_limit_load=3)
    out: List[Dict] = []
    for num in nums:
        pid = f"patient{num:03d}"
        for path in sorted(glob.glob(os.path.join(
                root_dir, pid, f"{pid}_frame*_gt.nii.gz"))):
            lbl, spacing, _ = read_image(path)
            lbl = np.asarray(lbl, np.int32)
            spacing = np.asarray(spacing, np.float64)[-3:]
            if resample:
                lbl = apply_2d_zoom_3d(lbl, spacing, ACDC_NEW_SPACING,
                                       order=0, do_blur=False,
                                       as_type=np.int32)
                spacing = np.array([spacing[0], ACDC_NEW_SPACING[1],
                                    ACDC_NEW_SPACING[2]])
            frame = os.path.basename(path).split("_frame")[1].split("_")[0]
            out.append({
                "image": normalize_cardiac_label(lbl, cardiac_label),
                "labels": lbl, "spacing": spacing, "patient_id": pid,
                "frame_id": int(frame),
            })
    return out
