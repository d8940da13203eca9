"""Dataset builders of the train and find-best commands: the on-disk brain
and cardiac loaders with their split files, and the synthetic toys.

Port of ``superresolution_aniso_mri_tpu/data/datasets.py`` (reference:
datasets/common_brains.py:160-226 get_images, datasets/ACDC/data.py and
data4d_simple.py, datasets/OASIS/dataset.py:104-122): the same patient
ids in the same order, the same arrays bit for bit. Files are decoded by
a thread pool over ``utils/nifti.py::read_image``. Split files are read
and written without pyyaml (``config/settings.py``).

ACDCLBL reads the labeled ED/ES frames (``patientXXX_frameYY.nii.gz``
and their ``_gt`` label maps) beside ACDC's 4D cines. The eval-only
loaders (``load_sunnybrook_volumes``, ``load_arvc_volumes``,
``load_sax_volumes``) and the dHCP preparation (``create_dhcp_dataset``)
are copies of JAX's, registered in ``get_datasets`` no more than there.
"""
from __future__ import annotations

import glob
import os
import re
import warnings
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import scipy.ndimage as ndi

from ..config.data_config import get_config
from ..config.settings import load_string_lists, save_string_lists
from ..utils.nifti import read_image, write_image
from .synthetic import make_toy_dataset
from .transforms import pad_to_size
from .volume import (Volume, apply_2d_zoom_3d, apply_2d_zoom_4d,
                     create_lr_volume, rescale_intensities)


# ---------------------------------------------------------------------------
# generic helpers
# ---------------------------------------------------------------------------

def _find_files(root: str, suffix: str) -> List[str]:
    hits = []
    for dirpath, _dirs, files in os.walk(os.path.expanduser(root)):
        for f in files:
            if f.endswith(suffix):
                hits.append(os.path.join(dirpath, f))
    hits.sort()
    return hits


def _patient_id_from_file(dataset: str, path: str,
                          root: Optional[str] = None) -> str:
    name = os.path.basename(path)
    if dataset == "OASIS":
        return "_".join(name.split("_")[:3])
    if dataset == "dHCP":
        return name.split("_")[0]
    if dataset == "ADNI":
        # the first directory below the dataset root is the patient, the
        # one above the file the scan (common_brains.py:120-128)
        if root:
            rel = os.path.relpath(os.path.normpath(path),
                                  os.path.expanduser(root))
            parts = [p for p in rel.split(os.sep) if p not in ("", ".")]
            if len(parts) >= 3:
                return parts[0] + "_" + parts[-2]
            if len(parts) == 2:
                return parts[0]
        return os.path.splitext(name)[0].replace(".nii", "")
    stem = os.path.splitext(name)[0].replace(".nii", "")
    if dataset in ("ACDC", "ACDCC", "ARVC") and stem.endswith("_4d"):
        # 'patient001_4d.nii.gz' → 'patient001', the split files' ids
        stem = stem[:-3]
    return stem


def _split_patients(patient_ids: Sequence[str], split_file: Optional[str],
                    ratios=(0.8, 0.1, 0.1), seed: int = 1234
                    ) -> Dict[str, List[str]]:
    """The on-disk split file when there is one, else a seeded split that
    keeps at least one validation and one test patient of three or
    more."""
    if split_file and os.path.isfile(os.path.expanduser(split_file)):
        split = load_string_lists(os.path.expanduser(split_file))
        return {k: [str(p) for p in v] for k, v in split.items()}
    ids = sorted(set(str(p) for p in patient_ids))
    rs = np.random.RandomState(seed)
    perm = rs.permutation(len(ids))
    n_tr = int(len(ids) * ratios[0])
    n_va = int(len(ids) * ratios[1])
    if len(ids) >= 3:
        n_va = max(n_va, 1)
        n_tr = max(1, min(n_tr, len(ids) - n_va - 1))
    return {
        "training": [ids[i] for i in perm[:n_tr]],
        "validation": [ids[i] for i in perm[n_tr:n_tr + n_va]],
        "test": [ids[i] for i in perm[n_tr + n_va:]],
    }


def _warn_empty_split(dataset, split, n_files, splits):
    warnings.warn(
        f"{dataset}: split {split!r} selected 0 of {n_files} "
        f"volumes (split keys: {sorted(splits)}; check the split "
        f"file's patient ids)", stacklevel=3)


def _read_images_parallel(paths) -> Dict[str, tuple]:
    """{path: (array, spacing, affine)}, decoded by a thread pool (gzip
    inflation releases the interpreter lock). The native loader's
    ingest (``data/native_loader.py::read_nifti_many``, which JAX's
    loader calls here) gives the same bits but measured slower than
    this pool on an H100 machine's 8-core host (PERF.md, phase 17b)."""
    paths = list(paths)
    if len(paths) <= 1:
        return {p: read_image(p) for p in paths}
    with ThreadPoolExecutor(max_workers=min(8, len(paths))) as pool:
        return dict(zip(paths, pool.map(read_image, paths)))


# ---------------------------------------------------------------------------
# brain datasets (OASIS / dHCP / ADNI / brainMASI)
# ---------------------------------------------------------------------------

def load_brain_volumes(dataset: str, downsample_steps: int,
                       split: str = "training",
                       limited_load: bool = False,
                       include_hr_images: bool = False,
                       rescale_int: bool = True,
                       src_path: Optional[str] = None) -> List[Volume]:
    """The pre-blurred synthetic-LR volumes of one split (reference:
    common_brains.py:160-226 get_images), rescaled to [0, 1] (min-max)
    unless ``rescale_int`` is False. brainMASI's split is its
    ``Training/`` and ``Test/`` directories ('validation' reads
    ``Test/``)."""
    cfg = get_config(dataset)
    root = src_path or cfg.image_dir
    suffix = cfg.lr_file_suffix(downsample_steps)
    files = _find_files(root, suffix)
    if not files:
        raise FileNotFoundError(
            f"no '*{suffix}' volumes under {root} for {dataset}")
    dir_split_applied = False
    if dataset == "brainMASI":
        want_dir = ("training" if split == "training" else "test")

        # only directories below the data root count: an ancestor named
        # 'test' would match every file
        def _parts_below_root(f):
            rel = os.path.relpath(os.path.abspath(f),
                                  os.path.abspath(root))
            return {p.lower() for p in rel.split(os.sep)}

        by_dir = [f for f in files if want_dir in _parts_below_root(f)]
        has_split_dirs = any(
            d in _parts_below_root(f) for f in files
            for d in ("training", "test"))
        if by_dir:
            files = by_dir
            dir_split_applied = True
        elif has_split_dirs:
            raise FileNotFoundError(
                f"brainMASI: no '{want_dir}' directory with *{suffix} "
                f"volumes under {root} for split {split!r}")
    pids = [_patient_id_from_file(dataset, f, root) for f in files]
    if dir_split_applied:
        sel = list(zip(pids, files))
    else:
        splits = _split_patients(pids, cfg.split_file)
        wanted = set(splits.get(split, []))
        sel = [(p, f) for p, f in zip(pids, files) if p in wanted]
        if not sel:
            _warn_empty_split(dataset, split, len(files), splits)
    if limited_load:
        sel = sel[:cfg.limited_load_max]
    reads = {path: None for _, path in sel}
    if include_hr_images:
        for _, path in sel:
            hr_path = path.replace(suffix, cfg.img_file_ext)
            if os.path.isfile(hr_path):
                reads[hr_path] = None
    decoded = _read_images_parallel(reads)
    volumes = []
    for pid, path in sel:
        arr, spacing, _ = decoded[path]
        arr = arr.astype(np.float32)
        if rescale_int:
            arr = rescale_intensities(arr, percs=(0, 100))
        hr = None
        if include_hr_images:
            hr_path = path.replace(suffix, cfg.img_file_ext)
            # where the LR suffix is the extension (brainMASI), the "HR"
            # file would be the input itself
            if hr_path != path and hr_path in decoded:
                hr = decoded[hr_path][0].astype(np.float32)
                if rescale_int:
                    hr = rescale_intensities(hr, percs=(0, 100))
        volumes.append(Volume(image=arr, spacing=spacing, patient_id=pid,
                              image_hr=hr))
    return volumes


def create_lr_dataset(dataset: str, downsample_steps: int,
                      src_path: Optional[str] = None,
                      out_path: Optional[str] = None) -> List[str]:
    """Write the blurred synthetic-LR volume next to each HR one (or into
    ``out_path``); returns the written paths (reference:
    OASIS/dataset.py:104-122, dHCP/dataset.py:14-36)."""
    cfg = get_config(dataset)
    if cfg.lr_file_suffix(downsample_steps) == cfg.img_file_ext:
        raise ValueError(
            f"{dataset} trains from HR volumes (downsampling happens at "
            f"sample time) — there is no LR file convention, and writing "
            f"one would overwrite the source volumes in place")
    root = src_path or cfg.image_dir
    files = _find_files(root, cfg.img_file_ext)
    # never re-ingest earlier LR outputs ('_Kmm' + the extension)
    lr_pat = re.compile(r"_\d+(\.\d+)?mm" + re.escape(cfg.img_file_ext)
                        + r"$")
    files = [f for f in files if not lr_pat.search(os.path.basename(f))]
    if out_path:
        out_path = os.path.expanduser(out_path)
        os.makedirs(out_path, exist_ok=True)
    written = []
    suffix = cfg.lr_file_suffix(downsample_steps)
    for path in files:
        arr, spacing, affine = read_image(path)
        lr = create_lr_volume(arr.astype(np.float32), downsample_steps,
                              subsample=False)
        out = path.replace(cfg.img_file_ext, suffix)
        if out_path:
            out = os.path.join(out_path, os.path.basename(out))
        write_image(out, lr.astype(np.float32), spacing=spacing,
                    affine=affine)
        written.append(out)
    return written


def create_split_file(out_path: str, patid_list: Sequence[str],
                      num_split=(200, 20, 20), seed: int = 1234) -> str:
    """Write ``train_test_split.yaml`` (training / test / validation patient
    ids, shuffled with ``seed``) into ``out_path``, byte for byte as the
    JAX package writes it (reference: dHCP/create_dataset.py:139-166)."""
    rs = np.random.RandomState(seed)
    ids = list(patid_list)
    rs.shuffle(ids)
    n_tr, n_te, n_va = num_split
    split = {
        "training": ids[:n_tr],
        "test": ids[n_tr:n_tr + n_te],
        "validation": ids[n_tr + n_te:n_tr + n_te + n_va],
    }
    fname = os.path.join(os.path.expanduser(out_path),
                         "train_test_split.yaml")
    save_string_lists(split, fname)
    return fname


# ---------------------------------------------------------------------------
# cardiac (ACDC 4D)
# ---------------------------------------------------------------------------

# native 5 mm slices: the SR test split (reference: datasets/ACDC/data.py:21-23)
ACDC_5MM_PATIENTS = (4, 5, 9, 18, 54, 63, 69, 75, 79, 80, 90, 94)

# frames with invalid intensities to drop per patient
# (reference: datasets/ACDC/data.py:475-485)
ACDC_BAD_FRAME_LIMITS = {"patient015": 20, "patient034": 20,
                         "patient045": 20}


def acdc_frame_limit(patient_id: str) -> Optional[int]:
    for pid, limit in ACDC_BAD_FRAME_LIMITS.items():
        if pid in str(patient_id):
            return limit
    return None


def acdc_default_split(pids) -> Dict[str, List[str]]:
    """The reference's ACDC SR split when no split file exists: the 12
    native-5 mm patients test, 70 of the rest train (seeded), the rest
    validate (reference: datasets/ACDC/data.py:163-195)."""
    five = {f"patient{p:03d}" for p in ACDC_5MM_PATIENTS}
    ids = sorted(set(str(p) for p in pids))
    test = [p for p in ids if p in five]
    rest = [p for p in ids if p not in five]
    rs = np.random.RandomState(1234)
    perm = rs.permutation(len(rest))
    n_tr = min(70, len(rest))
    return {
        "training": sorted(rest[i] for i in perm[:n_tr]),
        "validation": sorted(rest[i] for i in perm[n_tr:]),
        "test": test,
    }


def load_acdc_volumes(split: str = "training",
                      limited_load: bool = False,
                      resample: bool = True,
                      rescale: bool = True,
                      src_path: Optional[str] = None,
                      frame_limit: Optional[int] = None,
                      dataset: str = "ACDC") -> List[Volume]:
    """ACDC 4D cine volumes, one ``Volume`` per frame (pairs never cross
    frames; reference: datasets/ACDC/data4d_simple.py:131-240), each frame
    resampled in-plane to 1.4 mm with an anti-alias blur and rescaled to
    its 1st-99th percentiles (ACDCImage.preprocessed4d, data.py:471-506)."""
    cfg = get_config(dataset)
    root = src_path or cfg.image_dir
    files = _find_files(root, "4d.nii.gz") or _find_files(root, ".nii.gz")
    if not files:
        raise FileNotFoundError(f"no {dataset} volumes under {root}")
    pids = [_patient_id_from_file(dataset, f, root) for f in files]
    if dataset in ("ACDC", "ACDCC") and not (cfg.split_file and os.path.isfile(
            os.path.expanduser(cfg.split_file))):
        splits = acdc_default_split(pids)
    else:
        splits = _split_patients(pids, cfg.split_file)
    wanted = set(splits.get(split, []))
    sel = [(p, f) for p, f in zip(pids, files) if p in wanted]
    if not sel:
        _warn_empty_split(dataset, split, len(files), splits)
    if limited_load:
        sel = sel[:cfg.limited_load_max]
    decoded = _read_images_parallel([p for _, p in sel])
    volumes: List[Volume] = []
    for pid, path in sel:
        arr, spacing, _ = decoded[path]
        arr = arr.astype(np.float32)
        if arr.ndim == 3:
            arr = arr[None]
        if frame_limit:
            arr = arr[:frame_limit]
        bad_limit = (acdc_frame_limit(pid)
                     if dataset in ("ACDC", "ACDCC") else None)
        if bad_limit is not None:
            arr = arr[:bad_limit]
        original_spacing = np.asarray(spacing, np.float64)[-3:]
        spacing = original_spacing.copy()
        if resample and cfg.voxel_spacing_resample is not None:
            arr = apply_2d_zoom_4d(arr, spacing[-2:],
                                   cfg.voxel_spacing_resample)
            spacing[1:] = np.asarray(cfg.voxel_spacing_resample,
                                     np.float64)[-2:]
        for t in range(arr.shape[0]):
            frame = arr[t]
            if rescale:
                frame = rescale_intensities(frame, percs=(1, 99))
            volumes.append(Volume(
                image=frame.astype(np.float32), spacing=spacing.copy(),
                patient_id=f"{pid}_f{t:02d}",
                original_spacing=original_spacing.copy(),
                frame_id=t, num_frames=int(arr.shape[0])))
    return volumes


def load_acdc_labeled_volumes(split: str = "training",
                              limited_load: bool = False,
                              src_path: Optional[str] = None) -> List[Volume]:
    """ACDC's labeled ED/ES frames for the ACDCLBL multi-channel model
    (reference: datasets/ACDC/data_with_labels.py:14-276), one ``Volume``
    per frame with its ``labels``: every ``*frame*.nii.gz`` under the
    ACDC root that is not a ``_gt`` map (so the ``_4d`` cines beside
    them are not read), its ``_gt`` companion as int32 labels when there
    is one. Both are resampled in-plane to 1.4 mm (the labels with an
    order-0 lookup, no blur) and the image is rescaled to its 1st-99th
    percentiles. Without a split file the default ACDC split keeps the
    12 native-5 mm SR test patients out."""
    cfg = get_config("ACDCLBL")
    root = src_path or cfg.image_dir
    img_files = [f for f in _find_files(root, ".nii.gz")
                 if "_gt" not in f and "frame" in os.path.basename(f)]
    if not img_files:
        raise FileNotFoundError(f"no labeled ACDC frames under {root}")
    pids = [_patient_id_from_file("ACDC", f).split("_")[0]
            for f in img_files]
    if not (cfg.split_file and os.path.isfile(
            os.path.expanduser(cfg.split_file))):
        splits = acdc_default_split(pids)
    else:
        splits = _split_patients(pids, cfg.split_file)
    wanted = set(splits.get(split, []))
    sel = [(p, f) for p, f in zip(pids, img_files) if p in wanted]
    if limited_load:
        sel = sel[:cfg.limited_load_max]
    gt_of = {p: p.replace(".nii.gz", "_gt.nii.gz") for _, p in sel}
    decoded = _read_images_parallel(
        [p for _, p in sel] + [g for g in gt_of.values() if os.path.isfile(g)])
    volumes = []
    for _pid, path in sel:
        arr, spacing, _ = decoded[path]
        arr = arr.astype(np.float32)
        spacing = np.asarray(spacing, np.float64)
        labels = None
        if gt_of[path] in decoded:
            labels = decoded[gt_of[path]][0].astype(np.int32)
        if cfg.voxel_spacing_resample is not None:
            new_sp = np.asarray(cfg.voxel_spacing_resample, np.float64)
            arr = apply_2d_zoom_3d(arr, spacing[-2:], new_sp)
            if labels is not None:
                labels = apply_2d_zoom_3d(labels, spacing[-2:], new_sp,
                                          do_blur=False, order=0,
                                          as_type=np.int32)
            spacing = spacing.copy()
            spacing[1:] = new_sp[-2:]
        arr = rescale_intensities(arr, percs=(1, 99))
        volumes.append(Volume(
            image=arr, spacing=spacing,
            patient_id=os.path.basename(path).replace(".nii.gz", ""),
            labels=labels))
    return volumes


# ---------------------------------------------------------------------------
# dispatcher of the train and find-best commands
# ---------------------------------------------------------------------------

def get_datasets(args: Dict) -> Tuple[List[Volume], List[Volume]]:
    """(train, validation) volume lists for a settings dict.

    ``use_synthetic_data`` (and the MNIST toys) route to the procedural
    toy backend: ``4`` (``limited_load``) or 12 training volumes and 2
    validation volumes of ``8 * downsample_steps + 1`` slices at
    ``aug_patch_size or width``, seeded from ``seed``. OASIS, dHCP, ADNI
    and brainMASI read their synthetic-LR volumes, ACDC and ACDCC their
    4D cines, ACDCLBL its labeled ED/ES frames, from ``$SR_DATA_ROOT``."""
    dataset = args["dataset"]
    ds = int(args.get("downsample_steps") or 2)
    limited = bool(args.get("limited_load", False))

    if args.get("use_synthetic_data") or dataset in ("MNIST3D", "MNISTRoto"):
        width = int(args.get("aug_patch_size") or args.get("width", 64))
        n_train = 4 if limited else 12
        mnist_path = args.get("mnist_path")
        train = make_toy_dataset(n_train, size=width, num_slices=8 * ds + 1,
                                 seed=int(args.get("seed", 0)) % 100000,
                                 mnist_path=mnist_path,
                                 mnist_split="train")
        val = make_toy_dataset(2, size=width, num_slices=8 * ds + 1,
                               seed=int(args.get("seed", 0)) % 100000 + 999,
                               mnist_path=mnist_path, mnist_split="val")
        if dataset == "ACDCLBL":
            # the multichannel model needs a label channel: quantize the
            # phantom intensities into 4 pseudo-structures
            for vol in train + val:
                vol.labels = np.digitize(
                    vol.image, [0.25, 0.5, 0.75]).astype(np.int32)
        return train, val

    if dataset in ("OASIS", "dHCP", "ADNI", "brainMASI"):
        train = load_brain_volumes(dataset, ds, "training",
                                   limited_load=limited)
        val = load_brain_volumes(dataset, ds, "validation",
                                 limited_load=limited)
        return train, val

    if dataset == "ACDCLBL":
        train = load_acdc_labeled_volumes("training", limited_load=limited)
        val = load_acdc_labeled_volumes("validation", limited_load=limited)
        return train, val

    if dataset in ("ACDC", "ACDCC"):
        train = load_acdc_volumes("training", limited_load=limited)
        val = load_acdc_volumes("validation", limited_load=limited)
        return train, val

    raise ValueError(f"unknown dataset {dataset!r}")


# ---------------------------------------------------------------------------
# eval-only cardiac loaders (sunnybrook / ARVC / SAX) and dHCP preprocessing
# ---------------------------------------------------------------------------

SUNNYBROOK_SPACING = (8.0, 1.25, 1.25)


def load_sunnybrook_volumes(src_path: Optional[str] = None,
                            resample: bool = True,
                            rescale: bool = True,
                            limited_load: bool = False,
                            file_suffix: str = "_ES.mhd") -> List[Volume]:
    """Sunnybrook ED/ES short-axis MetaImage volumes (eval-only dataset;
    reference: datasets/sunnybrook/dataset.py:10-60 — fixed 8x1.25x1.25mm
    spacing, x-flip, optional 1.4mm in-plane resample + 1-99 rescale)."""
    cfg = get_config("sunnybrook")
    root = src_path or cfg.image_dir
    files = sorted(glob.glob(os.path.join(os.path.expanduser(root),
                                          "*" + file_suffix)))
    if not files:
        raise FileNotFoundError(f"no '*{file_suffix}' under {root}")
    if limited_load:
        files = files[:cfg.limited_load_max]
    volumes = []
    for fname in files:
        base = os.path.basename(fname)
        pid = base.replace(file_suffix, "")
        # anchored suffix swap on the BASENAME — a path component or
        # patient id containing 'ES' must not be rewritten. The phase
        # label comes FROM the suffix: a hardcoded 'ES' would mislabel
        # every volume of an ED-suffixed load (and a phase-less suffix
        # has no companion to derive)
        first = ("ES" if "ES" in file_suffix
                 else "ED" if "ED" in file_suffix else "")
        other = {"ES": "ED", "ED": "ES"}.get(first)
        phases = [(first, fname)]
        if other:
            comp_name = (base[: -len(file_suffix)]
                         + file_suffix.replace(first, other))
            comp_path = os.path.join(os.path.dirname(fname), comp_name)
        else:
            comp_path = None
        if comp_path and os.path.isfile(comp_path):
            phases.append((other, comp_path))
        elif comp_path:
            warnings.warn(f"sunnybrook: no {other} companion for {base} "
                          f"— loading {first} phase only", stacklevel=2)
        for phase, path in phases:
            arr, _sp, _ = read_image(path)
            arr = np.flip(arr.astype(np.float32), axis=2).copy()
            spacing = np.asarray(SUNNYBROOK_SPACING, np.float64)
            if resample and cfg.voxel_spacing_resample is not None:
                arr = apply_2d_zoom_3d(arr, spacing[-2:],
                                       cfg.voxel_spacing_resample)
                spacing = np.array([spacing[0],
                                    *cfg.voxel_spacing_resample], np.float64)
            if rescale:
                arr = rescale_intensities(arr, percs=(1, 99))
            volumes.append(Volume(image=arr.astype(np.float32),
                                  spacing=spacing,
                                  patient_id=(f"{pid}_{phase}" if phase
                                              else pid)))
    return volumes


def load_arvc_volumes(split: str = "training", limited_load: bool = False,
                      src_path: Optional[str] = None) -> List[Volume]:
    """ARVC 4D cardiac pairs — same per-frame pipeline as ACDC
    (reference: datasets/ARVC/dataset_sr.py, a subclass of the ACDC 4D
    pairs dataset)."""
    cfg = get_config("ARVC")
    root = src_path or cfg.image_dir
    return load_acdc_volumes(split=split, limited_load=limited_load,
                             src_path=root, dataset="ARVC")


def create_dhcp_dataset(src_path: str, out_path: str,
                        patch_size: int = 256,
                        background_threshold: float = 0.05) -> List[str]:
    """Crop raw dHCP volumes to the brain bounding box, zero the
    background, pad to patch_size and save
    (reference: datasets/dHCP/create_dataset.py:87-136 — the original
    uses nilearn's background mask; here a percentile-threshold mask
    (same outcome: brain bbox + zeroed background) since nilearn is not
    available)."""
    src_path = os.path.expanduser(src_path)
    out_path = os.path.expanduser(out_path)
    os.makedirs(out_path, exist_ok=True)
    written = []
    for path in _find_files(src_path, ".nii.gz"):
        arr, spacing, _ = read_image(path)
        arr = arr.astype(np.float32)
        thr = background_threshold * np.percentile(arr, 99)
        mask = ndi.binary_fill_holes(
            ndi.binary_closing(arr > thr, iterations=2))
        if not mask.any():
            continue
        nz = np.nonzero(mask)
        sl = tuple(slice(int(a.min()), int(a.max()) + 1) for a in nz)
        cropped = np.where(mask[sl], arr[sl], 0.0).astype(np.float32)
        cropped = pad_to_size(cropped, patch_size)
        pid = _patient_id_from_file("dHCP", path)
        if os.path.basename(path).endswith("t2w.nii.gz"):
            out = os.path.join(out_path, os.path.basename(path))
        else:
            out = os.path.join(out_path, f"{pid}_t2w.nii.gz")
        if out in written or os.path.isfile(out):
            # several sessions/files of the same subject must not
            # silently overwrite each other — BOTH branches (same-named
            # t2w files from different source subdirs collide too):
            # uniquify from the full source stem, then a counter
            stem = os.path.basename(path)
            for ext in (".nii.gz", ".nii"):
                if stem.endswith(ext):
                    stem = stem[: -len(ext)]
                    break
            out = os.path.join(out_path, f"{stem}_t2w.nii.gz")
            k = 2
            while out in written or os.path.isfile(out):
                out = os.path.join(out_path,
                                   f"{stem}_{k}_t2w.nii.gz")
                k += 1
        write_image(out, cropped, spacing=spacing)
        written.append(out)
    return written


def load_sax_volumes(root_dir: str, file_suffix: str = ".nii.gz",
                     resample: bool = True, rescale: bool = True,
                     new_spacing=(1.4, 1.4),
                     limited_load: bool = False,
                     limited_load_max: int = 5) -> List[Volume]:
    """Generic short-axis eval-only loader (PIE-style datasets —
    reference: datasets/cardiac_image.py:7-120, sax_dataset.py:9-140:
    read a directory of SAX volumes, resample in-plane, rescale)."""
    files = _find_files(root_dir, file_suffix)
    if not files:
        raise FileNotFoundError(f"no '*{file_suffix}' under {root_dir}")
    if limited_load:
        files = files[:limited_load_max]
    volumes = []
    for path in files:
        arr, spacing, _ = read_image(path)
        arr = arr.astype(np.float32)
        if arr.ndim == 4:
            arr = arr[0]
        if resample:
            arr = apply_2d_zoom_3d(arr, spacing[-2:], new_spacing)
            spacing = np.array([spacing[0], *new_spacing], np.float64)
        if rescale:
            arr = rescale_intensities(arr, percs=(1, 99))
        volumes.append(Volume(image=arr, spacing=np.asarray(spacing),
                              patient_id=os.path.basename(path)
                              .replace(file_suffix, "")))
    return volumes
