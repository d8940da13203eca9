"""Per-dataset paths, file suffixes and spacings.

A copy of ``superresolution_aniso_mri_tpu/config/data_config.py``
(reference: datasets/data_config.py:5-205). Each dataset's root is
``$SR_DATA_ROOT/<dir>``, ``~/data/<dir>`` when the variable is unset.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional

import numpy as np


def _root(dataset_dir: str) -> str:
    base = os.environ.get("SR_DATA_ROOT", os.path.expanduser("~/data"))
    return os.path.join(base, dataset_dir)


@dataclasses.dataclass
class DataConfig:
    dataset: str
    img_file_ext: str = ".nii.gz"
    data_root_dir: str = ""
    image_dir: str = ""
    split_file: Optional[str] = None
    limited_load_max: int = 5
    voxel_spacing_resample: Optional[np.ndarray] = None
    tissue_structure_labels: Optional[Dict[int, str]] = None

    def lr_file_suffix(self, downsample_steps: int) -> str:
        """Synthetic-LR file suffix of the blurred volumes
        (reference: common_brains.py:19-34 get_file_suffix_blurred)."""
        if self.dataset == "OASIS":
            stem = self.img_file_ext.replace(".nii.gz", "")
            return f"{stem}_{downsample_steps}mm.nii.gz"
        if self.dataset == "dHCP":
            stem = self.img_file_ext.replace(".nii.gz", "")
            return f"{stem}_{downsample_steps / 2:.1f}mm.nii.gz"
        if self.dataset == "ADNI":
            return f"_{downsample_steps}mm.nii"
        if self.dataset in ("MNIST3D", "MNISTRoto", "brainMASI"):
            # brainMASI trains from the HR volumes: the reference
            # downsamples at sample time (brainMASI/dataset.py:44-70)
            return self.img_file_ext
        raise NotImplementedError(
            f"lr_file_suffix: dataset {self.dataset} not supported")


_BUILDERS = {}


def _register(name):
    def deco(fn):
        _BUILDERS[name] = fn
        return fn
    return deco


@_register("ACDC")
@_register("ACDCLBL")
@_register("ACDCC")
def _acdc(name) -> DataConfig:
    root = _root("ACDC")
    return DataConfig(
        dataset=name,
        data_root_dir=root,
        image_dir=os.path.join(root, "all_cardiac_phases"),
        split_file=os.path.join(root, "train_val_test_split_sr.yaml"),
        voxel_spacing_resample=np.array([1.4, 1.4], np.float32),
        tissue_structure_labels={0: "BG", 1: "RV", 2: "MYO", 3: "LV"},
    )


@_register("ARVC")
def _arvc(name) -> DataConfig:
    root = _root("ARVC")
    return DataConfig(
        dataset=name, data_root_dir=root,
        image_dir=os.path.join(root, "nifti", "sax"),
        voxel_spacing_resample=np.array([1.4, 1.4], np.float32),
        tissue_structure_labels={0: "BG", 1: "LV", 2: "RV"},
        limited_load_max=3,
    )


@_register("OASIS")
def _oasis(name) -> DataConfig:
    root = _root("OASIS")
    return DataConfig(
        dataset=name, img_file_ext="t88_gfc.nii.gz",
        data_root_dir=root, image_dir=os.path.join(root, "nifti"),
        # written by data.datasets.create_split_file; without it the
        # loaders split the patients with a fixed seed
        split_file=os.path.join(root, "train_test_split.yaml"),
    )


@_register("dHCP")
def _dhcp(name) -> DataConfig:
    root = _root("dHCP_cropped_256")
    return DataConfig(
        dataset=name, img_file_ext="t2w.nii.gz",
        data_root_dir=root, image_dir=root,
        split_file=os.path.join(root, "train_test_split.yaml"),
    )


@_register("ADNI")
def _adni(name) -> DataConfig:
    root = _root("ADNI")
    return DataConfig(
        dataset=name, img_file_ext=".nii",
        data_root_dir=root, image_dir=root,
        split_file=os.path.join(root, "train_test_split.yaml"),
    )


@_register("brainMASI")
def _masi(name) -> DataConfig:
    root = _root("BrainMASI_LR_co")
    return DataConfig(dataset=name, data_root_dir=root, image_dir=root)


@_register("MNIST3D")
@_register("MNISTRoto")
def _mnist(name) -> DataConfig:
    root = _root(name)
    return DataConfig(dataset=name, img_file_ext=".nii.gz",
                      data_root_dir=root, image_dir=root)


@_register("sunnybrook")
def _sunnybrook(name) -> DataConfig:
    root = _root("sunnybrook")
    return DataConfig(dataset=name, data_root_dir=root,
                      image_dir=os.path.join(root, "sax"),
                      voxel_spacing_resample=np.array([1.4, 1.4], np.float32))


def get_config(dataset: str) -> DataConfig:
    try:
        return _BUILDERS[dataset](dataset)
    except KeyError:
        raise ValueError(f"unknown dataset {dataset!r}; "
                         f"known: {sorted(_BUILDERS)}") from None
