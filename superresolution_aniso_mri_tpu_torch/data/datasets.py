"""Dataset dispatch of the train and find-best commands.

Port of ``superresolution_aniso_mri_tpu/data/datasets.py::get_datasets``
for its synthetic / MNIST3D route (the same volumes, bit for bit). The
on-disk loaders (OASIS, dHCP, ADNI, brainMASI, ACDC and their yaml split
files) are not ported: their data is not in the repository (ROADMAP
item 12).
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from .synthetic import make_toy_dataset
from .volume import Volume


def get_datasets(args: Dict) -> Tuple[List[Volume], List[Volume]]:
    """(train, validation) volume lists for a settings dict.

    ``use_synthetic_data`` (and the MNIST toys) route to the procedural
    toy backend: ``4`` (``limited_load``) or 12 training volumes and 2
    validation volumes of ``8 * downsample_steps + 1`` slices at
    ``aug_patch_size or width``, seeded from ``seed``."""
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

    if dataset in ("OASIS", "dHCP", "ADNI", "brainMASI", "ACDCLBL", "ACDC",
                   "ACDCC"):
        raise NotImplementedError(
            f"dataset {dataset!r} from disk: the on-disk loaders and their "
            f"split files are not ported yet (ROADMAP item 12); "
            f"--use_synthetic_data trains on the toy volumes")
    raise ValueError(f"unknown dataset {dataset!r}")
