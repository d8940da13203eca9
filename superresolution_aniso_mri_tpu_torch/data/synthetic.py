"""Synthetic CPU-generatable volumes — the MNIST3D / toy data backend.

A numpy/scipy copy of the MNIST3D part of
``superresolution_aniso_mri_tpu/data/synthetic.py`` (``_phantom2d``,
``make_rotated_volume``, ``make_toy_dataset``, ``load_mnist_images``,
``_fit_digit``): stacks of progressively rotated 2-D structures (the
reference's datasets/MNIST/data.py:11-45 construction), from procedural
phantoms or from a local MNIST file. The same seed gives bitwise the
same volumes as the JAX package. The on-the-fly rotation sampler of
MNISTRoto (``RotoTripletSampler``) is not ported (ROADMAP item 15).
"""
from __future__ import annotations

import gzip
import os
import struct
from typing import List

import numpy as np
import scipy.ndimage

from .volume import Volume, rescale_intensities


def _phantom2d(size: int, rs: np.random.RandomState) -> np.ndarray:
    """A smooth random phantom: a few oriented bars + gaussian blobs."""
    img = np.zeros((size, size), np.float32)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32)
    c = (size - 1) / 2.0
    for _ in range(rs.randint(2, 5)):
        ang = rs.uniform(0, np.pi)
        width = rs.uniform(size * 0.04, size * 0.12)
        offset = rs.uniform(-size * 0.25, size * 0.25)
        d = np.abs((xx - c) * np.cos(ang) + (yy - c) * np.sin(ang) - offset)
        img += np.exp(-0.5 * (d / width) ** 2)
    for _ in range(rs.randint(1, 4)):
        cy, cx = rs.uniform(size * 0.25, size * 0.75, size=2)
        s = rs.uniform(size * 0.05, size * 0.15)
        img += rs.uniform(0.5, 1.0) * np.exp(
            -((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * s * s))
    img = scipy.ndimage.gaussian_filter(img, 1.0)
    return rescale_intensities(img, percs=(0, 100))


def make_rotated_volume(size: int = 32, num_slices: int = 17,
                        degrees_per_slice: float = 5.0,
                        seed: int = 0,
                        base: np.ndarray | None = None) -> Volume:
    """Stack of progressively rotated copies of one base image
    (reference construction: datasets/MNIST/data.py:11-45 with
    grad_step=5° per slice). ``base`` overrides the procedural phantom
    (e.g. a real MNIST digit from load_mnist_images)."""
    rs = np.random.RandomState(seed)
    if base is None:
        base = _phantom2d(size, rs)
    slices = []
    for s in range(num_slices):
        rot = scipy.ndimage.rotate(base, s * degrees_per_slice, reshape=False,
                                   order=1, mode="constant", cval=0.0)
        slices.append(np.clip(rot, 0.0, 1.0))
    img = np.stack(slices).astype(np.float32)
    return Volume(image=img, spacing=np.array([1.0, 1.0, 1.0]),
                  patient_id=f"toy{seed:03d}")


def make_toy_dataset(num_volumes: int = 4, size: int = 32,
                     num_slices: int = 17, seed: int = 0,
                     mnist_path: str | None = None,
                     mnist_split: str = "train") -> List[Volume]:
    """Procedural phantoms, or — when ``mnist_path`` (or the
    ``SR_MNIST_PATH`` environment variable) points at a locally provided
    MNIST file — real digits, each progressively rotated into a volume.
    Accepts idx3-ubyte (train-images-idx3-ubyte[.gz]) and .npz/.npy
    arrays."""
    mnist_path = mnist_path or os.environ.get("SR_MNIST_PATH")
    if mnist_path:
        digits = load_mnist_images(mnist_path)
        # disjoint train/val digit pools (the reference draws train and
        # test digits from separate MNIST files)
        if len(digits) < 2:
            raise ValueError(
                f"MNIST file {mnist_path!r} holds {len(digits)} image(s) "
                f"— at least 2 are needed for disjoint train/val pools")
        half = len(digits) // 2
        digits = digits[:half] if mnist_split == "train" else digits[half:]
        rs = np.random.RandomState(seed)
        picks = rs.choice(len(digits), size=num_volumes, replace=False) \
            if len(digits) >= num_volumes else \
            rs.randint(0, len(digits), size=num_volumes)
        return [make_rotated_volume(size=size, num_slices=num_slices,
                                    seed=seed + i,
                                    base=_fit_digit(digits[j], size))
                for i, j in enumerate(picks)]
    return [make_rotated_volume(size=size, num_slices=num_slices,
                                seed=seed + i)
            for i in range(num_volumes)]


def load_mnist_images(path: str) -> np.ndarray:
    """[N, 28, 28] float32 in [0, 1] from a local MNIST file: the
    canonical idx3-ubyte format (magic 0x00000803, big-endian dims;
    optionally gzipped) or a .npz/.npy export."""
    path = os.path.expanduser(path)
    if path.endswith(".npy"):
        arr = np.load(path)
    elif path.endswith(".npz"):
        with np.load(path) as z:
            key = "images" if "images" in z.files else z.files[0]
            arr = z[key]
    else:
        opener = gzip.open if path.endswith(".gz") else open
        with opener(path, "rb") as f:
            magic, n, rows, cols = struct.unpack(">IIII", f.read(16))
            if magic != 0x803:
                raise ValueError(
                    f"{path}: bad idx3-ubyte magic 0x{magic:x} "
                    f"(want 0x803 — an MNIST images file)")
            raw = f.read(n * rows * cols)
            if len(raw) < n * rows * cols:
                raise ValueError(f"{path}: truncated idx payload")
            arr = np.frombuffer(raw, np.uint8).reshape(n, rows, cols)
    arr = np.asarray(arr)
    if arr.ndim != 3:
        raise ValueError(f"{path}: expected [N,H,W] images, got {arr.shape}")
    if arr.shape[0] == 0:
        raise ValueError(f"{path}: file holds zero images")
    arr = arr.astype(np.float32)
    if arr.max() > 1.0:
        arr = arr / 255.0
    return arr


def _fit_digit(img: np.ndarray, size: int) -> np.ndarray:
    """Center a digit into a size x size canvas (pad or bilinear zoom),
    like the reference's transforms.Pad(2) 28->32 then translation."""
    h, w = img.shape
    if h > size or w > size:
        z = size / max(h, w)
        img = scipy.ndimage.zoom(img, z, order=1)
        h, w = img.shape
    out = np.zeros((size, size), np.float32)
    y0, x0 = (size - h) // 2, (size - w) // 2
    out[y0:y0 + h, x0:x0 + w] = img
    return np.clip(out, 0.0, 1.0)
