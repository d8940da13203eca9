"""Synthetic CPU-generatable volumes — the MNIST3D / toy data backend.

A numpy/scipy copy of the MNIST3D part of
``superresolution_aniso_mri_tpu/data/synthetic.py`` (``_phantom2d``,
``make_rotated_volume``, ``make_toy_dataset``, ``load_mnist_images``,
``_fit_digit``): stacks of progressively rotated 2-D structures (the
reference's datasets/MNIST/data.py:11-45 construction), from procedural
phantoms or from a local MNIST file. The same seed gives bitwise the
same volumes as the JAX package. MNISTRoto's on-the-fly rotation
sampler (``RotoTripletSampler``, JAX ``:377-472``) is copied too: the
same seed gives bitwise the same triplets and ``alpha_features``.
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


class RotoTripletSampler:
    """On-the-fly rotation triplets (the MNISTRoto backend).

    Reference: datasets/MNIST/data_roto.py:19-126 MakeRotatedTriple —
    instead of pre-built volumes, each sample rotates a base image by a
    random start angle θ and returns (θ, θ+Δ, θ+αΔ) rotations with
    grad_step Δ=5° per virtual slice and α drawn from the gap. Plugs into
    the same batch contract as TripletSampler.
    """

    def __init__(self, num_images: int = 16, size: int = 32,
                 grad_step: float = 5.0, downsample_steps: int = 2,
                 seed: int = 0, mnist_path: str | None = None,
                 mnist_split: str = "train"):
        rs = np.random.RandomState(seed)
        mnist_path = mnist_path or os.environ.get("SR_MNIST_PATH")
        if mnist_path:
            digits = load_mnist_images(mnist_path)
            # disjoint train/val pools, same convention as
            # make_toy_dataset — without this the val sampler would draw
            # trained digits and best-val selection would be optimistic
            if len(digits) < 2:
                raise ValueError(
                    f"MNIST file {mnist_path!r} holds {len(digits)} "
                    f"image(s) — at least 2 are needed for disjoint "
                    f"train/val pools")
            half = len(digits) // 2
            digits = (digits[:half] if mnist_split == "train"
                      else digits[half:])
            picks = rs.choice(len(digits), size=min(num_images, len(digits)),
                              replace=False)
            self.images = [_fit_digit(digits[j], size) for j in picks]
        else:
            self.images = [_phantom2d(size, rs) for _ in range(num_images)]
        self.grad_step = float(grad_step)
        self.downsample_steps = int(downsample_steps)
        self.rs = np.random.RandomState(seed + 1)
        self.size = size

    def __len__(self) -> int:
        return len(self.images) * 36  # nominal epoch length

    def _rotate(self, img: np.ndarray, angle: float) -> np.ndarray:
        out = scipy.ndimage.rotate(img, angle, reshape=False, order=1,
                                   mode="constant", cval=0.0)
        return np.clip(out, 0.0, 1.0).astype(np.float32)

    def sample_item(self, idx: int | None = None):
        """``idx`` selects the base image deterministically (the
        TripletSampler-like contract callers rely on for reproducible
        preview rows); ``None`` draws a random one. The rotation/offset
        stream stays stochastic either way."""
        img = (self.images[self.rs.randint(len(self.images))]
               if idx is None else self.images[idx % len(self.images)])
        gap = self.grad_step * self.downsample_steps
        theta = float(self.rs.uniform(0.0, 360.0))
        # in-between position strictly inside the gap (virtual slice grid)
        k = int(self.rs.randint(1, self.downsample_steps)) \
            if self.downsample_steps > 1 else 0.5
        frac = k / self.downsample_steps
        s_from = self._rotate(img, theta)
        s_to = self._rotate(img, theta + gap)
        s_between = self._rotate(img, theta + frac * gap)
        a_from = 1.0 - frac
        a_to = frac
        triplet = np.stack([s_from, s_to, s_between], axis=-1)
        # real slice-geometry features for the alpha probes, on the
        # virtual rotation grid: one "slice" per grad_step degrees, so a
        # full turn has n = 360/grad_step positions and z-spacing is the
        # angular step — the rotational analog of TripletSampler's
        # [(s_from+1)/n, (s_to+1)/n, (frame+1)/n_frames, spacing, n]
        # (reference: base_alpha_trainer.py:178-189 create_add_features;
        # the reference's MNISTRoto batches carry mismatched key names
        # and crash its alpha trainers — this path works instead)
        n_virtual = 360.0 / self.grad_step
        vid_from = theta / self.grad_step
        feats = np.array([(vid_from + 1.0) / n_virtual,
                          (vid_from + self.downsample_steps + 1.0)
                          / n_virtual,
                          1.0, self.grad_step, n_virtual], np.float32)
        return {"triplet": triplet.astype(np.float32),
                "alpha_from": np.float32(a_from),
                "alpha_to": np.float32(a_to),
                "is_inbetween": np.float32(1.0),
                "alpha_features": feats,
                "patient_index": np.int32(0)}

    def sample_batch(self, batch_size: int):
        items = [self.sample_item() for _ in range(batch_size)]
        return {k: np.stack([it[k] for it in items]) for k in items[0]}

    def epoch_batches(self, batch_size: int):
        for _ in range(max(1, len(self) // batch_size)):
            yield self.sample_batch(batch_size)
