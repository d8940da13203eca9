"""Synthetic CPU-generatable volumes — the MNIST3D / toy data backend.

A numpy/scipy copy of the MNIST3D part of
``superresolution_aniso_mri_tpu/data/synthetic.py`` (``_phantom2d``,
``make_rotated_volume``, ``make_toy_dataset``, ``load_mnist_images``,
``_fit_digit``): stacks of progressively rotated 2-D structures (the
reference's datasets/MNIST/data.py:11-45 construction), from procedural
phantoms or from a local MNIST file. The same seed gives bitwise the
same volumes as the JAX package. MNISTRoto's on-the-fly rotation
sampler (``RotoTripletSampler``, JAX ``:377-472``) is copied too: the
same seed gives bitwise the same triplets and ``alpha_features``. So
are the quality phantoms the perceptual tools draw from
(``add_rician_noise``, ``make_textured_rotated_volume``,
``make_anatomy3d_volume``, ``make_cardiac4d_volume``): bitwise the same
arrays from the same seeds.
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


def add_rician_noise(vol: np.ndarray, sigma: float,
                     seed: int = 0) -> np.ndarray:
    """Rician magnitude noise: |signal + complex N(0, σ)| — the MRI
    noise model (same construction make_cardiac4d_volume uses
    internally). Seeded so the noisy volume is fully deterministic.
    Range grows to ~[0, max+4σ]; callers that need [0,1] should
    rescale afterwards."""
    if sigma <= 0:
        return np.asarray(vol, np.float32)
    rs = np.random.RandomState(seed)
    e1 = rs.normal(0.0, sigma, vol.shape)
    e2 = rs.normal(0.0, sigma, vol.shape)
    return np.sqrt((vol + e1) ** 2 + e2 ** 2).astype(np.float32)


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


def make_textured_rotated_volume(size: int = 64, num_slices: int = 19,
                                 seed: int = 0,
                                 texture_sigma: float = 0.7,
                                 texture_amp: float = 0.6) -> Volume:
    """Rotated phantom with band-limited multiplicative fine texture.

    Real MRI carries such texture, and it is exactly what through-plane
    interpolation blurs away — it separates methods on VIF, which
    saturates on smooth phantoms. The recipe (gaussian-filtered noise,
    sigma 0.7, amplitude 0.6, riding multiplicatively on the anatomy)
    is load-bearing for the quality benchmarks; both
    tools/quality_check.py and tools/real_pipeline_quality.py use THIS
    helper so the two harnesses measure the same phantom family."""
    rs = np.random.RandomState(seed)
    base = _phantom2d(size, rs)
    tex = scipy.ndimage.gaussian_filter(
        rs.randn(size, size).astype(np.float32), texture_sigma)
    base = np.clip(base * (1.0 + texture_amp * tex), 0.0, 1.0)
    vol = make_rotated_volume(size=size, num_slices=num_slices, seed=seed,
                              base=base)
    return Volume(image=vol.image, spacing=vol.spacing,
                  patient_id=f"tex{seed:03d}")


def make_anatomy3d_volume(size: int = 64, num_slices: int = 37,
                          seed: int = 0,
                          texture_amp: float = 0.5) -> Volume:
    """A genuinely 3-D phantom: smooth ellipsoidal 'tissue' structures
    whose boundaries DRIFT across slices, plus band-limited 3-D texture.

    The rotating-base toys (make_rotated_volume) move every edge by the
    same in-plane rotation, which through-plane linear blending handles
    unusually well; real MRI anatomy instead presents edges that shift,
    grow and vanish between slices — the regime where the reference's
    latent-space synthesis beats conventional interpolation
    (BASELINE.md dHCP numbers). This phantom reproduces that regime on
    CPU: nested ellipsoids with per-structure z-drifting centres +
    multiplicative texture correlated over ~2 slices in z."""
    rs = np.random.RandomState(seed)
    zz, yy, xx = np.mgrid[0:num_slices, 0:size, 0:size].astype(np.float32)
    cz, c = (num_slices - 1) / 2.0, (size - 1) / 2.0
    img = np.zeros((num_slices, size, size), np.float32)
    # outer 'head' ellipsoid everything else lives inside
    rz0 = rs.uniform(0.75, 0.95) * cz
    r0 = rs.uniform(0.70, 0.88) * c
    head = (((zz - cz) / rz0) ** 2 + ((yy - c) / r0) ** 2
            + ((xx - c) / r0) ** 2)
    img += 0.55 * np.clip(1.15 - head, 0.0, 1.0)
    # interior structures: centres drift linearly in z (edges shift
    # between slices instead of rotating rigidly); short z-extents mean
    # structures grow/vanish within a few slices — the through-plane
    # statistics linear blending handles worst
    for _ in range(rs.randint(8, 14)):
        base_cy, base_cx = rs.uniform(0.25, 0.75, size=2) * size
        drift = rs.uniform(-1.5, 1.5, size=2)  # px per slice, in (y, x)
        sy, sx = rs.uniform(size * 0.04, size * 0.14, size=2)
        sz = rs.uniform(num_slices * 0.05, num_slices * 0.22)
        zc = rs.uniform(0.15, 0.85) * num_slices
        amp = rs.uniform(-0.7, 0.9)
        cy = base_cy + drift[0] * (zz - zc)
        cx = base_cx + drift[1] * (zz - zc)
        q = (((zz - zc) / sz) ** 2 + ((yy - cy) / sy) ** 2
             + ((xx - cx) / sx) ** 2)
        # sigmoid-sharpened ellipsoid: near-flat interior, sharp
        # tissue-like boundary (a gaussian falloff is too smooth to
        # challenge linear blending)
        img += amp / (1.0 + np.exp(np.minimum((q - 1.0) / 0.12, 60.0)))
    img = scipy.ndimage.gaussian_filter(img, (0.4, 0.6, 0.6))
    img = rescale_intensities(img, percs=(0, 100))
    if texture_amp:
        # band-limited 3-D texture: σ_z = 0.9 slices → real through-plane
        # detail a 3-slice PSF suppresses but neighbours still predict
        tex = scipy.ndimage.gaussian_filter(
            rs.randn(num_slices, size, size).astype(np.float32),
            (0.9, 0.7, 0.7))
        tex /= max(float(tex.std()), 1e-6)
        img = np.clip(img * (1.0 + texture_amp * 0.5 * tex), 0.0, 1.0)
    # keep background air dark like real MRI
    img *= np.clip(1.3 - head, 0.0, 1.0) ** 0.5
    return Volume(image=np.clip(img, 0.0, 1.0).astype(np.float32),
                  spacing=np.array([1.0, 1.0, 1.0]),
                  patient_id=f"anat{seed:03d}")


def make_cardiac4d_volume(size: int = 64, num_slices: int = 15,
                          num_frames: int = 6, seed: int = 0,
                          texture_amp: float = 0.5,
                          noise_sigma: float = 0.0) -> np.ndarray:
    """A 4-D cine-MRI-like phantom [frames, slices, H, W] in [0, 1]
    (``noise_sigma > 0`` adds Rician noise, range grows to ~[0, 1+4σ]).

    The through-plane statistics mirror short-axis cardiac cine
    (reference training data: datasets/ACDC/data.py): a bright
    ventricle-like blood pool inside a darker myocardial shell that
    CONTRACTS over the frame axis (end-diastole at t=0, end-systole at
    the middle frame), surrounded by anatomy3d-style drifting ellipsoid
    'tissue' structures (edges that shift/grow/vanish between slices —
    the regime where latent synthesis beats linear blending) plus
    band-limited 3-D texture, all shared across frames so the ONLY
    frame-to-frame change is deformation, like real cine.

    Used by the cardiac production-pipeline quality benchmark
    (tools/real_pipeline_quality.py --dataset_shape ACDC).

    ``noise_sigma``: Rician magnitude noise (|signal + complex N(0, σ)|,
    the physical noise model of magnitude MRI) applied to every frame.
    Measured calibration (docs/STATUS.md session 8): the NOISELESS
    phantom ranks the conventional interpolators bspline > lanczos >
    linear on SSIM — the OPPOSITE of the reference's real-cardiac table
    (BASELINE.md Sunnybrook: linear 0.858 > bspline 0.850 > lanczos
    0.841), because analytic smoothness is exactly the signal class
    wide kernels excel at. At ``noise_sigma=0.03`` the phantom
    reproduces the reference's real-data ordering on ALL THREE metrics
    (SSIM linear>bspline>lanczos, PSNR bspline>lanczos>linear, VIF
    linear>bspline≈lanczos), making it the representative setting for
    model-vs-conventional comparisons."""
    rs = np.random.RandomState(seed)
    zz, yy, xx = np.mgrid[0:num_slices, 0:size, 0:size].astype(np.float32)
    cz, c = (num_slices - 1) / 2.0, (size - 1) / 2.0

    # static chest-like outer ellipsoid (bounds every structure)
    rz0 = rs.uniform(0.80, 0.95) * cz
    r0 = rs.uniform(0.72, 0.88) * c
    chest = (((zz - cz) / rz0) ** 2 + ((yy - c) / r0) ** 2
             + ((xx - c) / r0) ** 2)
    base = 0.45 * np.clip(1.15 - chest, 0.0, 1.0)

    def _sig(q):  # sharp tissue-like boundary (see make_anatomy3d_volume)
        return 1.0 / (1.0 + np.exp(np.minimum((q - 1.0) / 0.10, 60.0)))

    # ventricle geometry (drawn once; radii deform per frame)
    lv_cy = c + rs.uniform(-0.12, 0.12) * size
    lv_cx = c + rs.uniform(-0.12, 0.12) * size
    lv_r = rs.uniform(0.14, 0.20) * size      # end-diastolic LV radius
    lv_rz = rs.uniform(0.65, 0.85) * cz       # long-axis (z) extent
    wall0 = rs.uniform(0.28, 0.42) * lv_r     # ED wall thickness
    # RV: crescent approximated by a laterally offset ellipsoid
    rv_cy = lv_cy + rs.uniform(-0.06, 0.06) * size
    rv_cx = lv_cx - (lv_r + wall0) * rs.uniform(1.3, 1.7)
    rv_r = lv_r * rs.uniform(0.8, 1.1)

    # drifting background tissue (shared across frames, phase-dragged)
    tissues = []
    for _ in range(rs.randint(6, 11)):
        tissues.append(dict(
            cy=rs.uniform(0.2, 0.8) * size, cx=rs.uniform(0.2, 0.8) * size,
            drift=rs.uniform(-1.2, 1.2, size=2),
            sy=rs.uniform(size * 0.04, size * 0.12),
            sx=rs.uniform(size * 0.04, size * 0.12),
            sz=rs.uniform(num_slices * 0.06, num_slices * 0.25),
            zc=rs.uniform(0.15, 0.85) * num_slices,
            amp=rs.uniform(-0.5, 0.7)))

    tex = None
    if texture_amp:
        tex = scipy.ndimage.gaussian_filter(
            rs.randn(num_slices, size, size).astype(np.float32),
            (0.9, 0.7, 0.7))
        tex /= max(float(tex.std()), 1e-6)

    frames = []
    for t in range(num_frames):
        ph = float(np.sin(np.pi * t / max(num_frames - 1, 1)))  # 0→1→0
        img = base.copy()
        # myocardium contracts inward; wall thickens at systole
        r_in = lv_r * (1.0 - 0.30 * ph)
        wall = wall0 * (1.0 + 0.55 * ph)
        q_in = (((zz - cz) / lv_rz) ** 2 + ((yy - lv_cy) / r_in) ** 2
                + ((xx - lv_cx) / r_in) ** 2)
        r_out = r_in + wall
        q_out = (((zz - cz) / (lv_rz * 1.06)) ** 2
                 + ((yy - lv_cy) / r_out) ** 2
                 + ((xx - lv_cx) / r_out) ** 2)
        blood, shell = _sig(q_in), _sig(q_out)
        img += 0.75 * blood          # bright blood (cine SSFP)
        img += -0.25 * (shell - blood)  # darker myocardium ring
        rv_rt = rv_r * (1.0 - 0.22 * ph)
        q_rv = (((zz - cz) / (lv_rz * 0.9)) ** 2
                + ((yy - rv_cy) / (rv_rt * 1.25)) ** 2
                + ((xx - rv_cx) / rv_rt) ** 2)
        img += 0.55 * _sig(q_rv) * (1.0 - shell)  # RV pool outside LV
        for s in tissues:
            # tissue drags a little toward the LV centre with the
            # contraction (myocardial tethering)
            pull = 0.04 * ph
            cy = (s["cy"] + s["drift"][0] * (zz - s["zc"])
                  + pull * (lv_cy - s["cy"]))
            cx = (s["cx"] + s["drift"][1] * (zz - s["zc"])
                  + pull * (lv_cx - s["cx"]))
            q = (((zz - s["zc"]) / s["sz"]) ** 2 + ((yy - cy) / s["sy"]) ** 2
                 + ((xx - cx) / s["sx"]) ** 2)
            img += s["amp"] * _sig(q) * (1.0 - shell) * (1.0 - _sig(q_rv))
        img = scipy.ndimage.gaussian_filter(img, (0.4, 0.6, 0.6))
        img = rescale_intensities(img, percs=(0, 100))
        if tex is not None:
            img = np.clip(img * (1.0 + texture_amp * 0.5 * tex), 0.0, 1.0)
        img *= np.clip(1.3 - chest, 0.0, 1.0) ** 0.5
        frames.append(np.clip(img, 0.0, 1.0).astype(np.float32))
    out = np.stack(frames)
    if noise_sigma:
        # Rician: magnitude of the clean signal plus iid complex
        # gaussian noise — drawn from the same seeded stream so the
        # seed fully determines the noisy volume
        e1 = rs.normal(0.0, noise_sigma, out.shape)
        e2 = rs.normal(0.0, noise_sigma, out.shape)
        out = np.sqrt((out + e1) ** 2 + e2 ** 2).astype(np.float32)
    return out


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
