"""Batch shaping and augmentation on the device, batched over NCHW.

Port of ``superresolution_aniso_mri_tpu/data/transforms.py``:
``pad_to_size`` (numpy, host), ``center_crop``, ``AugmentConfig``,
``augment_batch`` with every random op of the JAX package (crop, crop
next to the center, sigmoid intensity, elastic, perspective, any-angle
rotation, rot90, mirror, blur, noise, in the JAX package's order) and
``prepare_batch_pairs/quintets/septets``.

Each random op is split in two. ``draw_augment_params`` draws the
per-sample values (crop offsets, rot90 turns, gain and cutoff, degrees,
the coarse elastic field, the homography, the coins, the noise sigma)
from a CPU ``torch.Generator``: a few numbers a sample, so one seed gives
the same geometry on the card and on the CPU. ``apply_augment`` is
deterministic given them: crops, rot90 and mirror are index gathers, the
warps one bilinear gather with zero fill per corner. The one dense draw,
the noise field, comes from a generator on the batch's device seeded
with a number drawn from the CPU stream (``AugmentParams.noise_seed``),
so noise differs between the card and the CPU for one seed; a given
``AugmentParams.noise_field`` replaces it. ``jax.random`` streams cannot
be reproduced: the draws match the JAX package's in distribution, and the
maps match it given the same draws.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.profiling import span

NOISE_SIGMA_MAX = 0.05      # the JAX package's ``_noise_one`` default
ELASTIC_GRID = 4            # coarse displacement grid of ``_elastic_one``
PERSPECTIVE_JITTER = 0.002  # homography I + U(-j, j) of ``_perspective_one``


def pad_to_size(x: np.ndarray, size: int) -> np.ndarray:
    """Zero-pad the trailing H/W dims up to (size, size), centered; never
    crops."""
    h, w = x.shape[-2], x.shape[-1]
    ph = max(0, size - h)
    pw = max(0, size - w)
    pads = [(0, 0)] * (x.ndim - 2) + [(ph // 2, ph - ph // 2),
                                      (pw // 2, pw - pw // 2)]
    if ph == 0 and pw == 0:
        return x
    return np.pad(x, pads, mode="constant")


def center_crop(x: torch.Tensor, size: int) -> torch.Tensor:
    """Center crop of the trailing H, W dims of [..., H, W]."""
    h, w = x.shape[-2], x.shape[-1]
    if h < size or w < size:
        raise ValueError(f"center_crop: size {size} exceeds spatial dims "
                         f"({h}, {w}) — pad first (pad_to_size)")
    top = (h - size) // 2
    left = (w - size) // 2
    return x[..., top:top + size, left:left + size]


def _pad_batch_to_at_least(x: torch.Tensor, size: int) -> torch.Tensor:
    """Centered zero pad of [B, C, H, W] so that H, W >= size."""
    h, w = x.shape[-2], x.shape[-1]
    ph, pw = max(0, size - h), max(0, size - w)
    if ph == 0 and pw == 0:
        return x
    return F.pad(x, (pw // 2, pw - pw // 2, ph // 2, ph - ph // 2))


@dataclasses.dataclass(frozen=True)
class AugmentConfig:
    """The JAX package's augmentation switches (same fields, defaults
    and meaning)."""

    patch_size: int
    aug_patch_size: Optional[int] = None
    random_crop: bool = True
    rot90: bool = True
    intensity: bool = True
    rotate_any: bool = False
    max_degree: int = 45
    noise: bool = False
    blur: bool = False
    mirror: bool = False
    elastic: bool = False
    elastic_alpha: float = 10.0
    crop_next_to_center: bool = False
    max_translation: int = 35
    perspective: bool = False


@dataclasses.dataclass
class AugmentParams:
    """The per-sample draws of one batch (tensors of leading size B);
    None for an op that does not run."""

    crop_top: Optional[torch.Tensor] = None       # int64, window offsets
    crop_left: Optional[torch.Tensor] = None
    gain: Optional[torch.Tensor] = None           # float32, intensity
    cutoff: Optional[torch.Tensor] = None
    elastic_field: Optional[torch.Tensor] = None  # [B, 2, g, g] (dy, dx) px
    homography: Optional[torch.Tensor] = None     # [B, 3, 3], dst ← src
    degrees: Optional[torch.Tensor] = None        # int64, any-angle rotation
    rot90_k: Optional[torch.Tensor] = None        # int64 in [0, 4)
    flip_w: Optional[torch.Tensor] = None         # bool, mirror
    flip_h: Optional[torch.Tensor] = None
    blur: Optional[torch.Tensor] = None           # bool, blur coin
    noise_sigma: Optional[torch.Tensor] = None    # float32
    noise_seed: Optional[int] = None
    noise_field: Optional[torch.Tensor] = None    # [B, C, p, p] N(0, 1)


def _working_size(h: int, w: int, cfg: AugmentConfig):
    """(H, W) after the pad / ``aug_patch_size`` center crop / pad to
    ``patch_size`` stage of ``augment_batch``."""
    if cfg.aug_patch_size is not None:
        h = w = int(cfg.aug_patch_size)
    return max(h, cfg.patch_size), max(w, cfg.patch_size)


def _random_ops(cfg: AugmentConfig, need_crop: bool) -> list:
    """The random ops that ``cfg`` runs on a batch, in the order they
    run."""
    ops = []
    if need_crop and cfg.crop_next_to_center:
        ops.append("crop_next_to_center")
    elif need_crop and cfg.random_crop:
        ops.append("random_crop")
    ops += [name for name in ("intensity", "elastic", "perspective")
            if getattr(cfg, name)]
    if cfg.rotate_any and cfg.max_degree > 0:
        ops.append("rotate_any")
    ops += [name for name in ("rot90", "mirror", "blur", "noise")
            if getattr(cfg, name)]
    return ops


def draw_augment_params(generator: Optional[torch.Generator],
                        cfg: AugmentConfig, batch: int, h: int,
                        w: int) -> AugmentParams:
    """Draw the random values of ``cfg``'s ops for a batch of ``batch``
    [H=h, W=w] inputs from ``generator`` (a CPU ``torch.Generator``), op
    by op in ``augment_batch``'s order, with the JAX package's ranges:
    integer bounds exclusive on the right; crop next to the center draws
    ±``max_translation`` and then clamps the window. A config with no
    random op needs no generator."""
    hh, ww = _working_size(h, w, cfg)
    p = cfg.patch_size
    ops = _random_ops(cfg, hh > p or ww > p)
    params = AugmentParams()
    if not ops:
        return params
    if generator is None:
        raise ValueError(f"augmentation ops {ops} draw random values: pass "
                         f"a CPU torch.Generator")
    g = generator

    def randint(lo, hi, shape=(batch,)):
        return torch.randint(lo, hi, shape, generator=g)

    def uniform(lo, hi, shape=(batch,)):
        return lo + (hi - lo) * torch.rand(shape, generator=g)

    def coin():
        return torch.rand(batch, generator=g) < 0.5

    if "crop_next_to_center" in ops:
        mt = int(cfg.max_translation)
        dy, dx = randint(-mt, mt + 1), randint(-mt, mt + 1)
        params.crop_top = ((hh - p) // 2 + dy).clamp(0, max(hh - p, 0))
        params.crop_left = ((ww - p) // 2 + dx).clamp(0, max(ww - p, 0))
    elif "random_crop" in ops:
        params.crop_top = randint(0, hh - p + 1)
        params.crop_left = randint(0, ww - p + 1)
    if "intensity" in ops:
        params.gain, params.cutoff = uniform(2.5, 7.5), uniform(0.25, 0.75)
    if "elastic" in ops:
        params.elastic_field = torch.randn(
            (batch, 2, ELASTIC_GRID, ELASTIC_GRID),
            generator=g) * float(cfg.elastic_alpha)
    if "perspective" in ops:
        params.homography = torch.eye(3) + uniform(
            -PERSPECTIVE_JITTER, PERSPECTIVE_JITTER, (batch, 3, 3))
    if "rotate_any" in ops:
        params.degrees = randint(0, max(int(cfg.max_degree), 1))
    if "rot90" in ops:
        params.rot90_k = randint(0, 4)
    if "mirror" in ops:
        params.flip_w, params.flip_h = coin(), coin()
    if "blur" in ops:
        params.blur = coin()
    if "noise" in ops:
        params.noise_sigma = uniform(0.0, NOISE_SIGMA_MAX)
        params.noise_seed = int(randint(0, 2 ** 62, (1,)))
    return params


# ---------------------------------------------------------------------------
# the maps, batched over B
# ---------------------------------------------------------------------------

def _take(x: torch.Tensor, rows: torch.Tensor,
          cols: torch.Tensor) -> torch.Tensor:
    """x [B, C, H, W] at integer (rows, cols), broadcastable to [B, h, w]
    → [B, C, h, w]: one gather."""
    b, c, h, w = x.shape
    idx = (rows * w + cols).expand(b, -1, -1)
    oh, ow = idx.shape[-2:]
    out = x.reshape(b, c, h * w).gather(
        2, idx.reshape(b, 1, oh * ow).expand(b, c, oh * ow))
    return out.reshape(b, c, oh, ow)


def _crop(x: torch.Tensor, top: torch.Tensor, left: torch.Tensor,
          size: int) -> torch.Tensor:
    """Per-sample [size, size] windows at (top, left)."""
    r = torch.arange(size, device=x.device)
    return _take(x, top.view(-1, 1, 1) + r.view(1, -1, 1),
                 left.view(-1, 1, 1) + r.view(1, 1, -1))


def _bilinear_sample(x: torch.Tensor, ys: torch.Tensor,
                     xs: torch.Tensor) -> torch.Tensor:
    """x [B, C, H, W] at float coordinates (ys, xs) [B, h, w], bilinear,
    each of the four corners zero outside the frame (the JAX package's
    ``_bilinear_sample``)."""
    b, c, h, w = x.shape
    y0, x0 = torch.floor(ys), torch.floor(xs)
    dy, dx = (ys - y0)[:, None], (xs - x0)[:, None]
    # the four corners (y0, x0), (y0, x0+1), (y0+1, x0), (y0+1, x0+1) in
    # one gather; flat indices are exact in float32 (H·W < 2**24)
    yi = torch.stack([y0, y0, y0 + 1, y0 + 1], 1)
    xi = torch.stack([x0, x0 + 1, x0, x0 + 1], 1)
    valid = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
    idx = torch.where(valid, yi * w + xi, 0.0).long().reshape(b, 1, -1)
    v = x.reshape(b, c, h * w).gather(2, idx.expand(b, c, -1))
    v = torch.where(valid[:, None], v.reshape(b, c, *yi.shape[1:]), 0.0)
    top = v[:, :, 0] * (1 - dx) + v[:, :, 1] * dx
    bot = v[:, :, 2] * (1 - dx) + v[:, :, 3] * dx
    return top * (1 - dy) + bot * dy


def _grid(h: int, w: int, device):
    return (torch.arange(h, dtype=torch.float32, device=device)[:, None],
            torch.arange(w, dtype=torch.float32, device=device)[None, :])


def _resize_weights(n_in: int, n_out: int) -> np.ndarray:
    """[n_in, n_out] float32 weights of ``jax.image.resize``'s bilinear
    (triangle kernel, half-pixel centers, normalized, no antialias on
    upsampling)."""
    f32 = np.float32
    inv_scale = 1.0 / (n_out / n_in)
    kernel_scale = max(inv_scale, 1.0)
    sample = (np.arange(n_out, dtype=f32) + f32(0.5)) * f32(inv_scale) \
        - f32(0.5)
    dist = np.abs(sample[None, :] - np.arange(n_in, dtype=f32)[:, None]) \
        / f32(kernel_scale)
    wts = np.maximum(f32(1.0) - dist, f32(0.0))
    total = wts.sum(0, keepdims=True, dtype=f32)
    wts = np.where(np.abs(total) > 1000.0 * np.finfo(f32).eps,
                   wts / np.where(total != 0, total, f32(1.0)), f32(0.0))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[None, :], wts, f32(0.0)).astype(f32)


def upsample_field(coarse: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """[B, 2, g, g] coarse displacements → [B, 2, h, w], as
    ``jax.image.resize(..., method="bilinear")`` does."""
    gh, gw = coarse.shape[-2:]
    wy, wx = (torch.from_numpy(_resize_weights(n, m)).to(
        coarse.device, non_blocking=True) for n, m in ((gh, h), (gw, w)))
    return torch.einsum("bcyx,yi,xj->bcij", coarse, wy, wx)


def _elastic(x: torch.Tensor, coarse: torch.Tensor) -> torch.Tensor:
    h, w = x.shape[-2:]
    field = upsample_field(coarse, h, w)
    yy, xx = _grid(h, w, x.device)
    return _bilinear_sample(x, yy + field[:, 0], xx + field[:, 1])


def _perspective(x: torch.Tensor, homography: torch.Tensor) -> torch.Tensor:
    """Output pixel (x, y) samples the source at M⁻¹·(x, y, 1)
    (cv2.warpPerspective's convention)."""
    h, w = x.shape[-2:]
    minv = torch.from_numpy(np.linalg.inv(
        homography.cpu().numpy().astype(np.float64)).astype(np.float32)).to(
            x.device, non_blocking=True)
    m = [[minv[:, i, j].view(-1, 1, 1) for j in range(3)] for i in range(3)]
    yy, xx = _grid(h, w, x.device)
    yy, xx = yy.expand(h, w), xx.expand(h, w)
    denom = m[2][0] * xx + m[2][1] * yy + m[2][2]
    xs = (m[0][0] * xx + m[0][1] * yy + m[0][2]) / denom
    ys = (m[1][0] * xx + m[1][1] * yy + m[1][2]) / denom
    return _bilinear_sample(x, ys, xs)


def _rotate_any(x: torch.Tensor, degrees: torch.Tensor) -> torch.Tensor:
    """Rotation by integer degrees about the image center, bilinear, zero
    border (counterclockwise for a positive angle, as cv2.warpAffine)."""
    h, w = x.shape[-2:]
    theta = degrees.cpu().float() * torch.tensor(math.pi / 180,
                                                 dtype=torch.float32)
    cos, sin = torch.stack([theta.cos(), theta.sin()]).to(
        x.device, non_blocking=True).view(2, -1, 1, 1)
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    yy, xx = _grid(h, w, x.device)
    xs = cos * (xx - cx) - sin * (yy - cy) + cx
    ys = sin * (xx - cx) + cos * (yy - cy) + cy
    return _bilinear_sample(x, ys, xs)


def _rot90(x: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Per-sample ``rot90`` by k quarter turns from H toward W of a
    square batch, as one gather."""
    p = x.shape[-1]
    i = torch.arange(p, device=x.device).view(p, 1).expand(p, p)
    j = torch.arange(p, device=x.device).view(1, p).expand(p, p)
    rows = torch.stack([i, j, p - 1 - i, p - 1 - j])
    cols = torch.stack([j, p - 1 - i, p - 1 - j, i])
    return _take(x, rows[k], cols[k])


def _mirror(x: torch.Tensor, flip_w: torch.Tensor,
            flip_h: torch.Tensor) -> torch.Tensor:
    h, w = x.shape[-2:]
    r = torch.arange(h, device=x.device).view(1, h, 1)
    c = torch.arange(w, device=x.device).view(1, 1, w)
    rows = torch.where(flip_h.view(-1, 1, 1), h - 1 - r, r)
    cols = torch.where(flip_w.view(-1, 1, 1), w - 1 - c, c)
    return _take(x, rows, cols)


def _blur(x: torch.Tensor, coin: torch.Tensor) -> torch.Tensor:
    """The 3×3 binomial (0.25, 0.5, 0.25) blur over an edge-padded batch,
    H then W, where the coin is set."""
    xp = F.pad(x, (1, 1, 1, 1), mode="replicate")
    xp = 0.25 * xp[..., :-2, :] + 0.5 * xp[..., 1:-1, :] + 0.25 * xp[..., 2:, :]
    blurred = (0.25 * xp[..., :-2] + 0.5 * xp[..., 1:-1]
               + 0.25 * xp[..., 2:])
    return torch.where(coin.view(-1, 1, 1, 1), blurred, x)


def _noise(x: torch.Tensor, params: AugmentParams) -> torch.Tensor:
    field = params.noise_field
    if field is None:
        gen = torch.Generator(device=x.device).manual_seed(params.noise_seed)
        field = torch.randn(x.shape, generator=gen, device=x.device,
                            dtype=x.dtype)
    sigma = params.noise_sigma.to(x.device, non_blocking=True)
    field = field.to(x.device, non_blocking=True)
    return torch.clamp(x + sigma.view(-1, 1, 1, 1) * field, 0.0, 1.0)


def _param(params: AugmentParams, name: str, device) -> torch.Tensor:
    value = getattr(params, name)
    if value is None:
        raise ValueError(f"AugmentParams.{name} is missing for an op the "
                         f"config runs (draw with draw_augment_params)")
    # from pageable memory: staged at once, without a stream sync
    return value.to(device, non_blocking=True)


def apply_augment(x: torch.Tensor, params: AugmentParams,
                  cfg: AugmentConfig) -> torch.Tensor:
    """[B, kC, H, W] → [B, kC, p, p]: pad to ``aug_patch_size`` and center
    crop to it, pad to ``patch_size``, then crop (``params``' windows, or
    the center when no random crop runs), intensity, elastic,
    perspective, any-angle rotation, rot90, mirror, blur and noise — the
    JAX package's order: intensity before the warps, so that their zero
    fill stays 0. Geometry acts on all channels of a sample at once."""
    if cfg.aug_patch_size is not None:
        ap = cfg.aug_patch_size
        x = _pad_batch_to_at_least(x, ap)
        if x.shape[-2] > ap or x.shape[-1] > ap:
            x = center_crop(x, ap)
    x = _pad_batch_to_at_least(x, cfg.patch_size)
    p = cfg.patch_size
    dev = x.device
    if x.shape[-2] > p or x.shape[-1] > p:
        if cfg.crop_next_to_center or cfg.random_crop:
            x = _crop(x, _param(params, "crop_top", dev),
                      _param(params, "crop_left", dev), p)
        else:
            x = center_crop(x, p)
    if cfg.intensity:
        gain = _param(params, "gain", dev).view(-1, 1, 1, 1)
        cutoff = _param(params, "cutoff", dev).view(-1, 1, 1, 1)
        x = torch.sigmoid(-gain * (cutoff - x))
    if cfg.elastic:
        x = _elastic(x, _param(params, "elastic_field", dev))
    if cfg.perspective:
        x = _perspective(x, _param(params, "homography", "cpu"))
    if cfg.rotate_any and cfg.max_degree > 0:
        x = _rotate_any(x, _param(params, "degrees", "cpu"))
    if cfg.rot90:
        x = _rot90(x, _param(params, "rot90_k", dev))
    if cfg.mirror:
        x = _mirror(x, _param(params, "flip_w", dev),
                    _param(params, "flip_h", dev))
    if cfg.blur:
        x = _blur(x, _param(params, "blur", dev))
    if cfg.noise:
        if params.noise_sigma is None or (params.noise_field is None
                                          and params.noise_seed is None):
            raise ValueError("AugmentParams.noise_sigma and noise_seed (or "
                             "noise_field) are missing for the noise op")
        x = _noise(x, params)
    return x


def augment_batch(triplet: torch.Tensor, cfg: AugmentConfig,
                  generator: Optional[torch.Generator] = None
                  ) -> torch.Tensor:
    """[B, kC, H, W] → [B, kC, p, p]: ``draw_augment_params`` from
    ``generator`` (a CPU ``torch.Generator``; not needed when ``cfg``
    runs no random op), then ``apply_augment``."""
    b, _, h, w = triplet.shape
    return apply_augment(triplet, draw_augment_params(generator, cfg, b, h, w),
                         cfg)


def _split(x: torch.Tensor, slots: int):
    """Channel slots of [B, slots*C, H, W], each [B, C, H, W]."""
    if x.shape[1] % slots != 0:
        raise ValueError(
            f"expected {slots}C channels (one C-channel slot per slice), "
            f"got {x.shape[1]}")
    return torch.chunk(x, slots, dim=1)


def prepare_batch_pairs(triplet: torch.Tensor):
    """[B, 3C, H, W] (from | to | between) → (image [2B, C, H, W] =
    from ∥ to, slice_between [B, C, H, W])."""
    a, b, between = _split(triplet, 3)
    return torch.cat([a, b]), between


def prepare_batch_quintets(quintet: torch.Tensor):
    """[B, 5C, H, W] (from | to | outer_from | outer_to | between) →
    (image [2B], outer [2B], slice_between [B])."""
    a, b, oa, ob, between = _split(quintet, 5)
    return torch.cat([a, b]), torch.cat([oa, ob]), between


def prepare_batch_septets(septet: torch.Tensor):
    """[B, 7C, H, W] (from | to | outer_from | outer_to | outer2_from |
    outer2_to | between) → (image [2B], outer [2B], outer2 [2B],
    slice_between [B])."""
    a, b, oa, ob, o2a, o2b, between = _split(septet, 7)
    return (torch.cat([a, b]), torch.cat([oa, ob]), torch.cat([o2a, o2b]),
            between)


def device_batch(raw: Dict, cfg: AugmentConfig, device, latent_taps: int = 2,
                 generator: Optional[torch.Generator] = None,
                 with_mask: bool = False) -> Dict[str, torch.Tensor]:
    """A sampler batch (``triplet`` [B, H, W, kC]: numpy from
    ``TripletSampler``, or a tensor already on the device from
    ``DeviceCachedSampler``) as the train step's NCHW batch on ``device``:
    upload (to a CUDA device from pinned memory, without blocking the
    host: PyTorch's caching host allocator keeps the pinned buffer until
    its copy has completed), augment (random ops drawn from
    ``generator``), split into ``image`` / ``slice_between`` (+ ``outer``
    / ``outer2`` for 4 / 6 latent taps), with ``alpha_from``,
    ``alpha_to``, ``is_inbetween`` and ``alpha_features`` (the alpha
    probes' slice geometry [B, 5]) where the sampler gives them.
    ``with_mask``: the last channel is the loss mask
    (``TripletSampler(use_masks=True)``), which rode through the
    augmentation and becomes ``loss_mask`` [B, 1, H, W]."""
    cuda = torch.device(device).type == "cuda"

    def put(a):
        if isinstance(a, torch.Tensor):
            return a.to(device)
        t = torch.from_numpy(np.ascontiguousarray(a))
        return t.pin_memory().to(device, non_blocking=True) if cuda \
            else t.to(device)

    with span("data.augment"):
        x = augment_batch(put(raw["triplet"]).permute(0, 3, 1, 2), cfg,
                          generator)
        batch = {}
        if with_mask:
            batch["loss_mask"] = x[:, -1:]
            x = x[:, :-1]
        if latent_taps == 6:
            (batch["image"], batch["outer"], batch["outer2"],
             batch["slice_between"]) = prepare_batch_septets(x)
        elif latent_taps == 4:
            (batch["image"], batch["outer"],
             batch["slice_between"]) = prepare_batch_quintets(x)
        else:
            batch["image"], batch["slice_between"] = prepare_batch_pairs(x)
        batch = {k: v.contiguous() for k, v in batch.items()}
        for key in ("alpha_from", "alpha_to", "is_inbetween",
                    "alpha_features"):
            if key in raw:
                batch[key] = put(raw[key])
        return batch
