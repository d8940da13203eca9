"""Image-quality metrics (SSIM / MS-SSIM / PSNR / VIF) over [S, H, W]
volumes.

Port of ``superresolution_aniso_mri_tpu/ops/metrics.py:35-363``.
Every function takes float tensors on any device and is batched over the
slice axis; results are float32 per slice. ``ssim_volume`` here is the
plain PyTorch version of the CUDA SSIM kernel (``ops/cuda_kernels.py``):
the CPU path of ``ssim_volume_fused`` and the check the kernel is held
to on the card.

Precision: everything is float32. The VIF gaussians are banded float32
matrix products run with TF32 off (``device.f32_exact``), as the
reference runs them at ``Precision.HIGHEST``; SSIM uses average pooling,
which has no TF32 path.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from ..device import f32_exact


# ---------------------------------------------------------------------------
# separable filters
# ---------------------------------------------------------------------------

def _box_mean_valid(x: torch.Tensor, win: int) -> torch.Tensor:
    """VALID ``win x win`` box mean of [S, H, W] → [S, H-win+1, W-win+1]:
    a mean over rows, then over columns (the reference's separable
    order)."""
    x = F.avg_pool2d(x[:, None], (win, 1), stride=1)
    return F.avg_pool2d(x, (1, win), stride=1)[:, 0]


def _gauss_kernel1d(sigma: float, radius: int) -> np.ndarray:
    """scipy.ndimage._gaussian_kernel1d: truncated, normalised gaussian."""
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    phi = np.exp(-0.5 * (x / sigma) ** 2)
    return (phi / phi.sum()).astype(np.float32)


@functools.lru_cache(maxsize=128)
def _band_reflect(n: int, sigma: float, truncate: float = 4.0) -> np.ndarray:
    """[n, n] banded matrix B with B @ x == scipy gaussian correlate1d
    (mode='reflect'), kernels wider than the axis included (periodic
    triangular reflection, like scipy's repeated mirroring). Cached;
    callers must not write to the result."""
    k = _gauss_kernel1d(sigma, int(truncate * sigma + 0.5))
    m = len(k)
    r = m // 2
    idx = np.arange(-r, n + r)
    j = np.mod(idx, 2 * n)
    ref = np.where(j < n, j, 2 * n - 1 - j)
    out = np.zeros((n, n), np.float32)
    rows = np.repeat(np.arange(n), m)
    cols = ref[np.arange(n)[:, None] + np.arange(m)].ravel()
    np.add.at(out, (rows, cols), np.tile(k, n))
    return out


def gaussian_filter2d(img: torch.Tensor, sigma: float,
                      truncate: float = 4.0) -> torch.Tensor:
    """scipy.ndimage.gaussian_filter (mode='reflect') over the last two
    axes of a float32 tensor, as two banded matrix products."""
    h, w = img.shape[-2], img.shape[-1]
    gh = torch.as_tensor(_band_reflect(h, round(float(sigma), 6), truncate),
                         device=img.device)
    gw = torch.as_tensor(_band_reflect(w, round(float(sigma), 6), truncate),
                         device=img.device).T
    with f32_exact():
        return torch.matmul(torch.matmul(gh, img), gw)


# ---------------------------------------------------------------------------
# SSIM
# ---------------------------------------------------------------------------

def ssim_volume(ref: torch.Tensor, dist: torch.Tensor,
                data_range: float = 1.0, win_size: int = 7) -> torch.Tensor:
    """skimage-compatible SSIM per slice of [S, H, W] → [S]: uniform
    window, unbiased covariance (NP/(NP-1)), K1=0.01, K2=0.03, mean over
    the VALID map (== skimage's border crop)."""
    im1 = ref.to(torch.float32)
    im2 = dist.to(torch.float32)
    f = functools.partial(_box_mean_valid, win=win_size)
    ux, uy = f(im1), f(im2)
    uxx, uyy, uxy = f(im1 * im1), f(im2 * im2), f(im1 * im2)
    np_ = win_size * win_size
    cov_norm = np_ / (np_ - 1.0)
    vx = cov_norm * (uxx - ux * ux)
    vy = cov_norm * (uyy - uy * uy)
    vxy = cov_norm * (uxy - ux * uy)
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    a1 = 2.0 * ux * uy + c1
    a2 = 2.0 * vxy + c2
    b1 = ux * ux + uy * uy + c1
    b2 = vx + vy + c2
    return ((a1 * a2) / (b1 * b2)).mean(dim=(-2, -1))


def ssim2d(im1: torch.Tensor, im2: torch.Tensor, data_range: float = 1.0,
           win_size: int = 7) -> torch.Tensor:
    """SSIM of one [H, W] image pair (a scalar tensor)."""
    return ssim_volume(im1[None], im2[None], data_range, win_size)[0]


def _ssim_cs2d(im1: torch.Tensor, im2: torch.Tensor, data_range: float,
               win_size: int):
    """Per-slice means of (luminance*cs, cs) for one scale of MS-SSIM,
    over [S, H, W] pairs → two [S] tensors."""
    im1 = im1.to(torch.float32)
    im2 = im2.to(torch.float32)
    f = functools.partial(_box_mean_valid, win=win_size)
    ux, uy = f(im1), f(im2)
    uxx, uyy, uxy = f(im1 * im1), f(im2 * im2), f(im1 * im2)
    np_ = win_size * win_size
    cov_norm = np_ / (np_ - 1.0)
    vx = cov_norm * (uxx - ux * ux)
    vy = cov_norm * (uyy - uy * uy)
    vxy = cov_norm * (uxy - ux * uy)
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    cs = (2.0 * vxy + c2) / (vx + vy + c2)
    lum = (2.0 * ux * uy + c1) / (ux * ux + uy * uy + c1)
    return (lum * cs).mean(dim=(-2, -1)), cs.mean(dim=(-2, -1))


_MSSSIM_WEIGHTS = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333)


def msssim_volume(ref: torch.Tensor, dist: torch.Tensor,
                  data_range: float = 1.0, win_size: int = 7,
                  levels: int = 5) -> torch.Tensor:
    """Multi-scale SSIM (Wang et al. 2003) per slice of [S, H, W] → [S].

    The standard 5-level weights, renormalised when ``levels`` < 5 (a
    64² slice supports 3 dyadic scales with a 7-pixel window); the
    contrast-structure term at every scale and the luminance-weighted
    SSIM at the coarsest, negative terms clamped to 0 (as
    tf.image.ssim_multiscale does); 2x2 average pooling between scales.
    Raises ValueError when the coarsest scale is smaller than the
    window."""
    h0, w0 = ref.shape[-2], ref.shape[-1]
    min_side = min(h0, w0) // (2 ** (levels - 1))
    if min_side < win_size:
        raise ValueError(
            f"msssim2d: {h0}x{w0} input supports at most "
            f"{max(1, int(np.log2(min(h0, w0) / win_size)) + 1)} "
            f"dyadic levels with win_size={win_size}, got levels={levels} "
            f"(coarsest scale {min_side} < window)")
    w = np.asarray(_MSSSIM_WEIGHTS[:levels], np.float32)
    w = w / w.sum()
    im1 = ref.to(torch.float32)
    im2 = dist.to(torch.float32)
    val = torch.ones(ref.shape[:-2], dtype=torch.float32, device=ref.device)
    for lv in range(levels):
        s, cs = _ssim_cs2d(im1, im2, data_range, win_size)
        term = s if lv == levels - 1 else cs
        val = val * torch.clamp_min(term, 0.0) ** float(w[lv])
        if lv != levels - 1:
            h = (im1.shape[-2] // 2) * 2
            ww = (im1.shape[-1] // 2) * 2

            def pool(x):
                return (x[..., :h:2, :ww:2] + x[..., 1:h:2, :ww:2]
                        + x[..., :h:2, 1:ww:2] + x[..., 1:h:2, 1:ww:2]) / 4.0

            im1, im2 = pool(im1), pool(im2)
    return val


def msssim2d(im1: torch.Tensor, im2: torch.Tensor, data_range: float = 1.0,
             win_size: int = 7, levels: int = 5) -> torch.Tensor:
    """MS-SSIM of one [H, W] image pair (a scalar tensor)."""
    return msssim_volume(im1[None], im2[None], data_range, win_size,
                         levels)[0]


# ---------------------------------------------------------------------------
# PSNR
# ---------------------------------------------------------------------------

def psnr_volume(ref: torch.Tensor, dist: torch.Tensor,
                data_range: float = 1.0) -> torch.Tensor:
    """skimage peak_signal_noise_ratio per slice: 10 log10(R^2 / mse)."""
    d = ref.to(torch.float32) - dist.to(torch.float32)
    mse = (d * d).mean(dim=(-2, -1))
    return 10.0 * torch.log10((data_range ** 2) / mse)


def psnr2d(im1: torch.Tensor, im2: torch.Tensor,
           data_range: float = 1.0) -> torch.Tensor:
    return psnr_volume(im1[None], im2[None], data_range)[0]


# ---------------------------------------------------------------------------
# VIF (pixel-domain, 4 scales)
# ---------------------------------------------------------------------------

def _quantize_u8(x: torch.Tensor, data_range: float = 1.0) -> torch.Tensor:
    """uint8 quantisation of a [0, data_range] image, kept in float."""
    return torch.round(torch.clamp(x * (255.0 / data_range), 0.0, 255.0))


def vif_volume(ref: torch.Tensor, dist: torch.Tensor, sigma_nsq: float = 2.0,
               data_range: float = 1.0, quantize: bool = True) -> torch.Tensor:
    """4-scale pixel-domain VIF per slice of [S, H, W] → [S]; NaN where
    the reference slice is uniform (den == 0)."""
    eps = 1e-10
    ref = ref.to(torch.float32)
    dist = dist.to(torch.float32)
    if quantize:
        ref = _quantize_u8(ref, data_range)
        dist = _quantize_u8(dist, data_range)
    # centre each slice on its mean: a no-op for VIF analytically, but
    # it removes the float32 cancellation of E[x^2] - mu^2 (a uniform
    # slice must give exactly zero variance, hence NaN)
    ref = ref - ref.mean(dim=(-2, -1), keepdim=True)
    dist = dist - dist.mean(dim=(-2, -1), keepdim=True)
    num = torch.zeros(ref.shape[:-2], dtype=torch.float32, device=ref.device)
    den = torch.zeros_like(num)
    zero = torch.zeros((), dtype=torch.float32, device=ref.device)
    for scale in range(1, 5):
        n = 2 ** (4 - scale + 1) + 1
        sd = n / 5.0
        if scale > 1:
            ref = gaussian_filter2d(ref, sd)[..., ::2, ::2]
            dist = gaussian_filter2d(dist, sd)[..., ::2, ::2]
        mu1, mu2 = gaussian_filter2d(ref, sd), gaussian_filter2d(dist, sd)
        mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
        sigma1_sq = gaussian_filter2d(ref * ref, sd) - mu1_sq
        sigma2_sq = gaussian_filter2d(dist * dist, sd) - mu2_sq
        sigma12 = gaussian_filter2d(ref * dist, sd) - mu1_mu2

        sigma1_sq = torch.clamp(sigma1_sq, min=0.0)
        sigma2_sq = torch.clamp(sigma2_sq, min=0.0)

        g = sigma12 / (sigma1_sq + eps)
        sv_sq = sigma2_sq - g * sigma12

        small1 = sigma1_sq < eps
        g = torch.where(small1, zero, g)
        sv_sq = torch.where(small1, sigma2_sq, sv_sq)
        sigma1_sq = torch.where(small1, zero, sigma1_sq)

        small2 = sigma2_sq < eps
        g = torch.where(small2, zero, g)
        sv_sq = torch.where(small2, zero, sv_sq)

        neg_g = g < 0.0
        sv_sq = torch.where(neg_g, sigma2_sq, sv_sq)
        g = torch.where(neg_g, zero, g)
        sv_sq = torch.clamp(sv_sq, min=eps)

        num = num + torch.log10(
            1.0 + g * g * sigma1_sq / (sv_sq + sigma_nsq)).sum(dim=(-2, -1))
        den = den + torch.log10(1.0 + sigma1_sq / sigma_nsq).sum(dim=(-2, -1))
    return torch.where(den != 0.0, num / den,
                       torch.full_like(num, float("nan")))


def vif2d(ref: torch.Tensor, dist: torch.Tensor, sigma_nsq: float = 2.0,
          quantize: bool = True, data_range: float = 1.0) -> torch.Tensor:
    return vif_volume(ref[None], dist[None], sigma_nsq, data_range,
                      quantize)[0]


# ---------------------------------------------------------------------------
# slice masks and masked aggregation
# ---------------------------------------------------------------------------

def synth_slice_mask(num_slices: int, downsample_steps: int,
                     conv_interpol: bool = False) -> np.ndarray:
    """Boolean mask [S]: True where a slice was SYNTHESIZED. Every
    ds-th slice is original; tail slices off the grid are original too."""
    if downsample_steps < 1:
        raise ValueError(
            f"downsample_steps must be >= 1, got {downsample_steps}")
    slice_ids = np.arange(num_slices)
    keep = None
    if (num_slices - 1) % downsample_steps != 0:
        remain = (num_slices - 1) % downsample_steps
        keep = slice_ids[-remain:]
        slice_ids = slice_ids[:-remain]
    if conv_interpol and slice_ids.shape[0] % downsample_steps != 0:
        remain = slice_ids.shape[0] % downsample_steps
        keep = slice_ids[-remain:] if keep is None else np.concatenate(
            (slice_ids[-remain:], keep))
        slice_ids = slice_ids[:-remain]
    original = slice_ids[::downsample_steps]
    if keep is not None:
        original = np.concatenate((original, keep))
    mask = np.ones(num_slices, dtype=bool)
    mask[original] = False
    return mask


def masked_mean(values: torch.Tensor, mask) -> torch.Tensor:
    """Mean over selected, finite entries; NaN when nothing is selected."""
    mask = torch.as_tensor(np.asarray(mask, bool), device=values.device)
    sel = mask & torch.isfinite(values)
    n_sel = sel.sum()
    total = torch.where(sel, values, torch.zeros_like(values)).sum()
    mean = total / torch.clamp(n_sel, min=1)
    return torch.where(n_sel > 0, mean, torch.full_like(mean, float("nan")))
