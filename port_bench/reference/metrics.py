"""SSIM, PSNR and VIF per slice of [S, H, W] volumes, in float64.

- SSIM (Wang et al. 2004, as ``skimage.metrics.structural_similarity``
  computes it): a uniform ``win`` x ``win`` window, sample covariances
  (divided by N - 1), K1 0.01, K2 0.03, the mean over the window
  positions that lie inside the image; box sums from integral images.
- PSNR: ``10 log10(range^2 / MSE)``.
- VIF (pixel domain, Sheikh and Bovik 2006; the LIVE ``vifp_mscale``):
  both images quantised to 8 bits, 4 scales with Gaussian windows of
  size ``2^(5 - s) + 1`` and sigma a fifth of it (truncated at 4 sigma,
  ``scipy.ndimage``'s half-sample reflection at the borders), decimation
  by 2 after filtering from the second scale on, the noise variance 2.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def _box_valid(x: torch.Tensor, win: int) -> torch.Tensor:
    """Means over every ``win`` x ``win`` window inside [S, H, W]."""
    c = F.pad(x.cumsum(-1).cumsum(-2), (1, 0, 1, 0))
    s = (c[:, win:, win:] - c[:, :-win, win:] - c[:, win:, :-win]
         + c[:, :-win, :-win])
    return s / (win * win)


def ssim(ref: torch.Tensor, dist: torch.Tensor, data_range: float = 1.0,
         win: int = 7) -> torch.Tensor:
    x, y = ref.double(), dist.double()
    ux, uy = _box_valid(x, win), _box_valid(y, win)
    uxx, uyy, uxy = (_box_valid(x * x, win), _box_valid(y * y, win),
                     _box_valid(x * y, win))
    n = win * win
    norm = n / (n - 1.0)
    vx, vy = norm * (uxx - ux * ux), norm * (uyy - uy * uy)
    vxy = norm * (uxy - ux * uy)
    c1, c2 = (0.01 * data_range) ** 2, (0.03 * data_range) ** 2
    s = ((2 * ux * uy + c1) * (2 * vxy + c2)
         / ((ux * ux + uy * uy + c1) * (vx + vy + c2)))
    return s.mean(dim=(-2, -1))


def psnr(ref: torch.Tensor, dist: torch.Tensor,
         data_range: float = 1.0) -> torch.Tensor:
    mse = ((ref.double() - dist.double()) ** 2).mean(dim=(-2, -1))
    return 10.0 * torch.log10(data_range ** 2 / mse)


def mse(ref: torch.Tensor, dist: torch.Tensor) -> torch.Tensor:
    return ((ref.double() - dist.double()) ** 2).mean(dim=(-2, -1))


def _gauss(sigma: float) -> np.ndarray:
    r = int(4.0 * sigma + 0.5)
    x = np.arange(-r, r + 1, dtype=np.float64)
    phi = np.exp(-0.5 * (x / sigma) ** 2)
    return phi / phi.sum()


def _reflect_index(n: int, r: int) -> torch.Tensor:
    i = np.arange(-r, n + r)
    i = np.where(i < 0, -i - 1, i)
    i = np.where(i >= n, 2 * n - i - 1, i)
    return torch.from_numpy(i)


def _filter(x: torch.Tensor, sigma: float) -> torch.Tensor:
    """Separable Gaussian of [S, H, W] (float64), reflected borders."""
    k = torch.from_numpy(_gauss(sigma)).to(x.device)
    r = (k.numel() - 1) // 2
    h, w = x.shape[-2:]
    x = x[:, _reflect_index(h, r).to(x.device)][:, :, _reflect_index(
        w, r).to(x.device)]
    x = F.conv2d(x[:, None], k.view(1, 1, -1, 1))
    return F.conv2d(x, k.view(1, 1, 1, -1))[:, 0]


def vif(ref: torch.Tensor, dist: torch.Tensor, sigma_nsq: float = 2.0,
        data_range: float = 1.0) -> torch.Tensor:
    eps = 1e-10

    def quant(v):
        v = torch.round(torch.clamp(v.float() * (255.0 / data_range), 0.0,
                                    255.0)).double()
        return v - v.mean(dim=(-2, -1), keepdim=True)

    x, y = quant(ref), quant(dist)
    num = torch.zeros(x.shape[0], dtype=torch.float64, device=x.device)
    den = torch.zeros_like(num)
    for scale in range(1, 5):
        sd = (2 ** (5 - scale) + 1) / 5.0
        if scale > 1:
            x = _filter(x, sd)[:, ::2, ::2]
            y = _filter(y, sd)[:, ::2, ::2]
        mx, my = _filter(x, sd), _filter(y, sd)
        sxx = torch.clamp(_filter(x * x, sd) - mx * mx, min=0.0)
        syy = torch.clamp(_filter(y * y, sd) - my * my, min=0.0)
        sxy = _filter(x * y, sd) - mx * my
        g = sxy / (sxx + eps)
        sv = syy - g * sxy
        low_x = sxx < eps
        g = torch.where(low_x, 0.0, g)
        sv = torch.where(low_x, syy, sv)
        sxx = torch.where(low_x, 0.0, sxx)
        low_y = syy < eps
        g = torch.where(low_y, 0.0, g)
        sv = torch.where(low_y, 0.0, sv)
        neg = g < 0
        sv = torch.where(neg, syy, sv)
        g = torch.where(neg, 0.0, g)
        sv = torch.clamp(sv, min=eps)
        num = num + torch.log10(1.0 + g * g * sxx / (sv + sigma_nsq)).sum(
            dim=(-2, -1))
        den = den + torch.log10(1.0 + sxx / sigma_nsq).sum(dim=(-2, -1))
    return torch.where(den != 0, num / den, torch.full_like(num, float("nan")))
