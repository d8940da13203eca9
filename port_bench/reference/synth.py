"""Volume synthesis: encode the kept slices, mix the latents of each
neighbouring pair at the in-between positions, decode, interleave.

The linear mix is ``a * z[j + 1] + (1 - a) * z[j]``; the lanczos3 mix
weighs the six latents at offsets -2 … 3 from pair ``j`` (clamped to the
stack) by the normalised Lanczos kernel of radius 3, ``3 sin(pi x)
sin(pi x / 3) / (pi x)^2`` at ``x = offset - a``. The volume is each kept
slice (decoded, or with ``use_original`` the input itself) followed by
its pair's in-between slices, then the last kept slice, clamped to [0,
1]. Eval mode: BatchNorm uses the running statistics. The passes run in
blocks of ``block`` slices.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .model import Net

LANCZOS3_OFFSETS = (-2, -1, 0, 1, 2, 3)


def lanczos3_weights(alphas) -> np.ndarray:
    """[A] positions in (0, 1) → [A, 6] weights (float64)."""
    out = []
    for a in np.asarray(alphas, np.float64):
        w = []
        for off in LANCZOS3_OFFSETS:
            x = off - a
            if x == 0:
                w.append(1.0)
            elif abs(x) < 3:
                px = math.pi * x
                w.append(3.0 * math.sin(px) * math.sin(px / 3.0) / (px * px))
            else:
                w.append(0.0)
        w = np.asarray(w)
        out.append(w / w.sum())
    return np.asarray(out)


@torch.no_grad()
def synthesize(net: Net, kept: torch.Tensor, alphas, interp: str,
               use_original: bool, block: int = 32) -> torch.Tensor:
    """kept [K, 1, H, W] float32 → volume [(K - 1)(A + 1) + 1, H, W]."""
    k = kept.shape[0]
    a = np.asarray(alphas, np.float64)
    z = torch.cat([net.encode(kept[i:i + block])
                   for i in range(0, k, block)])
    mixed = []
    for j in range(k - 1):
        if interp == "linear":
            for al in a:
                mixed.append(float(al) * z[j + 1] + (1.0 - float(al)) * z[j])
        elif interp == "lanczos3":
            for w in lanczos3_weights(a):
                acc = torch.zeros_like(z[0])
                for wt, off in zip(w, LANCZOS3_OFFSETS):
                    acc = acc + float(np.float32(wt)) * z[min(max(j + off, 0),
                                                              k - 1)]
                mixed.append(acc)
        else:
            raise ValueError(f"unknown latent mix {interp!r}")
    mixed = torch.stack(mixed)
    dec = torch.cat([net.decode(mixed[i:i + block])
                     for i in range(0, mixed.shape[0], block)])[:, 0]
    recon = (kept[:, 0] if use_original else torch.cat(
        [net.decode(z[i:i + block]) for i in range(0, k, block)])[:, 0])
    n_a = len(a)
    slices = []
    for j in range(k - 1):
        slices.append(recon[j])
        slices.extend(dec[j * n_a:(j + 1) * n_a])
    slices.append(recon[k - 1])
    return torch.stack(slices).clamp(0.0, 1.0)
