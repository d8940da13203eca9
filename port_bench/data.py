"""Seeded inputs, made on the device in a few large calls.

A volume is a smooth random field in [0, 1]: uniform noise on a coarse
grid (a slice in 8 and a pixel in 16 along each in-plane axis) blown up
trilinearly to the full shape, with a little fine noise; the same seed
gives the same volumes on every run. Volumes leave as float32 numpy
stacks [S, H, W], as a loader hands them to the program.
"""
from __future__ import annotations

from typing import List

import numpy as np
import torch
import torch.nn.functional as F


def volumes(seed: int, count: int, slices: int, h: int, w: int,
            device) -> List[np.ndarray]:
    g = torch.Generator(device=device).manual_seed(int(seed))
    coarse = torch.rand(count, 1, slices // 8 + 2, h // 16 + 2, w // 16 + 2,
                        generator=g, device=device)
    out = []
    for i in range(count):
        v = F.interpolate(coarse[i:i + 1], size=(slices, h, w),
                          mode="trilinear", align_corners=True)[0, 0]
        v = v + 0.05 * torch.rand(v.shape, generator=g, device=device)
        out.append(v.clamp(0.0, 1.0).cpu().numpy())
    return out
