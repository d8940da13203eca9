"""Seeded weight sets, drawn on the device in one call each and split by
the reference's parameter shapes (``reference.model.param_shapes``),
named as the port's ``state_dict`` names them.

Convolution kernels are N(0, 1 / (1.04 fan_in)) (the architecture's
initialisation), biases N(0, 0.01^2). A fresh set (``trained=False``, a
training start) has identity BatchNorms and running statistics (0, 1);
a trained set (checkpoints being scored or served) perturbs the
BatchNorm scales and shifts and draws running means N(0, 0.1^2) and
variances in [0.5, 1.5).
"""
from __future__ import annotations

import math
from typing import Dict

import torch

from .reference.model import Arch, param_shapes


def weight_set(arch: Arch, seed: int, device,
               trained: bool) -> Dict[str, torch.Tensor]:
    shapes = param_shapes(arch)
    total = sum(math.prod(s) for s, _ in shapes.values())
    g = torch.Generator(device=device).manual_seed(int(seed))
    normal = torch.randn(total, generator=g, device=device)
    uniform = torch.rand(total, generator=g, device=device)
    out, at = {}, 0
    for name, (shape, role) in shapes.items():
        n = math.prod(shape)
        r, u = normal[at:at + n].view(shape), uniform[at:at + n].view(shape)
        at += n
        if role == "conv_w":
            fan_in = shape[1] * shape[2] * shape[3]
            t = r / math.sqrt(1.04 * fan_in)
        elif role == "bias":
            t = 0.01 * r
        elif role == "bn_w":
            t = 1.0 + 0.1 * r if trained else torch.ones_like(r)
        elif role == "bn_b":
            t = 0.1 * r if trained else torch.zeros_like(r)
        elif role == "bn_mean":
            t = 0.1 * r if trained else torch.zeros_like(r)
        else:
            t = 0.5 + u if trained else torch.ones_like(r)
        out[name] = t.contiguous()
    return out
