"""FLOPs and the optimizer's least bytes of a ``vae_combined`` step, from
shapes.

FLOPs are counted as ``flops.py`` counts them, by
``torch.utils.flop_counter.FlopCounterMode`` over the plain reference
(``reference/vae.py``) on the meta device: convolutions and the heads'
matrix products at two FLOPs a multiply-add, forward and backward;
element-wise work counts 0. The optimizer's least bytes are what one
Adam update has to move at the least: read the parameter, its gradient
and both moments, write the parameter and both moments, 7 float32
values, 28 bytes a trained parameter.
"""
from __future__ import annotations

import math

import torch

from ..reference.model import Arch, Net
from ..reference.vae import (flat_size, param_shapes, trained_names,
                             vae_combined_loss)
from .flops import _count

ADAM_BYTES_PER_PARAM = 28


def train_step_flops(arch: Arch, pairs: int, size: int) -> int:
    """One ``vae_combined`` step on ``pairs`` pairs of ``size``² slices."""
    dev = torch.device("meta")
    names = set(trained_names(arch))
    state = {k: torch.empty(shape, device=dev).requires_grad_(k in names)
             for k, (shape, _) in param_shapes(arch).items()}
    batch = {"image": torch.empty(2 * pairs, arch.colors, size, size,
                                  device=dev),
             "slice_between": torch.empty(pairs, arch.colors, size, size,
                                          device=dev),
             **{k: torch.empty(pairs, device=dev)
                for k in ("alpha_from", "alpha_to", "is_inbetween")}}
    eps = torch.empty(2 * pairs, flat_size(arch), device=dev)

    def step():
        loss, _ = vae_combined_loss(Net(arch, state), batch, eps, 1e-3,
                                    200.0, 1.0)
        torch.autograd.grad(loss, [state[k] for k in sorted(names)])

    return _count(step)


def trained_params(arch: Arch) -> int:
    shapes = param_shapes(arch)
    return sum(math.prod(shapes[k][0]) for k in trained_names(arch))


def optimizer_least_bytes(arch: Arch) -> int:
    """Bytes one Adam update moves at the least over every trained
    parameter."""
    return ADAM_BYTES_PER_PARAM * trained_params(arch)
