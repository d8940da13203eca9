"""FLOPs of a training step and of volume synthesis, from shapes.

Counted by ``torch.utils.flop_counter.FlopCounterMode`` over the plain
reference (``reference/``) on the meta device, so no value is computed:
convolutions and matrix products at two FLOPs a multiply-add over the
whole window (the padded border included), forward and backward;
element-wise work (activations, BatchNorm, losses, Adam, the mixes)
counts 0, so every share of a peak built on these is a lower bound.
"""
from __future__ import annotations

import torch

from ..reference.model import Arch, Net, param_shapes
from ..reference.train import ae_combined_loss


def _meta_state(arch: Arch, grad: bool):
    dev = torch.device("meta")
    return {k: torch.empty(shape, device=dev).requires_grad_(
        grad and role not in ("bn_mean", "bn_var"))
        for k, (shape, role) in param_shapes(arch).items()}


def _count(fn) -> int:
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        fn()
    return int(counter.get_total_flops())


def train_step_flops(arch: Arch, pairs: int, size: int,
                     use_laploss: bool = True) -> int:
    """One ``ae_combined`` step on ``pairs`` pairs of ``size``² slices:
    the losses' forward passes and the gradient of every parameter."""
    state = _meta_state(arch, True)
    dev = torch.device("meta")
    batch = {"image": torch.empty(2 * pairs, arch.colors, size, size,
                                  device=dev),
             "slice_between": torch.empty(pairs, arch.colors, size, size,
                                          device=dev),
             "alpha_from": torch.empty(pairs, device=dev),
             "alpha_to": torch.empty(pairs, device=dev),
             "is_inbetween": torch.empty(pairs, device=dev)}
    names = [k for k, v in state.items() if v.requires_grad]

    def step():
        loss, _ = ae_combined_loss(Net(arch, state), batch, 1e-3, use_laploss)
        torch.autograd.grad(loss, [state[k] for k in names])

    return _count(step)


def encode_flops(arch: Arch, slices: int, h: int, w: int) -> int:
    state = _meta_state(arch, False)
    x = torch.empty(slices, arch.colors, h, w, device="meta")
    return _count(lambda: Net(arch, state).encode(x))


def decode_flops(arch: Arch, slices: int, h: int, w: int) -> int:
    state = _meta_state(arch, False)
    div = 2 ** arch.scales
    z = torch.empty(slices, arch.latent, h // div, w // div, device="meta")
    return _count(lambda: Net(arch, state).decode(z))


def synthesis_flops(arch: Arch, kept: int, alphas: int, h: int, w: int,
                    use_original: bool) -> int:
    """One volume of ``kept`` slices: the encode of every kept slice and
    the decode of the (kept - 1) x alphas in-between slices, and of the
    kept slices unless ``use_original``. Padding slices that the program
    may add are not counted."""
    decoded = (kept - 1) * alphas + (0 if use_original else kept)
    return encode_flops(arch, kept, h, w) + decode_flops(arch, decoded, h, w)


def ssim_counts(slices: int, h: int, w: int, win: int = 7):
    """(FLOPs, bytes) that per-slice SSIM of two float32 [S, H, W] stacks
    needs at the least: three products a pixel, running box sums of five
    maps over the window (two adds a pass and output, two passes), about
    twenty operations a window position for the index; both stacks read
    once and the per-slice values written once."""
    oh, ow = h - win + 1, w - win + 1
    flops = slices * (3 * h * w + 5 * 2 * 2 * oh * ow + 20 * oh * ow)
    nbytes = 2 * slices * h * w * 4 + slices * 4
    return flops, nbytes
