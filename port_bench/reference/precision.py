"""The reference's precision: float32 with TF32 off, or the TF32 control.

On a CUDA device ``tf32`` turns on cuDNN's and cuBLAS's TF32 paths, as a
later change tempted to trade precision for speed would. On the CPU, which
has no TF32, ``round_tf32`` rounds the operands of every convolution and
product to TF32's 10-bit mantissa instead.
"""
from __future__ import annotations

import contextlib
import warnings

import torch

PRECISIONS = ("float32", "tf32")


@contextlib.contextmanager
def precision(mode: str = "float32"):
    """Run the block in ``mode`` (see the module docstring)."""
    if mode not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}, got {mode!r}")
    tf32 = mode == "tf32"
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        saved = (torch.backends.cudnn.allow_tf32,
                 torch.backends.cuda.matmul.allow_tf32)
        torch.backends.cudnn.allow_tf32 = tf32
        torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        yield
    finally:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32) = saved


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to TF32 (10 mantissa bits, round to nearest even),
    kept in float32."""
    bits = x.contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    rounded = (bits + 0xFFF + lsb) & ~0x1FFF
    return rounded.view(torch.float32)


def operands(mode: str, device: torch.device, *xs: torch.Tensor):
    """The operands of one convolution or product: rounded to TF32 for the
    CPU control, as they are."""
    if mode == "tf32" and device.type != "cuda":
        # the rounding passes gradients through unchanged
        return tuple(None if x is None else
                     x + (round_tf32(x.detach()) - x).detach() for x in xs)
    return xs
