"""Device selection and float32 precision for the port's entry points."""
from __future__ import annotations

import contextlib
import warnings

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the CUDA device. A CUDA device that is not present
    raises: the port never falls back to the CPU unless the caller asks
    for it with ``device="cpu"``."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port on the CPU")
    return dev


@contextlib.contextmanager
def f32_exact():
    """Full IEEE float32 for convolutions and matrix products while the
    block runs (TF32 off for cuDNN and cuBLAS), restored afterwards.

    cuDNN runs float32 convolutions in TF32 by default, which keeps about
    three decimal digits; the reference's float32 models and its VIF
    banded matmuls (``Precision.HIGHEST``) are full float32, so every
    entry point of the port wraps its float32 work in this. bfloat16
    work is unaffected."""
    with warnings.catch_warnings():
        # newer torch releases deprecate the allow_tf32 attributes in
        # favour of fp32_precision; the legacy pair works on every 2.x
        warnings.simplefilter("ignore")
        saved = (torch.backends.cudnn.allow_tf32,
                 torch.backends.cuda.matmul.allow_tf32)
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32) = saved
