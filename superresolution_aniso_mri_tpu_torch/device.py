"""Device selection, float32 precision and device→host copies for the
port's entry points."""
from __future__ import annotations

import contextlib
import functools
import warnings
from typing import Dict, List, Sequence

import numpy as np
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


@functools.lru_cache(maxsize=None)
def device_constant(values: tuple, dtype: torch.dtype,
                    device: torch.device) -> torch.Tensor:
    """The tensor of ``values``, uploaded once per dtype and device and
    shared by every caller, which must not write to it. A train step
    captured in a CUDA graph (``train/steps.py``) may not copy from the
    host, so the step's constants come from here: the eager warm-up
    steps before the capture make them."""
    return torch.tensor(values, dtype=dtype, device=device)


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


# the optimizer's element-wise work and a checkpoint's device→host copy
# go in groups of at most this many bytes, so their temporaries stay
# bounded: a recipe VAE head alone is 4 GiB
GROUP_BYTES = 1 << 30


def byte_groups(tensors: Sequence[torch.Tensor],
                limit: int = GROUP_BYTES) -> List[List[int]]:
    """Consecutive index groups of ``tensors``, each of at most ``limit``
    bytes (a larger tensor makes a group of its own)."""
    groups: List[List[int]] = []
    size = limit
    for i, t in enumerate(tensors):
        nbytes = t.numel() * t.element_size()
        if size + nbytes > limit:
            groups.append([])
            size = 0
        groups[-1].append(i)
        size += nbytes
    return groups


def to_host(dicts: Sequence[Dict[str, torch.Tensor]],
            limit: int = 256 << 20) -> List[Dict[str, np.ndarray]]:
    """Every float32 tensor of ``dicts`` as numpy arrays, copied in few
    device→host transfers: tensors are concatenated on the device in
    groups of at most ``limit`` bytes (a larger one is copied alone), so
    the copy never holds more than one group's extra memory on the
    device."""
    keys = [(j, k) for j, d in enumerate(dicts) for k in d]
    tensors = [dicts[j][k].detach() for j, k in keys]
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError("checkpoint tensors must be float32")
    out: List[Dict[str, np.ndarray]] = [{} for _ in dicts]
    for group in byte_groups(tensors, limit):
        parts = [tensors[i].reshape(-1) for i in group]
        flat = (parts[0] if len(parts) == 1 else torch.cat(parts)).cpu()
        flat = flat.numpy()
        at = 0
        for i in group:
            j, k = keys[i]
            n = tensors[i].numel()
            out[j][k] = flat[at:at + n].reshape(tensors[i].shape)
            at += n
    return out
