"""Hand-written CUDA kernels of the port and their dispatch.

``ssim_volume_fused`` is the port of
``superresolution_aniso_mri_tpu/ops/pallas_kernels.py:100-114``: on a
CUDA tensor it launches the SSIM kernel of ``csrc/ssim.cu`` (built at
first use, ``ops/_build.py``); on a CPU tensor it runs the plain
PyTorch version ``ops/metrics.py::ssim_volume``. On the card nothing
falls back to the plain version: a build or launch failure raises.

``LAUNCHES`` counts kernel launches by kernel name; each wrapper adds
one where it launches its kernel and nowhere else, so a run can show
that its main path went through the kernel.
"""
from __future__ import annotations

import ctypes

import torch

from .metrics import ssim_volume

SSIM_WINDOWS = (3, 5, 7, 11)
_SSIM_FLAGS = ("-fmad=false",)  # keep the plain version's rounding order

LAUNCHES = {"ssim_slice": 0}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _ssim_library() -> ctypes.CDLL:
    from ._build import load_library

    lib = load_library("ssim", _SSIM_FLAGS)
    if not getattr(lib, "_sr_typed", False):
        lib.ssim_tiles_per_slice.argtypes = [ctypes.c_int] * 3
        lib.ssim_tiles_per_slice.restype = ctypes.c_int
        lib.ssim_volume_f32.argtypes = (
            [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
            + [ctypes.c_float, ctypes.c_float, ctypes.c_void_p])
        lib.ssim_volume_f32.restype = ctypes.c_int
        lib._sr_typed = True
    return lib


def ssim_volume_cuda(ref: torch.Tensor, dist: torch.Tensor,
                     data_range: float = 1.0,
                     win_size: int = 7) -> torch.Tensor:
    """Per-slice SSIM [S] of two contiguous float32 CUDA tensors [S, H, W]
    through the CUDA kernel, enqueued on the current stream."""
    if not (ref.is_cuda and dist.is_cuda and ref.device == dist.device):
        raise ValueError("ssim_volume_cuda needs both volumes on one "
                         "CUDA device")
    if ref.dtype != torch.float32 or dist.dtype != torch.float32:
        raise TypeError(f"ssim_volume_cuda takes float32, got "
                        f"{ref.dtype} / {dist.dtype}")
    if not (ref.is_contiguous() and dist.is_contiguous()):
        raise ValueError("ssim_volume_cuda takes contiguous tensors")
    if ref.ndim != 3 or ref.shape != dist.shape:
        raise ValueError(f"ssim_volume_cuda takes two [S, H, W] volumes of "
                         f"one shape, got {tuple(ref.shape)} / "
                         f"{tuple(dist.shape)}")
    if win_size not in SSIM_WINDOWS:
        raise ValueError(f"win_size must be one of {SSIM_WINDOWS}, got "
                         f"{win_size}")
    s, h, w = ref.shape
    if not 0 < s <= 65535 or min(h, w) < win_size:
        raise ValueError(f"ssim_volume_cuda: need 1..65535 slices of at "
                         f"least {win_size}x{win_size}, got {tuple(ref.shape)}")
    lib = _ssim_library()
    tiles = lib.ssim_tiles_per_slice(h, w, win_size)
    partials = torch.empty(s * tiles, dtype=torch.float32, device=ref.device)
    out = torch.empty(s, dtype=torch.float32, device=ref.device)
    with torch.cuda.device(ref.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.ssim_volume_f32(
            ref.data_ptr(), dist.data_ptr(), out.data_ptr(),
            partials.data_ptr(), s, h, w, win_size,
            (0.01 * data_range) ** 2, (0.03 * data_range) ** 2, stream)
    if err != 0:
        raise RuntimeError(f"SSIM kernel launch failed: cudaError {err}")
    LAUNCHES["ssim_slice"] += 1
    return out


def ssim_volume_fused(ref: torch.Tensor, dist: torch.Tensor,
                      data_range: float = 1.0,
                      win_size: int = 7) -> torch.Tensor:
    """Per-slice SSIM: the CUDA kernel for CUDA tensors, the plain
    PyTorch version for CPU tensors."""
    if ref.is_cuda:
        return ssim_volume_cuda(ref.to(torch.float32).contiguous(),
                                dist.to(torch.float32).contiguous(),
                                float(data_range), win_size)
    if ref.device.type == "cpu":
        return ssim_volume(ref, dist, data_range, win_size)
    raise ValueError(f"ssim_volume_fused: no path for device {ref.device}")
