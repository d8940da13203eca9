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
from typing import Dict, NamedTuple, Tuple

import torch

from .metrics import ssim_volume

SSIM_WINDOWS = (3, 5, 7, 11)
_SSIM_FLAGS = ("-fmad=false",)  # keep the plain version's rounding order
# SSIM kernel geometry (csrc/ssim.cu): a CTA of at most MAX_THREADS
# threads, each owning COLS_PER_THREAD adjacent columns, takes a band of
# MIN_BAND_ROWS..MAX_BAND_ROWS output rows; bands are as tall as still
# gives CTAS_PER_SM CTAs for each SM of the card.
MAX_THREADS = 256
COLS_PER_THREAD = 2
MAX_STRIP_OUT = COLS_PER_THREAD * MAX_THREADS - 16
MIN_BAND_ROWS, MAX_BAND_ROWS = 12, 40
CTAS_PER_SM = 4
_INT_MAX = 2 ** 31 - 1

LAUNCHES = {"ssim_slice": 0}
_TICKETS: Dict[Tuple[int, int], torch.Tensor] = {}


class SsimPlan(NamedTuple):
    """Launch geometry of the SSIM kernel for one [H, W] slice: the
    (H-win+1) x (W-win+1) map is cut into ``bands`` bands of
    ``band_rows`` output rows and ``strips`` strips of ``strip_cols``
    output columns (the last band and strip may be shorter); one CTA of
    ``threads`` threads, each owning ``COLS_PER_THREAD`` adjacent
    columns, computes one band of one strip from its input rows and
    columns (the map's plus ``win - 1`` halo rows and columns) and writes
    one partial sum."""
    band_rows: int
    bands: int
    strip_cols: int
    strips: int
    threads: int

    @property
    def ctas_per_slice(self) -> int:
        return self.bands * self.strips


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def ssim_plan(s: int, h: int, w: int, win: int, sms: int) -> SsimPlan:
    """Strips as wide as ``MAX_THREADS`` threads can take with their
    halo, and bands as tall as leaves ``CTAS_PER_SM`` CTAs on each of
    ``sms`` SMs over ``s`` slices (within
    ``MIN_BAND_ROWS..MAX_BAND_ROWS``; taller bands read fewer halo rows
    twice); the last band and strip may be shorter."""
    oh, ow = h - win + 1, w - win + 1
    if oh < 1 or ow < 1:
        raise ValueError(f"ssim_plan: a {h}x{w} slice is smaller than the "
                         f"{win}x{win} window")
    strips = _cdiv(ow, MAX_STRIP_OUT)
    per_cta = _cdiv(s * strips * oh, CTAS_PER_SM * sms)
    band_rows = min(max(per_cta, MIN_BAND_ROWS), MAX_BAND_ROWS)
    bands = _cdiv(oh, band_rows)
    strip_cols = _cdiv(ow, strips)
    cols_in = min(strip_cols, ow) + win - 1
    threads = 32 * _cdiv(_cdiv(cols_in, COLS_PER_THREAD), 32)
    return SsimPlan(_cdiv(oh, bands), bands, strip_cols, strips, threads)


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _ssim_library() -> ctypes.CDLL:
    from ._build import load_library

    lib = load_library("ssim", _SSIM_FLAGS)
    if not getattr(lib, "_sr_typed", False):
        lib.ssim_volume_f32.argtypes = (
            [ctypes.c_void_p] * 5 + [ctypes.c_int] * 9
            + [ctypes.c_float, ctypes.c_float, ctypes.c_void_p])
        lib.ssim_volume_f32.restype = ctypes.c_int
        lib.ssim_div_mismatches.argtypes = (
            [ctypes.c_int] + [ctypes.c_void_p] * 3)
        lib.ssim_div_mismatches.restype = ctypes.c_int
        lib._sr_typed = True
    return lib


def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _tickets(device: torch.device, stream: int, s: int) -> torch.Tensor:
    """Per-slice tickets of the kernel's last-CTA reduction, one buffer
    per device and stream: zeroed once, and left zero by every launch.
    Zeroing them on every call instead adds a fill kernel, 2-4 us on
    an H100 against the kernel's ~70 us."""
    key = (device.index, stream)
    buf = _TICKETS.get(key)
    if buf is None or buf.numel() < s:
        buf = torch.zeros(s, dtype=torch.int32, device=device)
        _TICKETS[key] = buf
    return buf


def ssim_volume_cuda(ref: torch.Tensor, dist: torch.Tensor,
                     data_range: float = 1.0,
                     win_size: int = 7) -> torch.Tensor:
    """Per-slice SSIM [S] of two contiguous float32 CUDA tensors [S, H, W]
    through the CUDA kernel, in one launch on the current stream."""
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
    if s < 1 or min(h, w) < win_size:
        raise ValueError(f"ssim_volume_cuda: need slices of at least "
                         f"{win_size}x{win_size}, got {tuple(ref.shape)}")
    plan = ssim_plan(s, h, w, win_size, _sm_count(ref.device))
    if s * plan.ctas_per_slice > _INT_MAX:
        raise ValueError(f"ssim_volume_cuda: {tuple(ref.shape)} needs more "
                         f"than 2**31 - 1 CTAs")
    lib = _ssim_library()
    partials = torch.empty(s * plan.ctas_per_slice, dtype=torch.float32,
                           device=ref.device)
    out = torch.empty(s, dtype=torch.float32, device=ref.device)
    with torch.cuda.device(ref.device):
        stream = torch.cuda.current_stream().cuda_stream
        tickets = _tickets(ref.device, stream, s)
        err = lib.ssim_volume_f32(
            ref.data_ptr(), dist.data_ptr(), out.data_ptr(),
            partials.data_ptr(), tickets.data_ptr(), s, h, w, win_size,
            *plan, (0.01 * data_range) ** 2, (0.03 * data_range) ** 2,
            stream)
    if err != 0:
        raise RuntimeError(f"SSIM kernel launch failed: cudaError {err}")
    LAUNCHES["ssim_slice"] += 1
    return out


def window_division_mismatches(win: int,
                               device: torch.device) -> Tuple[int, int]:
    """(count, smallest bit pattern) of the finite float32 inputs x, of
    all 2**32 bit patterns, for which the SSIM kernel's branch-free
    ``-(x / win)`` differs from IEEE division in any bit; (0, -1) when
    it never does. One launch over all patterns, a few ms on an H100."""
    if win not in SSIM_WINDOWS:
        raise ValueError(f"win must be one of {SSIM_WINDOWS}, got {win}")
    lib = _ssim_library()
    count = torch.zeros(1, dtype=torch.int64, device=device)
    first = torch.full((1,), -1, dtype=torch.int32, device=device)
    with torch.cuda.device(device):
        err = lib.ssim_div_mismatches(
            win, count.data_ptr(), first.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"division check launch failed: cudaError {err}")
    n, bits = int(count.item()), int(first.item()) & 0xFFFFFFFF
    return n, (bits if n else -1)


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
