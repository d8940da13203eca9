"""Roofline arithmetic and timing shared by the measurement commands
(``bench``, ``infer-roofline``, ``train-bench``).

- The H100's published dense peaks (NVIDIA's data sheet, SXM part, at
  its full 700 W): 989 TFLOP/s bf16, 495 TF32, 67 float32 outside the
  tensor cores, 3.35 TB/s of HBM. The port runs float32 convolutions
  and products with TF32 off (``device.f32_exact``), so a float32 row's
  compute floor divides by 67 TFLOP/s.
- ``count_flops``: the FLOPs of one call from its shapes, through
  ``torch.utils.flop_counter.FlopCounterMode``, which counts the matrix
  products and convolutions (forward and backward) at two FLOPs a
  multiply-add over the whole window, the padded border included, and
  counts element-wise work (activations, BatchNorm, losses, Adam) as 0.
  XLA's ``cost_analysis()`` counts a convolution's window only where it
  touches the unpadded input, and one FLOP an element for element-wise
  ops; at the widths of ``tests/torch_port_helpers.SMALL`` the port's
  count reads 1.8 % (a served volume) and 3.7 % (a train step) above
  XLA's. A count depends on shapes only: the same function counted on
  the card, on the CPU or on the meta device (no data) gives one number.
- Least bytes (``tensor_bytes``, ``module_bytes``; ``Floor``): the bytes
  a call must move at the least, each input, weight and optimizer-state
  byte read once and each output written once. The port has no cost
  model of the bytes its kernels really move, so no row claims XLA's
  ``bytes accessed``.
- ``card``: the card's name and power limit as ``nvidia-smi
  --query-gpu=name,power.limit --format=csv,noheader`` prints them; a
  card below 700 W runs slower under load, so every printed time stands
  beside them.
- Timing: ``sync_times``, ``synchronize`` around host wall clocks for
  the "sync" readings (JAX's ``block_until_ready``); ``amortized_s``,
  CUDA events around a stream of enqueued calls.
"""
from __future__ import annotations

import dataclasses
import os
import subprocess
import time
from typing import Callable, List, Optional

import torch

H100_BF16_FLOPS = 989e12
H100_TF32_FLOPS = 495e12
H100_F32_FLOPS = 67e12
H100_HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": H100_BF16_FLOPS, "float32": H100_F32_FLOPS}


def count_flops(fn: Callable, *args, **kwargs) -> int:
    """FLOPs of ``fn(*args, **kwargs)`` (matrix products and
    convolutions, forward and backward; see the module docstring). The
    call runs once."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        fn(*args, **kwargs)
    return int(counter.get_total_flops())


def tensor_bytes(*items) -> int:
    """Bytes of every tensor in ``items``: tensors, or dicts, lists and
    tuples of them, or dataclasses (an optimizer state) holding them."""
    total = 0
    stack: List = list(items)
    while stack:
        x = stack.pop()
        if isinstance(x, torch.Tensor):
            total += x.numel() * x.element_size()
        elif isinstance(x, dict):
            stack.extend(x.values())
        elif isinstance(x, (list, tuple)):
            stack.extend(x)
        elif dataclasses.is_dataclass(x) and not isinstance(x, type):
            stack.extend(getattr(x, f.name) for f in dataclasses.fields(x))
    return total


def module_bytes(module: torch.nn.Module) -> int:
    """Bytes of a module's parameters and buffers (BatchNorm statistics)."""
    return tensor_bytes(list(module.parameters()), list(module.buffers()))


@dataclasses.dataclass
class Floor:
    """The least time of ``flops`` at ``peak_flops`` and of ``nbytes`` at
    the HBM rate; the larger binds."""

    flops: float
    nbytes: float
    peak_flops: float
    hbm_bytes_per_s: float = H100_HBM_BYTES_PER_S

    @property
    def compute_s(self) -> float:
        return self.flops / self.peak_flops

    @property
    def bandwidth_s(self) -> float:
        return self.nbytes / self.hbm_bytes_per_s

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.bandwidth_s)

    @property
    def bound_by(self) -> str:
        return "bytes" if self.bandwidth_s >= self.compute_s else "operations"

    def share(self, seconds: float) -> float:
        """The binding floor over a measured time: 1.0 is the card's peak.
        Never clamped: a share above 1 means a wrong count."""
        return self.bound_s / seconds


def smi_line(index: int = 0) -> Optional[str]:
    """nvidia-smi's ``name, power.limit`` line of card ``index`` (None
    without nvidia-smi); reading it makes no CUDA context."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        return None
    return out[index] if index < len(out) else out[0]


def card(device: torch.device) -> dict:
    """``device_name``, ``power_limit_w`` and ``card`` (nvidia-smi's
    ``name, power.limit`` line) of a CUDA device; on the CPU the name is
    ``cpu`` and the power limit None."""
    if device.type != "cuda":
        return {"device_name": "cpu", "power_limit_w": None,
                "card": f"cpu, {os.cpu_count()} cores"}
    name = torch.cuda.get_device_name(device)
    line = smi_line(device.index or 0)
    if line is None:
        return {"device_name": name, "power_limit_w": None,
                "card": f"{name}, power limit not read (no nvidia-smi)"}
    try:
        limit: Optional[float] = float(line.rsplit(",", 1)[-1].split()[0])
    except (ValueError, IndexError):
        limit = None
    return {"device_name": name, "power_limit_w": limit, "card": line}


def synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def sync_times(fn: Callable, n: int, device: torch.device) -> List[float]:
    """Seconds of ``n`` calls, each one submitted and waited for (host
    clock around the call and a synchronize)."""
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        synchronize(device)
        times.append(time.perf_counter() - t0)
    return times


def amortized_s(fn: Callable, n: int, device: torch.device) -> float:
    """Seconds a call of ``n`` enqueued back to back: CUDA events around
    the stream of calls on the card, the host clock on the CPU."""
    synchronize(device)
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        return (time.perf_counter() - t0) / n
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1e3 / n

