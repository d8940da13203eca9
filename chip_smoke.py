#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU: serve and score
a full-width OASIS ae_combined volume, and hold every hand-written
kernel against its plain PyTorch version.

    python3 chip_smoke.py                        # one card, no arguments
    python3 chip_smoke.py --profile out/prof.txt # + trace one serve+score

Phases (any failure ends the run with a non-zero exit):
  1. device: the card's name and power limit (nvidia-smi);
  2. kernels: build ``csrc/ssim.cu``; check its branch-free division by
     the window against IEEE division for every float32 input; hold the
     SSIM kernel against the plain ``ops.metrics.ssim_volume`` for win
     3/5/7/11 on the shapes of ``KERNEL_SHAPES`` and on a pair of
     phantom volumes (flat patches, all-zero end slices);
  3. serve: the bench config (width 64, latent_width 16, depth 32,
     latent 128, BN, sigmoid, bfloat16 compute) with seeded random
     weights; 30 kept slices of a seeded 175 x 220 x 220 phantom at
     ds=6 → 175 slices, linear and lanczos3; a batch of 4 volumes against
     4 single calls; bf16 against f32; card against CPU on a small crop;
  4. score: ``compute_volume_metrics`` on the card (SSIM through the
     CUDA kernel), against the same call on the CPU;
  5. timings from CUDA events after warm-up, beside the card's name and
     power limit; the kernel both back to back (``ms``, inputs partly in
     the 50 MB L2) and with a 256 MB scratch write before each launch
     (``ms_cold``).
The main path (serve linear → score) runs with every kernel launch count
set to 0 just before it and read just after. The line before the last
lists every kernel with its check, launches and times; the last line is
the device summary.
"""
import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

HW, LR_SLICES, DS = 220, 30, 6
HR_SLICES = (LR_SLICES - 1) * DS + 1          # 175
BENCH_CFG = dict(width=64, latent_width=16, depth=32, latent=128, colors=1,
                 use_batchnorm=True, use_sigmoid=True)
KERNEL_SHAPES = ((HR_SLICES, HW, HW), (8, 256, 256), (5, 129, 97),
                 (3, 64, 1500))            # + the phantom pair, (S, 220, 220)
KERNEL_ATOL = 1e-5
HBM_BYTES_PER_S = 3.35e12     # H100 SXM HBM3 (NVIDIA data sheet)
F32_FLOPS_PER_S = 67e12       # H100 SXM float32 outside the tensor cores
L2_FLUSH_BYTES = 256 << 20    # > 5x the H100's 50 MB L2


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def phantom(seed: int, s: int = HR_SLICES, h: int = HW,
            w: int = HW) -> np.ndarray:
    """A seeded [s, h, w] head-like phantom in [0, 1]: a bright shell,
    nested ellipsoids of tissue-like intensities and a smooth texture."""
    rng = np.random.RandomState(seed)
    z = np.linspace(-1, 1, s, dtype=np.float32)[:, None, None]
    y = np.linspace(-1, 1, h, dtype=np.float32)[None, :, None]
    x = np.linspace(-1, 1, w, dtype=np.float32)[None, None, :]
    vol = np.zeros((s, h, w), np.float32)

    def ellipsoid(c, r):
        return (((z - c[0]) / r[0]) ** 2 + ((y - c[1]) / r[1]) ** 2
                + ((x - c[2]) / r[2]) ** 2) < 1.0

    vol[ellipsoid((0, 0, 0), (0.95, 0.9, 0.75))] = 0.9
    vol[ellipsoid((0, 0, 0), (0.88, 0.82, 0.68))] = 0.35
    for _ in range(12):
        c = rng.uniform(-0.45, 0.45, 3)
        r = rng.uniform(0.08, 0.35, 3)
        vol[ellipsoid(c, r)] = rng.uniform(0.2, 0.8)
    inside = ellipsoid((0, 0, 0), (0.95, 0.9, 0.75))
    for _ in range(3):
        f = rng.uniform(2, 9, 3)
        ph = rng.uniform(0, 2 * np.pi)
        vol += inside * 0.04 * np.sin(f[0] * z + f[1] * y + f[2] * x + ph)
    return np.clip(vol, 0.0, 1.0).astype(np.float32)


def smooth_pair(shape, gen, dev):
    """A smooth [S, H, W] image in [0, 1] on the device and a noisy copy."""
    import torch
    import torch.nn.functional as F

    a = torch.rand(shape, generator=gen, device=dev)
    for _ in range(3):
        a = F.avg_pool2d(a[:, None], 5, stride=1, padding=2,
                         count_include_pad=False)[:, 0]
    lo = a.amin(dim=(1, 2), keepdim=True)
    hi = a.amax(dim=(1, 2), keepdim=True)
    a = (a - lo) / (hi - lo)
    b = (a + 0.05 * torch.rand(shape, generator=gen, device=dev)).clamp(0, 1)
    return a.contiguous(), b.contiguous()


def cuda_ms(fn, iters: int) -> float:
    """Mean milliseconds per call from CUDA events, after one warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def call_times_s(fn, iters: int) -> list:
    """Per-call seconds (CUDA events around a call that ends in a host
    readback), after one warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / 1e3)
    return times


def cold_ms(fn, iters: int) -> float:
    """Median milliseconds of one call from CUDA events, with a
    ``L2_FLUSH_BYTES`` scratch write before each, so the call finds its
    inputs in device memory and not in L2."""
    import torch

    scratch = torch.empty(L2_FLUSH_BYTES // 4, device="cuda")
    fn()
    times = []
    for i in range(iters):
        scratch.fill_(float(i))
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def ssim_bound(shape, win: int) -> tuple:
    """(bound_ms, bound_by) for per-slice SSIM: inputs read once and the
    [S] output written once over HBM bandwidth, against the float32
    operations of a separable box filter (5 moments x 2 passes x win
    adds, 3 products, ~30 for the map value and its mean per pixel)."""
    s, h, w = shape
    bytes_moved = 2 * s * h * w * 4 + s * 4
    ops = s * (h - win + 1) * (w - win + 1) * (5 * 2 * win + 3 + 30)
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_kernels(dev) -> dict:
    """Phase 2: build the SSIM kernel, check its division by the window
    exhaustively, and hold the kernel against the plain version on the
    card; returns the largest error seen."""
    import torch

    from superresolution_aniso_mri_tpu_torch.ops import _build, cuda_kernels
    from superresolution_aniso_mri_tpu_torch.ops.metrics import ssim_volume

    t0 = time.perf_counter()
    cuda_kernels._ssim_library()
    log(f"build: ssim.cu in {time.perf_counter() - t0:.2f} s")
    for line in _build.build_log("ssim", cuda_kernels._SSIM_FLAGS).splitlines():
        if "ptxas" in line or "nvcc" in line or "spill" in line:
            log(f"  {line.strip()}")
    for win in cuda_kernels.SSIM_WINDOWS:
        bad = cuda_kernels.window_division_mismatches(win, dev)
        log(f"kernel division by {win}: mismatches against IEEE over all "
            f"finite float32 inputs: {bad[0]}")
        if bad[0]:
            raise AssertionError(f"division by {win} differs from IEEE "
                                 f"division, first at bits {bad[1]:#010x}")
    gen = torch.Generator(device=dev).manual_seed(0)
    cases = [(shape, smooth_pair(shape, gen, dev)) for shape in KERNEL_SHAPES]
    cases.append(("phantom", tuple(torch.from_numpy(phantom(i)).to(dev)
                                   for i in (0, 1))))
    worst = 0.0
    for shape, (a, b) in cases:
        for win in cuda_kernels.SSIM_WINDOWS:
            got = cuda_kernels.ssim_volume_cuda(a, b, 1.0, win)
            want = ssim_volume(a, b, 1.0, win)
            again = cuda_kernels.ssim_volume_cuda(a, b, 1.0, win)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            worst = max(worst, err)
            log(f"kernel ssim_slice {shape} win={win}: max_abs_err={err:.3e}"
                f" mean={float(got.mean()):.6f}")
            if not err <= KERNEL_ATOL:
                raise AssertionError(
                    f"SSIM kernel disagrees with the plain version at "
                    f"{shape} win={win}: {err:.3e} > {KERNEL_ATOL}")
            if not torch.equal(got, again):
                raise AssertionError(f"SSIM kernel is not deterministic at "
                                     f"{shape} win={win}")
    return {"max_abs_err": worst}


def check_volume(vol: np.ndarray, what: str) -> None:
    if vol.shape != (HR_SLICES, HW, HW):
        raise AssertionError(f"{what}: shape {vol.shape}, expected "
                             f"{(HR_SLICES, HW, HW)}")
    if not np.isfinite(vol).all():
        raise AssertionError(f"{what}: non-finite values")
    if vol.min() < 0.0 or vol.max() > 1.0:
        raise AssertionError(f"{what}: values outside [0, 1]: "
                             f"[{vol.min()}, {vol.max()}]")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", metavar="PATH",
                    help="trace one serve+score call with torch.profiler "
                         "and write its kernel table to PATH")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device — this script runs the port on "
              "the GPU only", file=sys.stderr)
        return 1
    from superresolution_aniso_mri_tpu_torch.evaluate import (
        compute_volume_metrics)
    from superresolution_aniso_mri_tpu_torch.infer import (
        ServingModel, create_super_volume, create_super_volumes)
    from superresolution_aniso_mri_tpu_torch.models import AEConfig
    from superresolution_aniso_mri_tpu_torch.ops import cuda_kernels
    from superresolution_aniso_mri_tpu_torch.ops.metrics import ssim_volume

    t_start = time.perf_counter()
    dev = torch.device("cuda")
    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python "
        f"{sys.version.split()[0]} device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()}")

    # ---- 2. kernels --------------------------------------------------
    kcheck = check_kernels(dev)

    # ---- 3. serve ----------------------------------------------------
    alphas = np.linspace(0, 1, DS + 1)[1:-1]
    serve_kw = dict(alpha_range=alphas, downsample_steps=DS,
                    use_original=False, generate_inbetween_slices=True)
    cfg = AEConfig(**BENCH_CFG, compute_dtype="bfloat16")
    model = ServingModel(cfg, device=dev,
                         generator=torch.Generator().manual_seed(args.seed))
    hr = phantom(args.seed)
    log(f"phantom: {hr.shape}, kept slices {hr[::DS].shape[0]}")

    # the main path, counted: serve (linear) → score
    cuda_kernels.reset_launch_counts()
    res = create_super_volume(model, hr, **serve_kw)
    metrics = compute_volume_metrics(hr, res["upsampled_image"],
                                     downsample_steps=DS)
    launches = dict(cuda_kernels.LAUNCHES)
    log(f"main path launches: {json.dumps(launches)}")
    check_volume(res["upsampled_image"], "serve linear")
    for name, count in launches.items():
        if count < 1:
            raise AssertionError(f"kernel {name} was not launched on the "
                                 f"main path")

    res_l3 = create_super_volume(model, hr, latent_interp="lanczos3",
                                 **serve_kw)
    check_volume(res_l3["upsampled_image"], "serve lanczos3")
    log(f"serve: linear and lanczos3 → {res['upsampled_image'].shape}, "
        f"finite, in [0, 1]")

    vols = [phantom(args.seed + 1 + i) for i in range(4)]
    batched = create_super_volumes(model, vols, **serve_kw)
    batch_err = 0.0
    for vol, got in zip(vols, batched):
        single = create_super_volume(model, vol, **serve_kw)
        check_volume(got["upsampled_image"], "serve batched")
        batch_err = max(batch_err, float(np.abs(
            got["upsampled_image"] - single["upsampled_image"]).max()))
    log(f"serve: batch of 4 vs 4 single calls: max_abs_diff={batch_err:.3e}")
    # bf16 convs may pick other cuDNN algorithms at another batch size
    if not batch_err <= 1.0 / 64:
        raise AssertionError(f"batched serving differs from single calls "
                             f"by {batch_err}")

    state = model._ae_model().state_dict()
    cfg32 = AEConfig(**BENCH_CFG, compute_dtype="float32")
    model32 = ServingModel(cfg32, state, device=dev)
    res32 = create_super_volume(model32, hr, **serve_kw)
    check_volume(res32["upsampled_image"], "serve f32")
    v16 = torch.from_numpy(res["upsampled_image"]).to(dev)
    v32 = torch.from_numpy(res32["upsampled_image"]).to(dev)
    bf16_delta = 1.0 - float(cuda_kernels.ssim_volume_fused(v16, v32).mean())
    log(f"serve: bf16_ssim_delta (1 - SSIM(bf16, f32)) = {bf16_delta:.6f}")

    # card against CPU on a small crop, float32 (TF32 off on both)
    crop = hr[:37, 60:124, 70:134].copy()
    small = dict(serve_kw, latent_interp="lanczos3")
    got = create_super_volume(model32, crop, **small)["upsampled_image"]
    cpu_model = ServingModel(cfg32, state, device="cpu")
    want = create_super_volume(cpu_model, crop, **small)["upsampled_image"]
    card_cpu_err = float(np.abs(got - want).max())
    log(f"serve: card vs CPU, f32 {crop.shape} → {got.shape}: "
        f"max_abs_diff={card_cpu_err:.3e}")
    if not card_cpu_err <= 1e-4:
        raise AssertionError(f"card and CPU serving differ: {card_cpu_err}")

    # ---- 4. score ----------------------------------------------------
    for key, val in metrics.items():
        if not np.isfinite(val):
            raise AssertionError(f"metric {key} is not finite: {val}")
    log("metrics: " + json.dumps(dict(metrics, ssim_kernel_path="cuda")))
    cpu_metrics = compute_volume_metrics(hr, res["upsampled_image"],
                                         downsample_steps=DS, device="cpu")
    metric_err = max(abs(metrics[k] - cpu_metrics[k])
                     / max(1.0, abs(cpu_metrics[k])) for k in metrics)
    log(f"metrics: card vs CPU max rel diff {metric_err:.3e}")
    if not metric_err <= 1e-4:
        raise AssertionError(f"card and CPU scores differ: {metric_err}")
    ref_v = v16[:8].contiguous()
    self_ssim = float(cuda_kernels.ssim_volume_fused(ref_v, ref_v).mean())
    log(f"ssim_selfcheck: {self_ssim:.6f}")
    if abs(self_ssim - 1.0) >= 1e-3:
        raise AssertionError(f"SSIM self-check failed: {self_ssim}")

    # ---- 5. timings --------------------------------------------------
    timings = {}
    for name, kw in (("linear", {}), ("lanczos3", {"latent_interp": "lanczos3"})):
        ts = call_times_s(lambda: create_super_volume(model, hr, **serve_kw,
                                                       **kw), 7)
        timings[f"serve_{name}_s_per_volume"] = float(np.median(ts))
        timings[f"serve_{name}_s_min"] = float(np.min(ts))
    tb = call_times_s(lambda: create_super_volumes(model, vols, **serve_kw), 3)
    timings["serve_batched4_s_per_volume"] = float(np.median(tb)) / 4
    ts = call_times_s(lambda: compute_volume_metrics(
        hr, res["upsampled_image"], downsample_steps=DS), 5)
    timings["score_s_per_volume"] = float(np.median(ts))

    a = torch.from_numpy(hr).to(dev)
    b = torch.from_numpy(res["upsampled_image"]).to(dev)
    kernel_ms = cuda_ms(lambda: cuda_kernels.ssim_volume_cuda(a, b, 1.0, 7), 50)
    kernel_cold_ms = cold_ms(
        lambda: cuda_kernels.ssim_volume_cuda(a, b, 1.0, 7), 30)
    plain_ms = cuda_ms(lambda: ssim_volume(a, b, 1.0, 7), 20)
    bound_ms, bound_by = ssim_bound(tuple(a.shape), 7)
    timings.update(ssim_kernel_us=kernel_ms * 1e3,
                   ssim_kernel_cold_us=kernel_cold_ms * 1e3,
                   ssim_plain_us=plain_ms * 1e3, ssim_bound_us=bound_ms * 1e3,
                   ssim_bound_share=bound_ms / kernel_ms,
                   ssim_bound_share_cold=bound_ms / kernel_cold_ms)
    log(f"timings [{card}]: " + json.dumps(timings))

    if args.profile:
        profile_main_path(model, hr, serve_kw,
                          timings["serve_linear_s_per_volume"]
                          + timings["score_s_per_volume"], args.profile)

    log(f"total: {time.perf_counter() - t_start:.1f} s")
    log(card)  # name and power limit, as nvidia-smi prints them
    print(json.dumps({"kernels": [{
        "name": "ssim_slice", "route": "cuda",
        "source": "superresolution_aniso_mri_tpu_torch/csrc/ssim.cu",
        "replaces": "superresolution_aniso_mri_tpu/ops/pallas_kernels.py:43",
        "launches": launches["ssim_slice"],
        "max_abs_err": kcheck["max_abs_err"], "ok": True,
        "ms": kernel_ms, "ms_cold": kernel_cold_ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
        "bound_share": bound_ms / kernel_ms,
        "bound_share_cold": bound_ms / kernel_cold_ms,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def profile_main_path(model, hr, serve_kw, wall_s: float, path: str) -> None:
    """Trace one serve + score call (warm: the timings ran before); write
    the table to ``path`` and print device time by kind against
    ``wall_s``, the untraced serve + score time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from superresolution_aniso_mri_tpu_torch.evaluate import (
        compute_volume_metrics)
    from superresolution_aniso_mri_tpu_torch.infer import create_super_volume

    def step():
        out = create_super_volume(model, hr, **serve_kw)
        compute_volume_metrics(hr, out["upsampled_image"],
                               downsample_steps=DS)
        torch.cuda.synchronize()

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step()
    events = prof.key_averages()
    attr = ("self_device_time_total"
            if hasattr(events[0], "self_device_time_total")
            else "self_cuda_time_total")
    device = [e for e in events
              if e.device_type == torch.autograd.DeviceType.CUDA]
    copy_us = sum(getattr(e, attr) for e in device
                  if e.key.startswith("Memcpy"))
    kernel_us = sum(getattr(e, attr) for e in device) - copy_us
    table = events.table(sort_by=attr, row_limit=40)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        f.write(table)
    kernel_ms, copy_ms = kernel_us / 1e3, copy_us / 1e3
    log(f"profile: per serve+score {kernel_ms:.2f} ms in kernels, "
        f"{copy_ms:.2f} ms in copies, untraced wall {wall_s * 1e3:.2f} ms, "
        f"device idle share {1 - (kernel_ms + copy_ms) / (wall_s * 1e3):.3f}")
    for line in table.splitlines()[:25]:
        log(f"  {line[:160]}")


if __name__ == "__main__":
    sys.exit(main())
