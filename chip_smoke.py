#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU: serve and score
a full-width OASIS ae_combined volume, and hold every hand-written
kernel against its plain PyTorch version.

    python3 chip_smoke.py                        # one card, no arguments
    python3 chip_smoke.py --profile out/prof.txt # + trace one serve+score
                                                 # and one train step

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
  5. train: the README's OASIS recipe at full width (float32,
     ae_combined, MSE mix loss, ex_loss_weight1 0.001, lr 1e-5, 16 pairs
     of 64² patches from four seeded phantoms through TripletSampler,
     the deterministic augment_batch and prepare_batch_pairs, ds=4):
     30 steps on one batch must lower loss_ae; 5 steps of a small config
     on the card against the CPU; a 2-epoch Trainer run writes the
     experiment files; its caisr.models is served (ds=6) and scored on
     the card; train ms/step, steps/s and peak memory;
  6. timings from CUDA events after warm-up, beside the card's name and
     power limit; the kernel both back to back (``ms``, inputs partly in
     the 50 MB L2) and with a 256 MB scratch write before each launch
     (``ms_cold``).
The main path (serve linear → score) runs with every kernel launch count
set to 0 just before it and read just after; so does the train phase's
path (serve the trained checkpoint → score). The line before the last
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
# train phase: the README's OASIS recipe (train_brain_aesr.py) at full width
TRAIN_ARGS = dict(model="ae_combined", dataset="OASIS", **BENCH_CFG,
                  compute_dtype="float32", image_mix_loss_func="mse",
                  ex_loss_weight1=0.001, lr=1e-5, batch_size=16,
                  downsample_steps=4, slice_selection="adjacent_plus")
TRAIN_PATCH, TRAIN_DS, TRAIN_LEARN_STEPS = 64, 4, 30
SMALL_CFG = dict(width=32, latent_width=8, depth=4, latent=6, colors=1,
                 use_batchnorm=True, use_sigmoid=True)


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


def train_data(seed: int, patch: int, pairs: int, batches: int,
               device) -> list:
    """``batches`` train batches of ``pairs`` pairs from four seeded
    phantoms: TripletSampler(pad 220) → the deterministic augment_batch
    (center crop 220, then ``patch``) → prepare_batch_pairs, on
    ``device``. Returns (raw numpy batches, device batches, aug config)."""
    from superresolution_aniso_mri_tpu_torch.data import (
        AugmentConfig, TripletSampler, Volume, device_batch)

    vols = [Volume(image=phantom(seed + 100 + i),
                   spacing=np.array([1.0, 1.0, 1.0])) for i in range(4)]
    sampler = TripletSampler(vols, TRAIN_DS, "adjacent_plus", pad_size=HW,
                             seed=seed)
    aug = AugmentConfig(patch_size=patch, aug_patch_size=HW,
                        random_crop=False, rot90=False, intensity=False)
    raw = [sampler.sample_batch(pairs) for _ in range(batches)]
    return raw, [device_batch(r, aug, device) for r in raw], aug


def _finite(metrics: dict, what: str) -> None:
    vals = {k: np.asarray(v) for k, v in metrics.items()}
    bad = [k for k, v in vals.items() if not np.isfinite(v).all()]
    if bad:
        raise AssertionError(f"{what}: non-finite metrics {bad}")


def check_train(dev, seed: int, hr: np.ndarray, serve_kw: dict, card: str,
                profile_path) -> dict:
    """Phase 5 (see the module docstring); returns the train path's SSIM
    launches and the train timings."""
    import tempfile

    import torch

    from superresolution_aniso_mri_tpu_torch.evaluate import (
        compute_volume_metrics)
    from superresolution_aniso_mri_tpu_torch.infer import (
        ServingModel, create_super_volume)
    from superresolution_aniso_mri_tpu_torch.models import (
        AEConfig, VanillaACAI, flax_to_torch)
    from superresolution_aniso_mri_tpu_torch.ops import cuda_kernels
    from superresolution_aniso_mri_tpu_torch.train import (
        Trainer, create_train_state, load_checkpoint_raw,
        loss_config_from_args, make_train_step)
    from superresolution_aniso_mri_tpu_torch.data import device_batch

    t0 = time.perf_counter()
    pairs = TRAIN_ARGS["batch_size"]
    raw, batches, aug = train_data(seed, TRAIN_PATCH, pairs, 3, dev)
    b = batches[0]
    log(f"train: data {time.perf_counter() - t0:.1f} s; image "
        f"{list(b['image'].shape)}, slice_between "
        f"{list(b['slice_between'].shape)}")
    cfg = AEConfig(**BENCH_CFG, compute_dtype="float32")
    loss_cfg = loss_config_from_args(TRAIN_ARGS)
    step = make_train_step(loss_cfg)
    mix = TRAIN_ARGS["ex_loss_weight1"]

    def fresh_state(config, device, gen_seed):
        model = VanillaACAI(config)
        model.reset_parameters(torch.Generator().manual_seed(gen_seed))
        return create_train_state(model.to(device), TRAIN_ARGS["lr"])

    # it learns: 30 steps on one repeated batch
    state = fresh_state(cfg, dev, seed)
    seen = []
    for _ in range(TRAIN_LEARN_STEPS):
        state, m = step(state, b, mix)
        seen.append(m)
    stacked = {k: torch.stack([m[k] for m in seen]).cpu().numpy()
               for k in seen[0]}
    _finite(stacked, "train")
    first, last = float(stacked["loss_ae"][0]), float(stacked["loss_ae"][-1])
    log(f"train: {TRAIN_LEARN_STEPS} steps on one batch, loss_ae "
        f"{first:.6f} → {last:.6f}, metrics {sorted(stacked)}")
    if not last < first:
        raise AssertionError(f"training did not lower loss_ae: {first} → "
                             f"{last}")

    # card against CPU: 5 steps of a small config from the same weights
    small = AEConfig(**SMALL_CFG)
    _, small_batches, _ = train_data(seed + 1, SMALL_CFG["width"], 4, 5, dev)
    card_state = fresh_state(small, dev, seed + 1)
    cpu_state = fresh_state(small, "cpu", seed + 1)
    worst_loss = 0.0
    for sb in small_batches:
        card_state, cm = step(card_state, sb, mix)
        cpu_state, hm = step(cpu_state, {k: v.cpu() for k, v in sb.items()},
                             mix)
        for k in hm:
            rel = abs(float(cm[k]) - float(hm[k])) / max(abs(float(hm[k])),
                                                         1e-12)
            worst_loss = max(worst_loss, rel)
    drift = max(float((p.detach().cpu() - q.detach()).abs().max())
                for p, q in zip(card_state.model.parameters(),
                                cpu_state.model.parameters()))
    bound = 2 * TRAIN_ARGS["lr"] * len(small_batches)
    log(f"train: card vs CPU, {len(small_batches)} steps of {SMALL_CFG}: "
        f"max rel loss diff {worst_loss:.3e} (limit 1e-4), max param diff "
        f"{drift:.3e} (limit 2·lr·steps = {bound:.1e})")
    if not worst_loss <= 1e-4 or not drift <= bound:
        raise AssertionError("card and CPU training differ")

    # a 2-epoch Trainer run into an experiment directory
    with tempfile.TemporaryDirectory() as out:
        trainer = Trainer(dict(TRAIN_ARGS, epochs=2, epoch_threshold=0,
                               output_dir=out, seed=seed), device=dev)
        trainer.prepare_run()
        for _ in range(2):
            for tb in batches[:2]:
                trainer.train(tb)
            trainer.validate(batches[2])
            trainer.show_loss_on_tensorboard("train")
            trainer.show_loss_on_tensorboard("test")
            trainer.reset_losses()
            trainer.end_epoch_processing()
        models = sorted(os.listdir(os.path.join(out, "models")))
        files = sorted(f for f in os.listdir(out) if f.endswith(".npz"))
        log(f"train: Trainer wrote models/{models} and {files}")
        want = ["1.models", "ae.models", "caisr.models", "last.models"]
        if models != want or files != ["loss_iters.npz", "losses_test.npz",
                                       "losses_train.npz"]:
            raise AssertionError(f"Trainer files: {models} {files}")
        again = Trainer(dict(TRAIN_ARGS, output_dir=out), device=dev,
                        seed=seed + 7)
        again.load(os.path.join(out, "models", "last.models"))
        same = all(torch.equal(again.model.state_dict()[k], v)
                   for k, v in trainer.model.state_dict().items())
        log(f"train: last.models reloads to the same tensors: {same}; "
            f"epoch {again.epoch}")
        if not same or again.epoch != 2:
            raise AssertionError("last.models does not reload")
        raw_ckpt = load_checkpoint_raw(os.path.join(out, "models",
                                                    "caisr.models"))

    # the trained checkpoint through the port's serve → score path
    served = ServingModel(cfg, flax_to_torch(raw_ckpt["model_dict_ae"],
                                             raw_ckpt["batch_stats"], cfg),
                          device=dev)
    cuda_kernels.reset_launch_counts()
    res = create_super_volume(served, hr, **serve_kw)
    scores = compute_volume_metrics(hr, res["upsampled_image"],
                                    downsample_steps=DS, device=dev)
    launches = dict(cuda_kernels.LAUNCHES)
    check_volume(res["upsampled_image"], "serve trained checkpoint")
    _finite(scores, "scores of the trained checkpoint")
    log(f"train → serve → score launches: {json.dumps(launches)}; scores "
        + json.dumps({k: round(v, 6) for k, v in scores.items()}))
    if launches["ssim_slice"] < 1:
        raise AssertionError("the SSIM kernel was not launched on the "
                             "train → serve → score path")

    # timings: upload + augment + split + step, CUDA events
    timed = fresh_state(cfg, dev, seed)

    def one_step():
        step(timed, device_batch(raw[0], aug, dev), mix)

    for _ in range(3):
        one_step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times, host = [], []
    for _ in range(20):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        t_host = time.perf_counter()
        one_step()
        host.append((time.perf_counter() - t_host) * 1e3)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    ms = float(np.median(times))
    # host_ms: the host's time to issue one step (its upload waits for
    # the copy); near ms, the host sets the pace, not the card
    out = {"train_ms_per_step": ms, "train_ms_min": float(np.min(times)),
           "train_host_ms_per_step": float(np.median(host)),
           "train_steps_per_s": 1e3 / ms,
           "train_peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
           "train_pairs_per_step": pairs, "launches": launches}
    log(f"train timings [{card}]: " + json.dumps(
        {k: v for k, v in out.items() if k != "launches"}))
    if profile_path:
        profile_train_step(one_step, ms, profile_path)
    return out


def _kernel_kind(name: str) -> str:
    """Bucket of a device event by its kernel name."""
    low = name.lower()
    if low.startswith(("memcpy", "memset")):
        return "copies"
    if "multi_tensor_apply" in low:
        return "optimizer"
    if "reduce_kernel" in low:
        return "reductions"
    if "pool" in low or "upsample" in low:
        return "pool_upsample"
    if "elementwise" in low or "cat" in low:
        return "elementwise"
    if any(t in low for t in ("xmma", "gemm", "fft", "dse::", "grad",
                              "conv", "cudnn", "nchw", "nhwc", "region_",
                              "complex")):
        return "convolutions"
    return "other"


def profile_train_step(one_step, wall_ms: float, path: str) -> None:
    """Trace one warm train step (upload included); print kernel time by
    kind, the convolutions split into forward and backward by their aten
    op, the device-side span of the BatchNorm forward calls (a range
    around each call: its kernels, which also sit in their kinds, and
    the gaps between them), and the device idle share against
    ``wall_ms``, the untraced median step. The table goes to
    ``path + ".train.txt"``."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from superresolution_aniso_mri_tpu_torch.models import acai

    forward = acai.BatchNorm.forward

    def traced(self, *a, **kw):
        with record_function("BatchNorm.forward"):
            return forward(self, *a, **kw)

    acai.BatchNorm.forward = traced
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            one_step()
            torch.cuda.synchronize()
    finally:
        acai.BatchNorm.forward = forward
    events = prof.key_averages()
    self_attr = ("self_device_time_total"
                 if hasattr(events[0], "self_device_time_total")
                 else "self_cuda_time_total")
    cuda = torch.autograd.DeviceType.CUDA

    def device_ms(match) -> float:
        return sum(getattr(e, self_attr) for e in events if match(e)) / 1e3

    # device rows that are not kernels: the profiler's own buffer, and
    # the device-side span of each BatchNorm range (idle gaps included)
    kernels = [e for e in events if e.device_type == cuda and e.key not in
               ("Activity Buffer Request", "BatchNorm.forward")]
    kinds: dict = {}
    for e in kernels:
        kind = _kernel_kind(e.key)
        kinds[kind] = kinds.get(kind, 0.0) + getattr(e, self_attr) / 1e3
    busy = sum(kinds.values())
    split = {"conv_fwd": device_ms(lambda e: e.key.startswith(
                 "aten::cudnn_convolution")),
             "conv_bwd": device_ms(lambda e: e.key ==
                                   "aten::convolution_backward"),
             "batchnorm_fwd_span": device_ms(
                 lambda e: e.key == "BatchNorm.forward"
                 and e.device_type == cuda)}
    table = events.table(sort_by=self_attr, row_limit=50)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path + ".train.txt", "w") as f:
        f.write(table)
    log("profile train step: device ms by kernel kind " + json.dumps(
        {k: round(v, 4) for k, v in sorted(kinds.items())})
        + "; by op " + json.dumps({k: round(v, 4) for k, v in split.items()})
        + f"; {sum(e.count for e in kernels)} device events, busy "
        f"{busy:.4f} ms of an untraced {wall_ms:.4f} ms step, idle share "
        f"{1 - busy / wall_ms:.3f}")
    for line in table.splitlines()[:30]:
        log(f"  {line[:160]}")


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

    # ---- 5. train -----------------------------------------------------
    train = check_train(dev, args.seed, hr, serve_kw, card, args.profile)

    # ---- 6. timings --------------------------------------------------
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
