"""PyTorch port on the card: the CUDA SSIM kernel against its plain
version, the serving, scoring and training entry points on CUDA against
the same calls on the CPU (the labeled MultiChannelAE path and the
alpha families included), the perceptual tools, the
experiment-directory commands, the quality harness, and the port's
``sr.*`` stage ranges under the profiler. Every test here needs an NVIDIA
GPU and skips without one.

This file imports neither JAX nor the JAX package, so it runs where
only the port's dependencies are installed:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_port_cuda.py
"""
import json
import os

import numpy as np
import pytest
import scipy.ndimage
import torch

from superresolution_aniso_mri_tpu_torch.ops import cuda_kernels
from superresolution_aniso_mri_tpu_torch.ops.metrics import ssim_volume

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's kernels have no CPU "
                    "mode")
    return torch.device("cuda")


def _pair(shape, seed=0):
    rng = np.random.RandomState(seed)
    a = scipy.ndimage.gaussian_filter(rng.rand(*shape), (0, 2, 2))
    a = ((a - a.min()) / (a.max() - a.min())).astype(np.float32)
    b = np.clip(a + 0.05 * rng.rand(*shape), 0, 1).astype(np.float32)
    return a, b


def _flat_pair(shape, seed=0):
    """Large flat patches of shared values (the E[x^2] - mu^2 form at its
    limit), a textured patch, and an all-zero first slice in both."""
    rng = np.random.RandomState(seed)
    s, h, w = shape
    a = np.full(shape, 0.35, np.float32)
    a[:, : h // 3] = 0.9
    a[:, :, : w // 4] = 0.0
    a[:, h // 2:, w // 2:] = rng.rand(s, h - h // 2, w - w // 2) * 0.8
    b = a.copy()
    b[:, h // 2:, w // 2:] += 0.05 * rng.rand(s, h - h // 2, w - w // 2)
    a[0] = 0.0
    b[0] = 0.0
    return a, b.astype(np.float32)


def _extreme_pair(shape, seed=0):
    """Smooth slices, then inputs whose window sums overflow or are not
    finite: 1e25 (x**2 overflows), 3e38, inf, NaN and -0.0 patches."""
    a, b = _pair(shape, seed)
    h, w = shape[1:]
    for i, val in enumerate((1e25, 3e38, np.inf, np.nan, -0.0)):
        if i + 1 < shape[0]:
            a[i + 1, h // 3: h // 3 + 4, w // 2: w // 2 + 3] = val
    b[-1] = -0.0
    return a, b


@pytest.mark.parametrize("shape, data", [
    pytest.param((175, 220, 220), "smooth", id="shape0"),
    pytest.param((8, 256, 256), "smooth", id="shape1"),
    pytest.param((5, 129, 97), "smooth", id="shape2"),   # W % 4 != 0
    pytest.param((175, 220, 220), "flat", id="phantom_flat"),
    pytest.param((3, 64, 1500), "smooth", id="two_strips"),
    pytest.param((4, 37, 64), "flat", id="ragged_band"),
    pytest.param((3, 3, 3), "smooth", id="win3_sized"),
    pytest.param((3, 5, 5), "smooth", id="win5_sized"),
    pytest.param((3, 7, 7), "flat", id="win7_sized"),
    pytest.param((3, 11, 11), "smooth", id="win11_sized"),
    pytest.param((70000, 8, 8), "smooth", id="70000_slices"),
    pytest.param((7, 40, 48), "extreme", id="extreme_values"),
    # chip_smoke.py phase 14: an OASIS volume's 176 reconstructed slices,
    # a MNISTRoto validation volume at the recipe's width
    pytest.param((176, 208, 176), "smooth", id="reconstruction"),
    pytest.param((33, 64, 64), "flat", id="mnistroto"),
])
def test_ssim_kernel_matches_plain_version(cuda, shape, data):
    """atol 1e-5, as chip_smoke.py: the kernel repeats the plain
    version's per-pixel arithmetic; only the order of the mean differs.
    Every window that fits the slice is checked."""
    pair = {"smooth": _pair, "flat": _flat_pair,
            "extreme": _extreme_pair}[data](shape)
    a, b = (torch.from_numpy(x).to(cuda) for x in pair)
    for win in cuda_kernels.SSIM_WINDOWS:
        if win > min(shape[1:]):
            continue
        before = cuda_kernels.LAUNCHES["ssim_slice"]
        got = cuda_kernels.ssim_volume_fused(a, b, 1.0, win)
        torch.cuda.synchronize()
        assert cuda_kernels.LAUNCHES["ssim_slice"] == before + 1
        want = ssim_volume(a, b, 1.0, win)
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                                   atol=1e-5, err_msg=f"win {win}")


@pytest.mark.parametrize("shape", [(3, 40, 64), (2, 33, 97)])
def test_ssim_kernel_takes_rows_off_16_byte_alignment(cuda, shape):
    """A contiguous view that starts one float into its storage: the
    kernel's 4-byte loads assume no alignment of the rows."""
    a, b = _pair(shape, seed=3)
    n = a.size
    ta = torch.empty(n + 1, device=cuda)[1:].view(shape)
    tb = torch.empty(n + 1, device=cuda)[1:].view(shape)
    ta.copy_(torch.from_numpy(a))
    tb.copy_(torch.from_numpy(b))
    assert ta.data_ptr() % 16 != 0 and ta.is_contiguous()
    for win in cuda_kernels.SSIM_WINDOWS:
        got = cuda_kernels.ssim_volume_cuda(ta, tb, 1.0, win)
        want = ssim_volume(ta, tb, 1.0, win)
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                                   atol=1e-5, err_msg=f"win {win}")


def test_ssim_kernel_is_deterministic(cuda):
    """Two calls on the same inputs give the same bits, also after calls
    of other slice counts on the same stream (the tickets start at 0)."""
    a, b = (torch.from_numpy(x).to(cuda) for x in _flat_pair((40, 96, 80)))
    for win in cuda_kernels.SSIM_WINDOWS:
        first = cuda_kernels.ssim_volume_cuda(a, b, 1.0, win)
        cuda_kernels.ssim_volume_cuda(a[:7].contiguous(), b[:7].contiguous(),
                                      1.0, win)
        second = cuda_kernels.ssim_volume_cuda(a, b, 1.0, win)
        assert torch.equal(first, second), f"win {win}"


@pytest.mark.parametrize("win", [3, 5, 7, 11])
def test_kernel_division_by_window_is_ieee_for_every_float32(cuda, win):
    """The kernel divides its window sums by win without nvcc's guarded
    division; every finite float32 input (of all 2**32 bit patterns;
    zeros, subnormals and NaNs included) gives the bits of `-(x / win)`.
    Infinite sums never reach it (the ``extreme_values`` case of
    test_ssim_kernel_matches_plain_version)."""
    assert cuda_kernels.window_division_mismatches(win, cuda) == (0, -1)


def test_ssim_kernel_rejects_unsupported_windows(cuda):
    a, b = (torch.from_numpy(x).to(cuda) for x in _pair((2, 20, 20)))
    with pytest.raises(ValueError, match="win_size"):
        cuda_kernels.ssim_volume_cuda(a, b, 1.0, 9)
    with pytest.raises(TypeError, match="float32"):
        cuda_kernels.ssim_volume_cuda(a.double(), b.double())


def test_serve_and_score_on_card_match_cpu(cuda):
    """f32 serving with TF32 off: card and CPU agree within 1e-4; the
    score goes through the kernel once."""
    from superresolution_aniso_mri_tpu_torch.evaluate import (
        compute_volume_metrics)
    from superresolution_aniso_mri_tpu_torch.infer import (
        ServingModel, create_super_volume)
    from superresolution_aniso_mri_tpu_torch.models import AEConfig

    cfg = AEConfig(width=32, latent_width=8, depth=8, latent=6)
    card = ServingModel(cfg, device=cuda,
                        generator=torch.Generator().manual_seed(0))
    cpu = ServingModel(cfg, card._ae_model().state_dict(), device="cpu")
    img = _pair((19, 40, 44), seed=1)[0]
    kw = dict(downsample_steps=3, alpha_range=[1 / 3, 2 / 3],
              generate_inbetween_slices=True, latent_interp="lanczos3")
    got = create_super_volume(card, img, **kw)["upsampled_image"]
    want = create_super_volume(cpu, img, **kw)["upsampled_image"]
    np.testing.assert_allclose(got, want, atol=1e-4)
    before = cuda_kernels.LAUNCHES["ssim_slice"]
    on_card = compute_volume_metrics(img, got, downsample_steps=3)
    assert cuda_kernels.LAUNCHES["ssim_slice"] == before + 1
    on_cpu = compute_volume_metrics(img, got, downsample_steps=3,
                                    device="cpu")
    for key in on_cpu:
        np.testing.assert_allclose(on_card[key], on_cpu[key], rtol=1e-5,
                                   atol=1e-6, err_msg=key)


def test_train_steps_on_card_match_cpu(cuda):
    """3 float32 train steps (TF32 off) of a small ae_combined config with
    lanczos3 latent mixing and the lap loss, from the same weights and
    batches: every metric within rel 1e-4, parameters within 2·lr·steps
    (cuDNN's backward passes are not deterministic, so no bitwise
    check), BatchNorm statistics within 1e-4."""
    from superresolution_aniso_mri_tpu_torch.models import (AEConfig,
                                                            VanillaACAI)
    from superresolution_aniso_mri_tpu_torch.train import (
        LossConfig, create_train_state, make_train_step)

    lr, steps = 1e-4, 3
    cfg = AEConfig(width=32, latent_width=8, depth=4, latent=6)
    states = []
    for dev in (cuda, torch.device("cpu")):
        model = VanillaACAI(cfg)
        model.reset_parameters(torch.Generator().manual_seed(0))
        states.append(create_train_state(model.to(dev), lr))
    step = make_train_step(LossConfig(model="ae_combined",
                                      image_mix_loss_func="mse",
                                      use_laploss=True,
                                      train_latent_interp="lanczos3"))
    rng = np.random.RandomState(0)
    for _ in range(steps):
        a_to = rng.uniform(0.1, 0.9, 2).astype(np.float32)
        batch = {k: torch.from_numpy(v) for k, v in (
            ("image", rng.rand(4, 1, 32, 32).astype(np.float32)),
            ("slice_between", rng.rand(2, 1, 32, 32).astype(np.float32)),
            ("outer", rng.rand(4, 1, 32, 32).astype(np.float32)),
            ("outer2", rng.rand(4, 1, 32, 32).astype(np.float32)),
            ("alpha_from", 1 - a_to), ("alpha_to", a_to),
            ("is_inbetween", np.array([1.0, 0.0], np.float32)))}
        _, got = step(states[0], {k: v.to(cuda) for k, v in batch.items()},
                      0.3)
        _, want = step(states[1], batch, 0.3)
        for k in want:
            assert got[k].device.type == "cuda"
            np.testing.assert_allclose(float(got[k]), float(want[k]),
                                       rtol=1e-4, err_msg=k)
    card, cpu = (dict(s.model.state_dict()) for s in states)
    for k, v in cpu.items():
        diff = float((card[k].cpu() - v).abs().max())
        limit = 1e-4 * max(1.0, float(v.abs().max())) if "running" in k \
            else 2 * lr * steps
        assert diff <= limit, (k, diff)


def test_cli_train_generate_find_best_on_card(cuda, tmp_path):
    """The quick-start commands on the card at a tiny size: train-brain
    (MNIST3D, 2 epochs) writes the experiment files; generate-hr-volumes
    on the card matches the same command on the CPU within 1e-4;
    find-best-model scores every checkpoint through the kernel, one
    launch a volume (plain) and one a chunk (--batched), and the two
    sweeps agree within 1e-4."""
    from superresolution_aniso_mri_tpu_torch.cli import entry
    from superresolution_aniso_mri_tpu_torch.utils import (read_image,
                                                           write_image)

    entry.train_brain([
        "-d", "MNIST3D", "--use_synthetic_data", "-m", "ae_combined",
        "--image_mix_loss_func", "mse", "--downsample_steps", "2",
        "--epoch_threshold", "-1", "--width", "32", "--latent_width", "16",
        "--depth", "8", "--latent", "8", "--limited_load", "-b", "8",
        "-e", "2", "-o", str(tmp_path), "-id", "x"])
    exper = str(tmp_path / "x")
    assert sorted(os.listdir(tmp_path / "x" / "models")) == [
        "0.models", "1.models", "ae.models", "caisr.models", "last.models"]
    inputs = tmp_path / "in"
    inputs.mkdir()
    write_image(str(inputs / "v.nii.gz"), _pair((6, 40, 44), seed=2)[0],
                spacing=(3.0, 1.0, 1.0))
    vols = {}
    for dev in (None, "cpu"):
        out = tmp_path / f"out_{dev}"
        entry.generate_hr_volumes(
            ["--exper_dir", exper, "--data_input_dir", str(inputs),
             "--output_dir", str(out), "--num_interpolations", "2"],
            device=dev)
        vols[dev] = read_image(str(out / "v_ni02.nii.gz"))[0]
    assert vols[None].shape == (16, 40, 44)
    np.testing.assert_allclose(vols[None], vols["cpu"], atol=1e-4)
    history = {}
    for batched, launches in ((False, 4), (True, 2)):
        cuda_kernels.reset_launch_counts()
        res = entry.find_best_model(
            ["--exper_dir", exper, "--use_synthetic_data"]
            + (["--batched"] if batched else []))
        assert cuda_kernels.LAUNCHES["ssim_slice"] == launches
        history[batched] = res["history"]
    for k, v in history[False].items():
        np.testing.assert_allclose(history[True][k], v, atol=1e-4,
                                   err_msg=k)


def test_augmentation_and_device_cache_on_card(cuda):
    """apply_augment on the card equals the CPU for the same draws (every
    op but noise, whose field comes from the device's generator) within
    1e-5; batches gathered from the device slice cache equal the host
    sampler's batches uploaded from pinned memory (random recipe, noise
    included)."""
    from superresolution_aniso_mri_tpu_torch.data import (
        AugmentConfig, DeviceCachedSampler, TripletSampler, Volume,
        apply_augment, device_batch, draw_augment_params)

    cfg = AugmentConfig(patch_size=64, aug_patch_size=96, rotate_any=True,
                        max_degree=359, elastic=True, perspective=True,
                        blur=True, mirror=True)
    x = torch.from_numpy(np.stack([_pair((3, 100, 90), seed=s)[0]
                                   for s in range(6)]))
    params = draw_augment_params(torch.Generator().manual_seed(0), cfg,
                                 *x.shape[:1], *x.shape[2:])
    got = apply_augment(x.to(cuda), params, cfg)
    want = apply_augment(x, params, cfg)
    assert got.shape == want.shape == (6, 3, 64, 64)
    assert float((got.cpu() - want).abs().max()) <= 1e-5

    rng = np.random.RandomState(0)
    vols = [Volume(image=rng.rand(11, 72, 80).astype(np.float32),
                   spacing=np.ones(3)) for _ in range(3)]
    recipe = AugmentConfig(patch_size=32, aug_patch_size=80, noise=True)
    batches = []
    for cached in (False, True):
        sampler = TripletSampler(vols, 2, pad_size=80, seed=1)
        if cached:
            sampler = DeviceCachedSampler(sampler, cuda)
        gen = torch.Generator().manual_seed(5)
        batches.append([device_batch(r, recipe, cuda, generator=gen)
                        for r in sampler.epoch_batches(4)])
    assert len(batches[0]) == len(batches[1]) == 8
    for a, b in zip(*batches):
        assert sorted(a) == sorted(b)
        for k in b:
            assert torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("labeled", [False, True])
def test_native_gather_batches_on_card_match_numpy(cuda, monkeypatch,
                                                   labeled):
    """Batches assembled by the native gather give, through
    ``device_batch`` (the same augmentation draws), the same tensors on
    the card as the numpy stack's (``SRL_DISABLE_NATIVE``); with loss
    masks too."""
    from superresolution_aniso_mri_tpu_torch.data import (
        AugmentConfig, TripletSampler, Volume, device_batch, native_loader)

    assert native_loader.available()
    rng = np.random.RandomState(2)
    vols = [Volume(image=rng.rand(11, 72, 80).astype(np.float32),
                   spacing=np.ones(3)) for _ in range(3)]
    if labeled:
        for v in vols:
            v.labels = rng.randint(0, 4, v.image.shape).astype(np.float32)
    recipe = AugmentConfig(patch_size=32, aug_patch_size=80, noise=True,
                           mirror=True)
    batches = []
    for disabled in (False, True):
        if disabled:
            monkeypatch.setenv("SRL_DISABLE_NATIVE", "1")
            assert not native_loader.available()
        sampler = TripletSampler(vols, 2, pad_size=80, seed=1,
                                 use_masks=labeled)
        gen = torch.Generator().manual_seed(5)
        batches.append([device_batch(r, recipe, cuda, generator=gen,
                                     with_mask=labeled)
                        for r in sampler.epoch_batches(4)])
    assert len(batches[0]) == len(batches[1]) == 8
    for a, b in zip(*batches):
        assert sorted(a) == sorted(b)
        for k in b:
            assert a[k].is_cuda and torch.equal(a[k], b[k]), k


def _lpips_weights(device):
    import warnings

    from superresolution_aniso_mri_tpu_torch.ops import get_lpips_params

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return get_lpips_params(device=device)


def test_lpips_on_card_matches_cpu(cuda):
    """VGG LPIPS in float32 (TF32 off) on the card against the CPU
    within 1e-4 relative, and its input gradient within 1e-3 of the
    largest entry (cuDNN and oneDNN sum the 13 convolutions in other
    orders: 1.5e-5 and 2.7e-4 measured on an H100; TF32 would give
    ~1e-3 and more); the bfloat16 stack within 2e-2."""
    from superresolution_aniso_mri_tpu_torch.ops import lpips_distance

    a, b = _pair((4, 64, 72), seed=5)
    got_w, want_w = _lpips_weights(cuda), _lpips_weights("cpu")
    x0, x1 = (torch.from_numpy(v[:, None]) for v in (a, b))
    want = lpips_distance(want_w, x0, x1)
    got = lpips_distance(got_w, x0.to(cuda), x1.to(cuda)).cpu()
    assert float((got - want).abs().max() / want.abs().max()) <= 1e-4
    bf16 = lpips_distance(got_w, x0.to(cuda), x1.to(cuda),
                          compute_dtype="bfloat16").cpu()
    assert float((bf16 - want).abs().max() / want.abs().max()) <= 2e-2
    grads = []
    for w, dev in ((got_w, cuda), (want_w, torch.device("cpu"))):
        x = x0.to(dev).requires_grad_(True)
        lpips_distance(w, x, x1.to(dev)).mean().backward()
        grads.append(x.grad.cpu())
    gap = (grads[0] - grads[1]).abs().max() / grads[1].abs().max()
    assert float(gap) <= 1e-3


def test_perceptual_train_step_on_card_matches_cpu(cuda):
    """One float32 train step with the perceptual synthesis loss (the
    default of ae_combined) from the same weights and batch: every
    metric within rel 1e-4, parameters within 2·lr."""
    from superresolution_aniso_mri_tpu_torch.models import (AEConfig,
                                                            VanillaACAI)
    from superresolution_aniso_mri_tpu_torch.train import (
        LossConfig, create_train_state, make_train_step)

    lr = 1e-5
    cfg = AEConfig(width=32, latent_width=8, depth=4, latent=6)
    loss_cfg = LossConfig(model="ae_combined",
                          image_mix_loss_func="perceptual")
    rng = np.random.RandomState(1)
    a_to = rng.uniform(0.1, 0.9, 2).astype(np.float32)
    batch = {"image": rng.rand(4, 1, 32, 32).astype(np.float32),
             "slice_between": rng.rand(2, 1, 32, 32).astype(np.float32),
             "alpha_from": 1 - a_to, "alpha_to": a_to}
    out = []
    for dev in (cuda, torch.device("cpu")):
        model = VanillaACAI(cfg)
        model.reset_parameters(torch.Generator().manual_seed(0))
        state = create_train_state(model.to(dev), lr)
        step = make_train_step(loss_cfg, _lpips_weights(dev))
        _, metrics = step(state, {k: torch.from_numpy(v).to(dev)
                                  for k, v in batch.items()}, 0.3)
        out.append((state, metrics))
    (card, got), (cpu, want) = out
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-4,
                                   err_msg=k)
    for p, q in zip(card.model.parameters(), cpu.model.parameters()):
        assert float((p.detach().cpu() - q.detach()).abs().max()) <= 2 * lr


def test_create_hr_images_with_lpips_on_card(cuda):
    """create_hr_images(compute_percept_metrics=True) on the card: one
    SSIM launch a volume, the same scores as on the CPU (LPIPS within
    1e-5 relative), and the weights' mode in the result; the linear
    baseline scores the same way without a trainer."""
    from superresolution_aniso_mri_tpu_torch.data import Volume
    from superresolution_aniso_mri_tpu_torch.evaluate import create_hr_images
    from superresolution_aniso_mri_tpu_torch.infer import ServingModel
    from superresolution_aniso_mri_tpu_torch.models import AEConfig

    cfg = AEConfig(width=32, latent_width=8, depth=8, latent=6)
    card = ServingModel(cfg, device=cuda,
                        generator=torch.Generator().manual_seed(0))
    cpu = ServingModel(cfg, card._ae_model().state_dict(), device="cpu")
    vols = [Volume(image=_pair((13, 40, 44), seed=s)[0],
                   spacing=np.array([2.0, 1.0, 1.0]), patient_id=f"p{s}")
            for s in (2, 3)]
    import warnings

    for trainer, method in ((card, "model"), (None, "linear")):
        before = cuda_kernels.LAUNCHES["ssim_slice"]
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            got = create_hr_images(trainer, vols, 2, interpol_method=method,
                                   compute_percept_metrics=True)
            want = create_hr_images(cpu if trainer else None, vols, 2,
                                    interpol_method=method,
                                    compute_percept_metrics=True,
                                    device="cpu")
        assert cuda_kernels.LAUNCHES["ssim_slice"] == before + len(vols)
        assert got["lpips_mode"] == want["lpips_mode"] == \
            "lin_converted_vgg_random"
        for pid, m in want["per_volume"].items():
            for k, v in m.items():
                np.testing.assert_allclose(got["per_volume"][pid][k], v,
                                           rtol=1e-5, atol=1e-4,
                                           err_msg=f"{method} {pid} {k}")


def _clone_state(state):
    """A TrainState of the same values in tensors of its own (the ACAI
    family's optimizer state is one AdamState per group)."""
    import copy
    import dataclasses

    from superresolution_aniso_mri_tpu_torch.train import TrainState

    def clone(st):
        return dataclasses.replace(st, mu={k: v.clone()
                                           for k, v in st.mu.items()},
                                   nu={k: v.clone() for k, v in st.nu.items()})

    opt = state.opt_state
    opt = ({g: clone(st) for g, st in opt.items()} if isinstance(opt, dict)
           else clone(opt))
    return TrainState(copy.deepcopy(state.model), state.tx, opt, state.step)


def _graph_batches(rng, n, taps):
    out = []
    for _ in range(n):
        a_to = rng.uniform(0.1, 0.9, 2).astype(np.float32)
        batch = {"image": rng.rand(4, 1, 32, 32), "slice_between":
                 rng.rand(2, 1, 32, 32), "alpha_from": 1 - a_to,
                 "alpha_to": a_to, "is_inbetween": np.array([1.0, 0.0])}
        if taps == 6:
            batch["outer"] = rng.rand(4, 1, 32, 32)
            batch["outer2"] = rng.rand(4, 1, 32, 32)
        out.append({k: torch.from_numpy(np.asarray(v, np.float32)).cuda()
                    for k, v in batch.items()})
    return out


@pytest.mark.parametrize("loss", ["mse_triplets", "lanczos3_septets",
                                  "perceptual"])
def test_graph_replay_matches_eager_steps(cuda, loss, monkeypatch):
    """``make_multi_train_step`` on the card: its first dispatch takes the
    warm-up steps eagerly and captures; then 4 replays of the captured
    step against 4 eager steps from the same state and batches: metrics
    and parameters within 1e-6 relative (bitwise expected: the same
    kernels in the same order). cuDNN's default backward algorithms may
    sum with atomics, so both run with ``cudnn.deterministic``."""
    from superresolution_aniso_mri_tpu_torch.models import (AEConfig,
                                                            VanillaACAI)
    from superresolution_aniso_mri_tpu_torch.train import (
        LossConfig, create_train_state, make_multi_train_step,
        make_train_step)
    from superresolution_aniso_mri_tpu_torch.train import steps as steps_mod

    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    kw = {"mse_triplets": dict(image_mix_loss_func="mse"),
          "lanczos3_septets": dict(image_mix_loss_func="mse",
                                   use_laploss=True,
                                   train_latent_interp="lanczos3"),
          "perceptual": dict(image_mix_loss_func="perceptual")}[loss]
    lpips = _lpips_weights(cuda) if loss == "perceptual" else None
    cfg = LossConfig(model="ae_combined", **kw)
    model = VanillaACAI(AEConfig(width=32, latent_width=8, depth=4,
                                 latent=6))
    model.reset_parameters(torch.Generator().manual_seed(0))
    state = create_train_state(model.to(cuda), 1e-4, max_grad_norm=1.0)
    rng = np.random.RandomState(2)
    taps = 6 if "lanczos3" in loss else 2
    multi = make_multi_train_step(cfg, lpips, device=cuda)
    replays = []
    replay = steps_mod._CapturedStep.replay
    monkeypatch.setattr(steps_mod._CapturedStep, "replay",
                        lambda self, *a: replays.append(1) or replay(self, *a))
    multi(state, _graph_batches(rng, steps_mod.WARMUP_STEPS + 1, taps), 0.3)
    assert len(replays) == 1
    eager_state = _clone_state(state)
    batches = _graph_batches(rng, 4, taps)
    _, got = multi(state, batches, 0.3)
    assert len(replays) == 5
    eager = make_train_step(cfg, lpips)
    for i, b in enumerate(batches):
        _, want = eager(eager_state, b, 0.3)
        for k, v in want.items():
            assert abs(float(got[k][i]) - float(v)) <= 1e-6 * abs(float(v)), k
    assert state.opt_state.count == eager_state.opt_state.count
    for (k, p), q in zip(state.model.state_dict().items(),
                         eager_state.model.state_dict().values()):
        assert float((p - q).abs().max()) <= 1e-6 * float(q.abs().max()), k


@pytest.mark.parametrize("model", ["acai_combined", "vae_combined"])
def test_family_graph_replay_matches_eager_steps(cuda, model, monkeypatch):
    """The comparison families under ``make_multi_train_step``: each
    step's noise (ACAI's alphas, the VAE's eps) is drawn once by the
    trainer and copied into the captured step's static buffer like the
    batch, so 4 replays equal 4 eager steps from the same state, batches
    and draws (1e-6 relative), both optimizer groups included."""
    from superresolution_aniso_mri_tpu_torch.train import (
        Trainer, make_multi_train_step, make_train_step)
    from superresolution_aniso_mri_tpu_torch.train import steps as steps_mod

    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    tr = Trainer(dict(model=model, lr=1e-4, image_mix_loss_func="mse",
                      vae_beta=1.0, width=32, latent_width=8, depth=4,
                      latent=6, use_batchnorm=True, use_sigmoid=True,
                      max_grad_norm=1.0), device=cuda)
    rng = np.random.RandomState(4)
    multi = make_multi_train_step(tr.loss_config, device=cuda)
    multi(tr.state, [tr.draw_noise(b) for b in _graph_batches(
        rng, steps_mod.WARMUP_STEPS + 1, 2)], 0.3)
    eager_state = _clone_state(tr.state)
    batches = [tr.draw_noise(b) for b in _graph_batches(rng, 4, 2)]
    _, got = multi(tr.state, batches, 0.3)
    eager = make_train_step(tr.loss_config)
    for i, b in enumerate(batches):
        _, want = eager(eager_state, b, 0.3)
        for k, v in want.items():
            assert abs(float(got[k][i]) - float(v)) <= 1e-6 * abs(float(v)), k
    for (k, p), q in zip(tr.state.model.state_dict().items(),
                         eager_state.model.state_dict().values()):
        assert float((p - q).abs().max()) <= 1e-6 * float(q.abs().max()), k


def _labeled_batches(rng, n, mask=True):
    """(image, label) batches on the card, with a loss mask."""
    out = []
    for _ in range(n):
        def planes(k):
            return np.concatenate([rng.rand(k, 1, 32, 32),
                                   rng.randint(0, 4, (k, 1, 32, 32))], axis=1)
        a_to = rng.uniform(0.1, 0.9, 2).astype(np.float32)
        batch = {"image": planes(4), "slice_between": planes(2),
                 "alpha_from": 1 - a_to, "alpha_to": a_to,
                 "is_inbetween": np.array([1.0, 0.0])}
        if mask:
            batch["loss_mask"] = (rng.rand(2, 1, 32, 32) > 0.3)
        out.append({k: torch.from_numpy(np.asarray(v, np.float32)).cuda()
                    for k, v in batch.items()})
    return out


@pytest.mark.parametrize("model", ["multichannel", "ae_combined"])
def test_multichannel_graph_replay_matches_eager_steps(cuda, model,
                                                       monkeypatch):
    """The labeled families (ACDCLBL) under ``make_multi_train_step``: the
    Dice one-hot, the label cast and the class head's BatchNorm capture
    without a host sync, and 4 replays equal 4 eager steps from the same
    state and batches (1e-6 relative)."""
    from superresolution_aniso_mri_tpu_torch.train import (
        Trainer, make_multi_train_step, make_train_step)
    from superresolution_aniso_mri_tpu_torch.train import steps as steps_mod

    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    tr = Trainer(dict(model=model, dataset="ACDCLBL", lr=1e-4,
                      image_mix_loss_func="mse", width=32, latent_width=8,
                      depth=4, latent=6, colors=2, use_batchnorm=True,
                      use_sigmoid=True, get_masks=True), device=cuda)
    assert tr.family.startswith("multichannel")
    rng = np.random.RandomState(5)
    multi = make_multi_train_step(tr.loss_config, device=cuda)
    replays = []
    replay = steps_mod._CapturedStep.replay
    monkeypatch.setattr(steps_mod._CapturedStep, "replay",
                        lambda self, *a: replays.append(1) or replay(self, *a))
    multi(tr.state, _labeled_batches(rng, steps_mod.WARMUP_STEPS + 1), 0.3)
    eager_state = _clone_state(tr.state)
    batches = _labeled_batches(rng, 4)
    _, got = multi(tr.state, batches, 0.3)
    assert len(replays) == 5
    eager = make_train_step(tr.loss_config)
    for i, b in enumerate(batches):
        _, want = eager(eager_state, b, 0.3)
        for k, v in want.items():
            assert abs(float(got[k][i]) - float(v)) <= 1e-6 * abs(float(v)), k
    for (k, p), q in zip(tr.state.model.state_dict().items(),
                         eager_state.model.state_dict().values()):
        assert float((p - q).abs().max()) <= 1e-6 * float(q.abs().max()), k


def test_labeled_serving_and_dice_on_card_match_cpu(cuda):
    """A MultiChannelAE served on the card against the CPU (float32, TF32
    off): the image within 1e-4 and the decoded labels on at least 99.9%
    of the voxels (an argmax near a tie may round either way); Dice on
    the card against the CPU within 1e-6."""
    from superresolution_aniso_mri_tpu_torch.infer import (
        ServingModel, create_super_volume)
    from superresolution_aniso_mri_tpu_torch.models import AEConfig
    from superresolution_aniso_mri_tpu_torch.ops import dice_loss

    cfg = AEConfig(width=32, latent_width=8, depth=8, latent=6, colors=2,
                   use_batchnorm=True)
    card = ServingModel(cfg, device=cuda, ae_class="MultiChannelAE",
                        generator=torch.Generator().manual_seed(0))
    cpu = ServingModel(cfg, card._ae_model().state_dict(), device="cpu",
                       ae_class="MultiChannelAE")
    rng = np.random.RandomState(6)
    img = _pair((19, 41, 46), seed=2)[0]
    lbl = rng.randint(0, 4, img.shape).astype(np.int16)
    kw = dict(downsample_steps=3, alpha_range=[1 / 3, 2 / 3],
              generate_inbetween_slices=True, labels=lbl)
    got = create_super_volume(card, img, **kw)
    want = create_super_volume(cpu, img, **kw)
    np.testing.assert_allclose(got["upsampled_image"],
                               want["upsampled_image"], atol=1e-4)
    assert got["upsampled_labels"].dtype == np.int16
    assert np.mean(got["upsampled_labels"] == want["upsampled_labels"]) \
        >= 0.999
    probs = torch.softmax(torch.randn(3, 4, 20, 24), dim=1)
    labels = torch.randint(0, 4, (3, 20, 24), dtype=torch.int32)
    assert abs(float(dice_loss(probs.cuda(), labels.cuda(), 4))
               - float(dice_loss(probs, labels, 4))) <= 1e-6


ALPHA_ARGS = dict(lr=1e-5, dataset="ACDC", width=32, latent_width=8,
                  depth=4, latent=6, use_batchnorm=True, use_sigmoid=True,
                  seed=2)


def _alpha_batches(rng, n, device):
    """Train batches with the probes' ``alpha_features`` and a loss mask
    on ``device``."""
    out = []
    for b in _graph_batches(rng, n, 2):
        b["alpha_features"] = torch.from_numpy(
            rng.rand(2, 5).astype(np.float32)).cuda()
        b["loss_mask"] = torch.from_numpy(
            (rng.rand(2, 1, 32, 32) > 0.3).astype(np.float32)).cuda()
        out.append({k: v.to(device) for k, v in b.items()})
    return out


@pytest.mark.parametrize("model, alpha_class", [
    ("alpha", "AlphaProbe"), ("alpha_end_to_end", "AlphaProbe256v1"),
    ("alpha_only", "AlphaProbe16Convex"), ("alpha_combined", "AlphaProbe16v1"),
])
def test_alpha_steps_on_card_match_cpu(cuda, model, alpha_class):
    """3 steps of each alpha family (masked synthesis loss, the probe's
    BatchNorm) on the card against the CPU from the same weights and
    batches: every metric within 1e-5 relative; the parameters' movement
    θ3 − θ0 within 0.1 of its largest entry for 99.5 % of the entries
    (Adam's first steps are near-sign steps of size lr, so only an entry
    whose update changed sign moves far from the other side's);
    alpha_only's autoencoder unchanged on both."""
    from superresolution_aniso_mri_tpu_torch.train import Trainer

    args = dict(ALPHA_ARGS, model=model, alpha_class=alpha_class,
                use_batchnorm_probe=True, get_masks=True)
    card, cpu = Trainer(args, device=cuda), Trainer(args, device="cpu")
    cpu.model.load_state_dict({k: v.cpu() for k, v in
                               card.model.state_dict().items()})
    ae0 = {k: v.clone() for k, v in cpu.model["ae"].state_dict().items()}
    theta0 = [p.detach().clone() for p in cpu.model.parameters()]
    rng = np.random.RandomState(7)
    for b in _alpha_batches(rng, 3, cuda):
        _, cm = card.train_step(card.state, b, 0.3)
        _, hm = cpu.train_step(cpu.state, {k: v.cpu() for k, v in b.items()},
                               0.3)
        for k in hm:
            assert abs(float(cm[k]) - float(hm[k])) <= 1e-5 * max(
                abs(float(hm[k])), 1e-6), k
    moves = [(p.detach().cpu() - p0, q.detach() - p0) for p, q, p0 in
             zip(card.model.parameters(), cpu.model.parameters(), theta0)]
    top = max(float(b.abs().max()) for _, b in moves)
    gap = torch.cat([(a - b).abs().reshape(-1) for a, b in moves])
    assert float((gap <= 0.1 * top).double().mean()) >= 0.995
    if model == "alpha_only":
        for k, v in ae0.items():
            assert torch.equal(cpu.model["ae"].state_dict()[k], v)
            assert torch.equal(card.model["ae"].state_dict()[k].cpu(), v)


def test_alpha_graph_replay_matches_eager_steps(cuda, monkeypatch):
    """``alpha_end_to_end`` (spatial probe, masked loss) under
    ``make_multi_train_step``: the probe, the spatial mix and the
    ``alpha_features`` buffer capture, and 4 replays equal 4 eager steps
    from the same state and batches (1e-6 relative)."""
    from superresolution_aniso_mri_tpu_torch.train import (
        Trainer, make_multi_train_step, make_train_step)
    from superresolution_aniso_mri_tpu_torch.train import steps as steps_mod

    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    tr = Trainer(dict(ALPHA_ARGS, model="alpha_end_to_end",
                      alpha_class="AlphaProbe256v1", get_masks=True),
                 device=cuda)
    rng = np.random.RandomState(8)
    multi = make_multi_train_step(tr.loss_config, device=cuda)
    replays = []
    replay = steps_mod._CapturedStep.replay
    monkeypatch.setattr(steps_mod._CapturedStep, "replay",
                        lambda self, *a: replays.append(1) or replay(self, *a))
    multi(tr.state, _alpha_batches(rng, steps_mod.WARMUP_STEPS + 1, cuda),
          0.3)
    eager_state = _clone_state(tr.state)
    batches = _alpha_batches(rng, 4, cuda)
    _, got = multi(tr.state, batches, 0.3)
    assert len(replays) == 5
    eager = make_train_step(tr.loss_config)
    for i, b in enumerate(batches):
        _, want = eager(eager_state, b, 0.3)
        for k, v in want.items():
            assert abs(float(got[k][i]) - float(v)) <= 1e-6 * abs(float(v)), k
    for (k, p), q in zip(tr.state.model.state_dict().items(),
                         eager_state.model.state_dict().values()):
        assert float((p - q).abs().max()) <= 1e-6 * float(q.abs().max()), k


def test_alpha_mix_spatial_on_card_matches_cpu(cuda):
    """The spatial scheme (one coefficient per latent position, JAX's
    row-major order) on the card against the CPU, and the other schemes
    (atol 1e-6)."""
    from superresolution_aniso_mri_tpu_torch.train.steps import alpha_mix

    rng = np.random.RandomState(9)
    z1, z3 = (torch.from_numpy(rng.randn(3, 6, 8, 8).astype(np.float32))
              for _ in range(2))
    for scheme, n in (("spatial", 64), ("pair", 2), ("convex", 6),
                      ("halves", 12)):
        a = torch.from_numpy(rng.rand(3, n).astype(np.float32))
        want = alpha_mix(a, z1, z3, n, 6, scheme)
        got = alpha_mix(a.cuda(), z1.cuda(), z3.cuda(), n, 6, scheme)
        assert float((got.cpu() - want).abs().max()) <= 1e-6, scheme


EVAL_ARGS = dict(model="ae_combined", dataset="OASIS", width=32,
                 latent_width=8, depth=4, latent=6, use_batchnorm=True,
                 use_sigmoid=True, lr=1e-4, seed=0)


def _eval_trainer(device, seed=0):
    """An eval-mode trainer of ``EVAL_ARGS`` with seeded weights whose
    conv kernels are doubled, so that its decoder is not nearly constant
    (a seeded network's output varies by ~1e-4 over a volume)."""
    from superresolution_aniso_mri_tpu_torch.train import Trainer

    t = Trainer(dict(EVAL_ARGS, seed=seed), eval_mode=True, device=device)
    with torch.no_grad():
        for p in t.model.parameters():
            if p.ndim == 4:
                p.mul_(2)
    return t


def _eval_trainers(cuda):
    """``_eval_trainer`` on the card and on the CPU (the same weights)."""
    return _eval_trainer(cuda), _eval_trainer("cpu")


def test_combo_on_card_matches_cpu(cuda, tmp_path):
    """The AE+CAISR combo (``load_caisr`` of another seed's checkpoint)
    served on the card against the CPU (float32, TF32 off: atol 1e-4);
    its synthesized slices differ from the autoencoder's own, its kept
    slices are the autoencoder's reconstructions."""
    from superresolution_aniso_mri_tpu_torch.infer import create_super_volume

    path = str(tmp_path / "sr.models")
    _eval_trainer("cpu", seed=5).save_models(path, 1)
    card, cpu = _eval_trainers(cuda)
    img = _pair((19, 40, 48), seed=3)[0]
    kw = dict(downsample_steps=3, alpha_range=[1 / 3, 2 / 3],
              generate_inbetween_slices=True)
    ae_only = create_super_volume(card, img, **kw)["upsampled_image"]
    for t in (card, cpu):
        t.load_caisr(path)
    got = create_super_volume(card, img, **kw)["upsampled_image"]
    want = create_super_volume(cpu, img, **kw)["upsampled_image"]
    np.testing.assert_allclose(got, want, atol=1e-4)
    synth = np.arange(got.shape[0]) % 3 != 0
    assert np.abs(got[synth] - ae_only[synth]).max() > 1e-3
    np.testing.assert_allclose(got[~synth], ae_only[~synth], atol=1e-6)


def test_grid_sample_3d_on_card_matches_cpu(cuda):
    """JAX's trilinear gather as torch ops on the card against the CPU,
    coordinates off the volume and at exactly ±1 included (atol 1e-6)."""
    from superresolution_aniso_mri_tpu_torch.evaluate import grid_sample_3d

    rng = np.random.RandomState(4)
    vol = torch.from_numpy(rng.rand(10, 216, 256).astype(np.float32))
    grid = rng.uniform(-1.1, 1.1, (3, 64, 96, 3)).astype(np.float32)
    grid[0, 0] = 1.0
    grid[0, 1] = -1.0
    grid = torch.from_numpy(grid)
    got = grid_sample_3d(vol.to(cuda), grid.to(cuda)).cpu()
    want = grid_sample_3d(vol, grid)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6)


def test_compute_ppl_on_card_matches_cpu(cuda):
    """PPL of 4 pairs on the card against the CPU at ``epsilon`` 1e-2
    (rel 1e-3: the VGG stack's float32 sums run in other orders on cuDNN
    and on the CPU; at the default 1e-4 the path length is mostly the
    float32 rounding of two near-equal decodes)."""
    from superresolution_aniso_mri_tpu_torch.evaluate import compute_ppl

    card, cpu = _eval_trainers(cuda)
    pool = np.random.RandomState(3).rand(6, 48, 40).astype(np.float32)
    got = compute_ppl(card, pool, num_pairs=4, epsilon=1e-2, seed=1)
    want = compute_ppl(cpu, pool, num_pairs=4, epsilon=1e-2, seed=1)
    assert got == pytest.approx(want, rel=1e-3)
    assert got > 0.01


def test_perceptual_tools_on_card_match_cpu(cuda):
    """``fit_lins`` and the distortion study's per-pair distances on the
    card against the CPU at 2 slices of 32², with the shipped encoder
    artifact: the fitted lins within 1e-3 relative after 50 Adam steps
    (float32 feature sums in other orders), the distances within 1e-4
    relative."""
    from superresolution_aniso_mri_tpu_torch.ops.lpips import \
        get_lpips_params
    from superresolution_aniso_mri_tpu_torch.ops.perceptual import \
        load_enc_perceptual
    from superresolution_aniso_mri_tpu_torch.tools import (
        fit_perceptual_head, lpips_gap_study)

    npz = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "weights", "perceptual_enc.npz")
    data = fit_perceptual_head.build_fit_set(2, 32, device="cpu")
    w = [fit_perceptual_head.fit_lins(load_enc_perceptual(npz, d), data,
                                      iters=50)[0] for d in (cuda, "cpu")]
    assert np.abs(w[0] - w[1]).max() <= 1e-3 * np.abs(w[1]).max()
    suite = lpips_gap_study.distortion_suite(np.random.RandomState(0))
    sl = lpips_gap_study.reference_slices(2, 32)[1]
    dists = lpips_gap_study.distorted(sl, suite)
    rows = [lpips_gap_study.score_suite(
        sl, dists, get_lpips_params(device=d), load_enc_perceptual(npz, d),
        lpips_gap_study.msssim_levels(32), d) for d in (cuda, "cpu")]
    for k, want in rows[1].items():
        want = np.asarray(want)
        assert np.abs(np.asarray(rows[0][k]) - want).max() <= (
            1e-4 * np.abs(want).max()), k


def test_real_pipeline_quality_row_on_card(cuda, tmp_path):
    """``real-pipeline-quality`` through the port's CLI on the card at
    the reduced OASIS row of ``chip_smoke.py`` phase 18 (the README
    recipe's flags, 7 patients of 37 × 64², 4 epochs): it exits 0 and
    appends one row with the keys of JAX's recorded row (r4 row 1, with
    the four JAX's tool has written since) and finite metrics."""
    import json
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    row_path = tmp_path / "row.jsonl"
    env = dict(os.environ, TMPDIR=str(tmp_path), PYTHONPATH=os.pathsep.join(
        p for p in (repo, os.environ.get("PYTHONPATH")) if p))
    r = subprocess.run(
        [sys.executable, "-m", "superresolution_aniso_mri_tpu_torch.cli",
         "real-pipeline-quality", "--dataset_shape", "OASIS",
         "--n_patients", "7", "--num_slices", "37", "--inplane", "64",
         "--phantom_noise", "0.03", "--loss_mode", "mse", "--latent_width",
         "32", "--use_batchnorm", "0", "--lr_schedule", "--latent_interp",
         "lanczos3", "--epochs", "4", "--sweep_last", "2",
         "--extra_test_volumes", "2", "--json_out", str(row_path)],
        cwd=repo, env=env, capture_output=True, text=True, timeout=900)
    assert r.returncode == 0, r.stderr[-4000:]
    with open(os.path.join(repo, "docs", "quality_real_r4.jsonl")) as f:
        want = set(json.loads(f.readlines()[1])) | {
            "score_noise", "aug_noise", "aug_blur", "max_grad_norm"}
    rows = [json.loads(line) for line in row_path.read_text().splitlines()]
    assert len(rows) == 1 and set(rows[0]) == want
    for k in ("model", "model_all_slices", "best_conventional",
              "model_extra", "best_conventional_extra"):
        assert all(np.isfinite(v) for v in rows[0][k].values()), k
    assert rows[0]["epochs"] == 4 and rows[0]["n_extra_test"] == 2


def test_sr_ranges_add_no_device_busy_time(cuda, tmp_path):
    """Under the profiler, with the port's spans on: serving two volumes
    and a graph-replayed dispatch store their stage spans, whose
    ``sr.*`` ranges have device-side shadows in the trace; the
    benchmark's ``TraceSummary.busy_s`` is the union of the kernel,
    memcpy and memset events alone, so the shadows add no busy time."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from port_bench.trace import WINDOW, TraceSummary
    from superresolution_aniso_mri_tpu_torch.infer import (
        ServingModel, create_super_volumes)
    from superresolution_aniso_mri_tpu_torch.models import (AEConfig,
                                                            VanillaACAI)
    from superresolution_aniso_mri_tpu_torch.train import (
        LossConfig, create_train_state, make_multi_train_step)
    from superresolution_aniso_mri_tpu_torch.train.steps import WARMUP_STEPS
    from superresolution_aniso_mri_tpu_torch.utils.profiling import (
        clear_spans, spans)

    cfg = AEConfig(width=32, latent_width=8, depth=4, latent=6)
    serving = ServingModel(cfg, device=cuda,
                           generator=torch.Generator().manual_seed(0))
    vols = [_pair((19, 40, 44), seed=s)[0] for s in (1, 2)]
    kw = dict(alpha_range=[1 / 3, 2 / 3], latent_interp="lanczos3")
    create_super_volumes(serving, vols, **kw)
    model = VanillaACAI(cfg)
    model.reset_parameters(torch.Generator().manual_seed(0))
    state = create_train_state(model.to(cuda), 1e-4)
    multi = make_multi_train_step(LossConfig(model="ae_combined",
                                             image_mix_loss_func="mse"),
                                  device=cuda)
    batches = _graph_batches(np.random.RandomState(4), WARMUP_STEPS + 2, 2)
    torch.cuda.synchronize()
    clear_spans()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(WINDOW):
            create_super_volumes(serving, vols, **kw)
            multi(state, batches, 0.3)
            torch.cuda.synchronize()
    names = [sp.name for sp in spans()]
    for name in ("serve.request", "serve.prep", "serve.upload",
                 "synth.encode", "synth.mix", "synth.decode",
                 "serve.readback", "serve.finalize"):
        assert name in names, name
    assert names.count("build.eager_step") == WARMUP_STEPS
    assert names.count("build.graph") == 1
    assert names.count("train.replay") == 2
    # the profiler's own categories, from its Chrome trace
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    cats = {}
    for e in json.loads(path.read_text())["traceEvents"]:
        cats.setdefault(e.get("cat"), set()).add(e.get("name"))
    work_names = cats["kernel"] | cats["gpu_memcpy"] | cats.get("gpu_memset",
                                                               set())
    assert any(n.startswith("sr.") for n in cats["gpu_user_annotation"])
    assert not work_names & cats["gpu_user_annotation"]
    # their union in the window, in the arithmetic of TraceSummary
    dev = torch.autograd.DeviceType.CUDA
    events = prof.profiler.kineto_results.events()

    def seconds(e):
        start = e.start_ns() * 1e-9
        return start, start + e.duration_ns() * 1e-9

    (lo, hi), = [seconds(e) for e in events
                 if e.name() == WINDOW and e.device_type() != dev]
    work = sorted((max(s, lo), min(e, hi)) for s, e in (
        seconds(e) for e in events
        if e.device_type() == dev and e.name() in work_names))
    merged = []
    for s, e in work:
        if e <= s:
            continue
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    busy = sum(e - s for s, e in merged)
    assert busy > 0
    assert TraceSummary(prof).busy_s == pytest.approx(busy, rel=1e-12)


def test_failed_capture_raises_without_eager_fallback(cuda, monkeypatch):
    """A step that syncs with the host cannot be captured: the dispatch
    raises, on every call, and never falls back to eager steps (last in
    this file: the failed capture is left behind in the process)."""
    from superresolution_aniso_mri_tpu_torch.models import (AEConfig,
                                                            VanillaACAI)
    from superresolution_aniso_mri_tpu_torch.train import (
        LossConfig, create_train_state, make_multi_train_step)
    from superresolution_aniso_mri_tpu_torch.train import steps as steps_mod

    losses = steps_mod._ae_losses

    def syncing(*a, **kw):
        loss, metrics = losses(*a, **kw)
        float(loss.detach())   # a host sync: not allowed while capturing
        return loss, metrics

    monkeypatch.setattr(steps_mod, "_ae_losses", syncing)
    model = VanillaACAI(AEConfig(width=32, latent_width=8, depth=4,
                                 latent=6))
    model.reset_parameters(torch.Generator().manual_seed(0))
    state = create_train_state(model.to(cuda), 1e-4)
    multi = make_multi_train_step(LossConfig(model="ae_combined",
                                             image_mix_loss_func="mse"),
                                  device=cuda)
    rng = np.random.RandomState(3)
    with pytest.raises(RuntimeError):
        multi(state, _graph_batches(rng, steps_mod.WARMUP_STEPS + 1, 2), 0.3)
    assert state.opt_state.count == steps_mod.WARMUP_STEPS
    with pytest.raises(RuntimeError):
        multi(state, _graph_batches(rng, 1, 2), 0.3)
    assert state.opt_state.count == steps_mod.WARMUP_STEPS
