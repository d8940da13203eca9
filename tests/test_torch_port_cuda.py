"""PyTorch port on the card: the CUDA SSIM kernel against its plain
version, and the serving and scoring entry points on CUDA against the
same calls on the CPU. Every test here needs an NVIDIA GPU and skips
without one.

This file imports neither JAX nor the JAX package, so it runs where
only the port's dependencies are installed:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_port_cuda.py
"""
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
