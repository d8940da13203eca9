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


@pytest.mark.parametrize("shape", [(175, 220, 220), (8, 256, 256),
                                   (5, 129, 97)])
def test_ssim_kernel_matches_plain_version(cuda, shape):
    """atol 1e-5, as chip_smoke.py: the kernel repeats the plain
    version's per-pixel arithmetic; only the order of the mean differs."""
    a, b = (torch.from_numpy(x).to(cuda) for x in _pair(shape))
    for win in cuda_kernels.SSIM_WINDOWS:
        before = cuda_kernels.LAUNCHES["ssim_slice"]
        got = cuda_kernels.ssim_volume_fused(a, b, 1.0, win)
        torch.cuda.synchronize()
        assert cuda_kernels.LAUNCHES["ssim_slice"] == before + 1
        want = ssim_volume(a, b, 1.0, win)
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                                   atol=1e-5)


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
