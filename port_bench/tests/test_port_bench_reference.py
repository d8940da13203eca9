"""The plain reference against the port at a small size on the CPU."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from port_bench import weights
from port_bench.reference import losses, metrics
from port_bench.reference.model import Arch, Net
from port_bench.reference.precision import precision
from port_bench.reference.synth import synthesize

ARCH = Arch(16, 4, 4, 8)


def port_model(state):
    from superresolution_aniso_mri_tpu_torch.models import (AEConfig,
                                                             VanillaACAI)

    m = VanillaACAI(AEConfig(width=16, latent_width=4, depth=4, latent=8))
    m.load_state_dict(state)
    return m


@pytest.mark.parametrize("train", [False, True])
def test_encode_decode_match_the_port(train):
    state = weights.weight_set(ARCH, 3, "cpu", trained=True)
    x = torch.rand(6, 1, 16, 16, generator=torch.Generator().manual_seed(0))
    m = port_model(state)
    net = Net(ARCH, dict(state))
    with torch.no_grad():
        zp = m.encode(x, train, update_stats=False)
        zr = net.encode(x, train)
        assert torch.allclose(zp, zr, atol=1e-5, rtol=1e-5)
        assert torch.allclose(m.decode(zp, train, update_stats=False),
                              net.decode(zr, train), atol=1e-5)


def test_pyramid_loss_matches_the_port():
    from superresolution_aniso_mri_tpu_torch.ops.lap_pyramid import lap_loss

    g = torch.Generator().manual_seed(1)
    a, b = torch.rand(3, 1, 20, 20, generator=g), torch.rand(3, 1, 20, 20,
                                                             generator=g)
    assert abs(float(lap_loss(a, b)) - float(losses.lap_loss(a, b))) < 1e-6


def test_scores_match_the_port():
    from superresolution_aniso_mri_tpu_torch.ops import metrics as port

    g = torch.Generator().manual_seed(2)
    r = torch.rand(5, 32, 28, generator=g)
    d = (r + 0.05 * torch.randn(5, 32, 28, generator=g)).clamp(0, 1)
    for mine, theirs, tol in ((metrics.ssim, port.ssim_volume, 2e-6),
                              (metrics.psnr, port.psnr_volume, 2e-4),
                              (metrics.vif, port.vif_volume, 2e-5)):
        assert torch.allclose(mine(r, d).float(), theirs(r, d), atol=tol)


@pytest.mark.parametrize("interp", ["linear", "lanczos3"])
@pytest.mark.parametrize("use_original", [False, True])
def test_synthesis_matches_the_port(interp, use_original):
    from superresolution_aniso_mri_tpu_torch.infer.super_volume import \
        make_synthesis_core

    state = weights.weight_set(ARCH, 4, "cpu", trained=True)
    kept = torch.rand(7, 1, 16, 16, generator=torch.Generator().manual_seed(3))
    alphas = np.linspace(0, 1, 5)[1:-1]
    core = make_synthesis_core(port_model(state), latent_interp=interp)
    want = core(kept, torch.from_numpy(alphas.astype(np.float32)),
                use_original=use_original, interleave=True)["volume"][:, 0]
    with precision("float32"):
        got = synthesize(Net(ARCH, dict(state)), kept, alphas, interp,
                         use_original)
    assert got.shape == want.shape
    assert float((got - want).abs().max()) < 1e-5


def test_the_tf32_control_departs_on_the_cpu():
    state = weights.weight_set(ARCH, 5, "cpu", trained=True)
    kept = torch.rand(6, 1, 16, 16, generator=torch.Generator().manual_seed(4))
    a = np.linspace(0, 1, 5)[1:-1]
    exact = synthesize(Net(ARCH, dict(state)), kept, a, "linear", False)
    low = synthesize(Net(ARCH, dict(state), "tf32"), kept, a, "linear", False)
    assert float((exact - low).abs().max()) > 1e-5
