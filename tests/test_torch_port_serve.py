"""PyTorch port, serving layer: create_super_volume(s) against the JAX
package on the CPU, the port's option errors, its CUDA-by-default
device rule and its import boundary.

Weights and volumes come from numpy seeds. The model (width 32,
latent_width 8, depth 4, latent 6) has two scales, so the 30 x 34
in-plane size exercises the reflect-pad-and-crop path. Float32 serving
agrees with JAX (run at ``jax.default_matmul_precision("highest")``)
within 1e-5: the outputs are sigmoid values in [0, 1] and the two
frameworks differ only in the order of float32 sums.
"""
import os
import re
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from superresolution_aniso_mri_tpu.infer import super_volume as jsv
from superresolution_aniso_mri_tpu_torch.infer import (ServingModel,
                                                       create_super_volume,
                                                       create_super_volumes)
from superresolution_aniso_mri_tpu_torch.infer import super_volume as tsv
from superresolution_aniso_mri_tpu_torch.models import AEConfig
from torch_port_helpers import SMALL, serving_pair

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_PKG = os.path.join(REPO, "superresolution_aniso_mri_tpu_torch")
ATOL = 1e-5
# 14 slices at ds=3: kept 0,3,6,9,12 and one verbatim tail slice
INBETWEEN = dict(downsample_steps=3, alpha_range=[1 / 3, 2 / 3],
                 generate_inbetween_slices=True)


@pytest.fixture(scope="module")
def pair():
    return serving_pair(seed=0)


def _volume(seed, s=14, h=30, w=34):
    return np.random.RandomState(seed).rand(s, h, w).astype(np.float32)


def _both(pair, images, fn_jax=jsv.create_super_volume,
          fn_port=create_super_volume, **kw):
    stub, port = pair
    with jax.default_matmul_precision("highest"):
        want = fn_jax(stub, images, **kw)
    return want, fn_port(port, images, **kw)


@pytest.mark.parametrize("use_original", [False, True])
@pytest.mark.parametrize("latent_interp", ["linear", "cubic", "lanczos3"])
def test_inbetween_volume_matches_jax(pair, latent_interp, use_original):
    img = _volume(1)
    want, got = _both(pair, img, latent_interp=latent_interp,
                      use_original=use_original, **INBETWEEN)
    assert got["upsampled_image"].shape == (14, 30, 34)
    assert got["upsampled_image"].dtype == np.float32
    np.testing.assert_allclose(got["upsampled_image"],
                               want["upsampled_image"], atol=ATOL)
    np.testing.assert_array_equal(got["pred_alphas"], want["pred_alphas"])
    # the tail slice comes back verbatim
    np.testing.assert_array_equal(got["upsampled_image"][-1], img[-1])


def test_interpolation_mode_with_labels_matches_jax(pair):
    """num-interpolations mode (no downsampling, default alphas) and the
    nearest-neighbour label ride-along."""
    img = _volume(2, s=5)
    labels = np.random.RandomState(3).randint(0, 4, (5, 30, 34))
    want, got = _both(pair, img, labels=labels)
    assert got["upsampled_image"].shape == (17, 30, 34)
    np.testing.assert_allclose(got["upsampled_image"],
                               want["upsampled_image"], atol=ATOL)
    np.testing.assert_array_equal(got["upsampled_labels"],
                                  want["upsampled_labels"])
    np.testing.assert_array_equal(got["pred_alphas"], want["pred_alphas"])


def test_tta_flips_matches_jax(pair):
    want, got = _both(pair, _volume(4), tta="flips", **INBETWEEN)
    np.testing.assert_allclose(got["upsampled_image"],
                               want["upsampled_image"], atol=ATOL)


@pytest.mark.parametrize("latent_interp", ["linear", "lanczos3"])
def test_pad_to_bucket_does_not_change_output(pair, latent_interp):
    img = _volume(5)
    kw = dict(INBETWEEN, latent_interp=latent_interp)
    want, padded = _both(pair, img, pad_to_bucket=False, **kw)
    unpadded = create_super_volume(pair[1], img, pad_to_bucket=True, **kw)
    np.testing.assert_allclose(padded["upsampled_image"],
                               want["upsampled_image"], atol=ATOL)
    np.testing.assert_allclose(unpadded["upsampled_image"],
                               padded["upsampled_image"], atol=1e-6)


def test_decode_batch_does_not_change_output(pair):
    img = _volume(6)
    want, got = _both(pair, img, decode_batch=2, **INBETWEEN)
    np.testing.assert_allclose(got["upsampled_image"],
                               want["upsampled_image"], atol=ATOL)
    for db in (None, "auto", 3):
        other = create_super_volume(pair[1], img, decode_batch=db,
                                    **INBETWEEN)
        np.testing.assert_allclose(other["upsampled_image"],
                                   got["upsampled_image"], atol=1e-6)


def test_batched_volumes_match_single_calls_and_jax(pair):
    imgs = [_volume(10 + i) for i in range(3)]
    want, got = _both(pair, imgs, fn_jax=jsv.create_super_volumes,
                      fn_port=create_super_volumes,
                      latent_interp="lanczos3", **INBETWEEN)
    for img, w, g in zip(imgs, want, got):
        single = create_super_volume(pair[1], img, latent_interp="lanczos3",
                                     **INBETWEEN)
        np.testing.assert_allclose(g["upsampled_image"],
                                   single["upsampled_image"], atol=1e-6)
        np.testing.assert_allclose(g["upsampled_image"],
                                   w["upsampled_image"], atol=ATOL)


def test_fitted_tap_table_matches_jax(pair, tmp_path):
    from superresolution_aniso_mri_tpu.infer.latent_taps import (
        save_latent_taps)

    path = str(tmp_path / "latent_taps.npz")
    rng = np.random.RandomState(7)
    weights = rng.dirichlet(np.ones(6), size=3).astype(np.float32)
    save_latent_taps(path, (-2, -1, 0, 1, 2, 3),
                     np.array([0.2, 0.5, 0.8], np.float32), weights)
    want, got = _both(pair, _volume(8), latent_interp=f"fitted:{path}",
                      **INBETWEEN)
    np.testing.assert_allclose(got["upsampled_image"],
                               want["upsampled_image"], atol=ATOL)


def test_fitted_tap_weights_interpolate_like_jax():
    from superresolution_aniso_mri_tpu.infer.latent_taps import (
        fitted_tap_weights as jax_weights)
    from superresolution_aniso_mri_tpu_torch.infer.latent_taps import (
        fitted_tap_weights)

    grid = np.array([0.0, 0.3, 0.6, 1.0], np.float32)
    table = np.random.RandomState(0).rand(4, 3).astype(np.float32)
    alphas = np.array([-0.1, 0.0, 0.15, 0.3, 0.45, 0.99, 1.0, 1.2],
                      np.float32)
    np.testing.assert_allclose(
        fitted_tap_weights(grid, table, torch.from_numpy(alphas)).numpy(),
        np.asarray(jax_weights(grid, table, alphas)), atol=1e-6)


def test_bf16_readback_within_bf16_quantisation(pair):
    img = _volume(9)
    f32 = create_super_volume(pair[1], img, **INBETWEEN)
    b16 = create_super_volume(pair[1], img, readback_dtype="bfloat16",
                              **INBETWEEN)
    assert b16["upsampled_image"].dtype == np.float32
    np.testing.assert_allclose(b16["upsampled_image"],
                               f32["upsampled_image"], atol=1.0 / 256 + 1e-6)
    assert not np.array_equal(b16["upsampled_image"], f32["upsampled_image"])


def test_bf16_compute_serving_close_to_jax():
    """compute_dtype='bfloat16' end to end, including the latent mix in
    bf16: both frameworks round per op but at different places inside
    the convs. Measured gap over seeds 0-2, linear and lanczos3: at
    most 4.4e-3 on the [0, 1] output (two bf16 ulps at 0.5); bound
    2e-2."""
    pair = serving_pair(seed=1, compute_dtype="bfloat16")
    want, got = _both(pair, _volume(11), latent_interp="lanczos3",
                      **INBETWEEN)
    np.testing.assert_allclose(got["upsampled_image"],
                               want["upsampled_image"], atol=2e-2)


def test_two_channel_model_matches_jax():
    """A colors=2 encoder takes the label plane as its second input."""
    pair = serving_pair(seed=2, colors=2)
    img = _volume(12)
    labels = np.random.RandomState(13).randint(0, 4, img.shape)
    want, got = _both(pair, img, labels=labels, **INBETWEEN)
    np.testing.assert_allclose(got["upsampled_image"],
                               want["upsampled_image"], atol=ATOL)
    np.testing.assert_array_equal(got["upsampled_labels"],
                                  want["upsampled_labels"])


@pytest.mark.parametrize("k", [0, 1, 8, 13, 513])
def test_shape_helpers_match_jax(k):
    assert tsv.bucket_size(k) == jsv.bucket_size(k)
    for h, depth in ((30, 4), (220, 32), (512, 64)):
        assert (tsv._auto_decode_batch(k * 6, h, h, depth)
                == jsv._auto_decode_batch(k * 6, h, h, depth))
        assert (tsv._batch_volume_cap(max(k, 2), 5, h, h, depth)
                == jsv._batch_volume_cap(max(k, 2), 5, h, h, depth))
    img = np.arange(max(k, 1) * 2).reshape(-1, 2)
    for ds in (1, 2, 6):
        a, ra = tsv.kept_slice_grid(img, ds)
        b, rb = jsv.kept_slice_grid(img, ds)
        assert ra == rb
        np.testing.assert_array_equal(a, b)


def test_interleave_order_matches_jax():
    rng = np.random.RandomState(0)
    recon = rng.rand(2, 4, 3, 5, 1).astype(np.float32)     # [B,K,H,W,C]
    interp = rng.rand(2, 3, 2, 3, 5, 1).astype(np.float32)
    want = np.asarray(jsv.interleave_volume(recon, interp))
    got = tsv.interleave_volume(
        torch.from_numpy(np.moveaxis(recon, -1, -3).copy()),
        torch.from_numpy(np.moveaxis(interp, -1, -3).copy()))
    np.testing.assert_array_equal(np.moveaxis(got.numpy(), -3, -1), want)


def test_synthesizer_factories_match_jax(pair):
    """make_volume_synthesizer / make_batched_synthesizer on a kept stack
    (the building blocks under create_super_volume(s))."""
    stub, port = pair
    kept = np.random.RandomState(14).rand(2, 5, 30, 34, 1).astype(np.float32)
    alphas = np.array([0.25, 0.5, 0.75], np.float32)
    params, stats = stub._ae_params()
    with jax.default_matmul_precision("highest"):
        want1 = jsv.make_volume_synthesizer(stub._ae_model(), 3)(
            params, stats, kept[0], alphas, interleave=True)
        want_b = jsv.make_batched_synthesizer(stub._ae_model())(
            params, stats, kept, alphas)
    kept_t = torch.from_numpy(np.moveaxis(kept, -1, -3).copy())
    got1 = tsv.make_volume_synthesizer(port._ae_model(), 3)(
        kept_t[0], torch.from_numpy(alphas), interleave=True)
    got_b = tsv.make_batched_synthesizer(port._ae_model())(
        kept_t, torch.from_numpy(alphas))
    for key in ("recon", "interp", "volume"):
        np.testing.assert_allclose(np.moveaxis(got1[key].numpy(), -3, -1),
                                   np.asarray(want1[key]), atol=ATOL)
    np.testing.assert_allclose(np.moveaxis(got_b.numpy(), -3, -1),
                               np.asarray(want_b), atol=ATOL)


def test_latent_mix_and_tap_weights_match_jax():
    from superresolution_aniso_mri_tpu.ops import losses as jl
    from superresolution_aniso_mri_tpu_torch.ops import losses as tl

    rng = np.random.RandomState(15)
    z = rng.randn(6, 4, 3, 2).astype(np.float32)
    a_f, a_t = rng.rand(3).astype(np.float32), rng.rand(3, 1).astype(np.float32)
    np.testing.assert_allclose(
        tl.latent_mix(torch.from_numpy(z), a_f, a_t).numpy(),
        np.asarray(jl.latent_mix(z, a_f, a_t)), atol=1e-6)
    t = np.array([0.0, 0.2, 0.5, 5 / 6, 1.0], np.float32)
    np.testing.assert_allclose(
        tl.catmull_rom_weights(torch.from_numpy(t)).numpy(),
        np.asarray(jl.catmull_rom_weights(t)), atol=1e-6)
    np.testing.assert_allclose(
        tl.lanczos3_weights(torch.from_numpy(t)).numpy(),
        np.asarray(jl.lanczos3_weights(t)), atol=1e-6)
    assert tl.LANCZOS3_OFFSETS == jl.LANCZOS3_OFFSETS


@pytest.mark.parametrize("decodes_labels", [False, True])
def test_clip_with_label_channel_matches_jax(decodes_labels):
    vol = np.random.RandomState(16).uniform(-1, 3, (3, 4, 5, 2)).astype(
        np.float32)
    want = np.asarray(jsv.clip_with_label_channel(vol, decodes_labels))
    got = tsv.clip_with_label_channel(
        torch.from_numpy(np.moveaxis(vol, -1, -3).copy()), decodes_labels)
    np.testing.assert_array_equal(np.moveaxis(got.numpy(), -3, -1), want)


def test_serving_params_are_the_models():
    port = serving_pair(seed=3)[1]
    params, buffers = port._ae_params()
    assert set(params) | set(buffers) == set(port._ae_model().state_dict())
    assert all(not p.requires_grad for p in params.values())
    assert port.params_sr is None


@pytest.mark.parametrize("kw, exc, match", [
    (dict(num_devices=2), NotImplementedError, "S5"),
    (dict(readback_dtype="float16"), ValueError, "readback_dtype"),
    (dict(latent_interp="bogus"), ValueError, "latent_interp"),
])
def test_unported_options_raise(pair, kw, exc, match):
    with pytest.raises(exc, match=match):
        create_super_volume(pair[1], _volume(0), **kw)
    with pytest.raises(exc, match=match):
        create_super_volumes(pair[1], [_volume(0)] * 2, **kw)


def test_combo_and_packed_raise(pair):
    port = pair[1]
    port.params_sr = ({}, {})
    try:
        with pytest.raises(NotImplementedError, match="CAISR"):
            create_super_volume(port, _volume(0))
    finally:
        del port.params_sr
    with pytest.raises(NotImplementedError, match="packed"):
        tsv.make_synthesis_core(port._ae_model(), packed=True)


def test_entry_points_default_to_cuda(monkeypatch):
    """device=None means CUDA; without a CUDA device the entry points
    raise instead of running on the CPU."""
    from superresolution_aniso_mri_tpu_torch.evaluate import (
        compute_volume_metrics)

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = AEConfig(**SMALL)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServingModel(cfg, generator=torch.Generator().manual_seed(0))
    vol = _volume(0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        compute_volume_metrics(vol, vol)
    model = ServingModel(cfg, device="cpu",
                         generator=torch.Generator().manual_seed(0))
    assert model.device.type == "cpu"
    with pytest.raises(ValueError, match="state_dict or a seeded"):
        ServingModel(cfg, device="cpu")


def test_port_imports_without_jax():
    code = ("import sys\n"
            "sys.modules['jax'] = None\n"
            "for name in ('flax', 'optax', 'msgpack', 'yaml'):\n"
            "    sys.modules[name] = None\n"
            "import superresolution_aniso_mri_tpu_torch.evaluate\n"
            "import superresolution_aniso_mri_tpu_torch.infer\n"
            "import superresolution_aniso_mri_tpu_torch.ops.cuda_kernels\n"
            "import superresolution_aniso_mri_tpu_torch.train\n"
            "import superresolution_aniso_mri_tpu_torch.data\n"
            "bad = [m for m in sys.modules if m == "
            "'superresolution_aniso_mri_tpu' or m.startswith("
            "'superresolution_aniso_mri_tpu.')]\n"
            "assert not bad, bad\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr


def test_port_sources_import_nothing_of_the_jax_package():
    pattern = re.compile(
        r"^\s*(from|import)\s+(superresolution_aniso_mri_tpu(\.|\s|$)|jax\b"
        r"|flax\b|optax\b|msgpack\b|yaml\b)", re.M)
    scanned = []
    for root, _dirs, files in os.walk(PORT_PKG):
        for name in files:
            if name.endswith(".py"):
                path = os.path.join(root, name)
                with open(path) as f:
                    text = f.read()
                scanned.append(name)
                hits = [m.group(0) for m in pattern.finditer(text)]
                assert not hits, f"{path}: {hits}"
    with open(os.path.join(REPO, "chip_smoke.py")) as f:
        assert not pattern.search(f.read())
    assert {"super_volume.py", "metrics.py", "trainer.py", "steps.py",
            "checkpoint.py", "msgpack.py", "pairs.py"} <= set(scanned)
