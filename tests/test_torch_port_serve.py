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
    (dict(num_devices=2), None, None),
    (dict(readback_dtype="float16"), ValueError, "readback_dtype"),
    (dict(latent_interp="bogus"), ValueError, "latent_interp"),
])
def test_unported_options_raise(pair, kw, exc, match):
    """Bad options raise on both entry points; ``num_devices=2`` serves
    (two CPU shards) the one-device volumes."""
    if exc is None:
        np.testing.assert_allclose(
            create_super_volume(pair[1], _volume(0), **kw)["upsampled_image"],
            create_super_volume(pair[1], _volume(0))["upsampled_image"],
            atol=ATOL)
        for got, want in zip(
                create_super_volumes(pair[1], [_volume(0)] * 2, **kw),
                create_super_volumes(pair[1], [_volume(0)] * 2)):
            np.testing.assert_allclose(got["upsampled_image"],
                                       want["upsampled_image"], atol=ATOL)
        return
    with pytest.raises(exc, match=match):
        create_super_volume(pair[1], _volume(0), **kw)
    with pytest.raises(exc, match=match):
        create_super_volumes(pair[1], [_volume(0)] * 2, **kw)


def test_combo_and_packed_raise(pair):
    """An SR model that is not the module ``Trainer.load_caisr`` loads
    (JAX's (params, batch_stats) pair) raises a TypeError on both entry
    points; the packed decoder (A11) synthesizes what the plain decoder
    does."""
    port = pair[1]
    port.params_sr = ({}, {})
    try:
        with pytest.raises(TypeError, match="load_caisr"):
            create_super_volume(port, _volume(0))
        with pytest.raises(TypeError, match="load_caisr"):
            create_super_volumes(port, [_volume(0)] * 2)
    finally:
        del port.params_sr
    kept = torch.from_numpy(_volume(0, s=6)[:, None])
    alphas = torch.tensor([0.25, 0.5, 0.75])
    packed = tsv.make_synthesis_core(port._ae_model(), packed=True)(
        kept, alphas, interleave=True)
    plain = tsv.make_synthesis_core(port._ae_model())(kept, alphas,
                                                      interleave=True)
    for key in ("recon", "interp", "volume"):
        np.testing.assert_allclose(packed[key].numpy(), plain[key].numpy(),
                                   atol=ATOL, err_msg=key)


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
            "for name in ('flax', 'optax', 'msgpack', 'yaml', 'PIL',\n"
            "             'matplotlib'):\n"
            "    sys.modules[name] = None\n"
            "import superresolution_aniso_mri_tpu_torch.evaluate\n"
            "import superresolution_aniso_mri_tpu_torch.infer\n"
            "import superresolution_aniso_mri_tpu_torch.ops.cuda_kernels\n"
            "import superresolution_aniso_mri_tpu_torch.train\n"
            "import superresolution_aniso_mri_tpu_torch.data\n"
            "import superresolution_aniso_mri_tpu_torch.data.datasets\n"
            "import superresolution_aniso_mri_tpu_torch.data.device_cache\n"
            "import superresolution_aniso_mri_tpu_torch.config.data_config\n"
            "import superresolution_aniso_mri_tpu_torch.config\n"
            "import superresolution_aniso_mri_tpu_torch.config.arguments\n"
            "import superresolution_aniso_mri_tpu_torch.utils.grids\n"
            "import superresolution_aniso_mri_tpu_torch.utils.watchdog\n"
            "import superresolution_aniso_mri_tpu_torch.cli.entry\n"
            "import superresolution_aniso_mri_tpu_torch.cli.train_loop\n"
            "import superresolution_aniso_mri_tpu_torch.cli.__main__\n"
            "import superresolution_aniso_mri_tpu_torch.tools.lpips_gap_study\n"
            "import superresolution_aniso_mri_tpu_torch.tools.fit_perceptual_head\n"
            "import superresolution_aniso_mri_tpu_torch.tools.convert_lpips_weights\n"
            "import superresolution_aniso_mri_tpu_torch.tools._subproc\n"
            "import superresolution_aniso_mri_tpu_torch.tools.real_pipeline_quality\n"
            "import superresolution_aniso_mri_tpu_torch.tools.quality_check\n"
            "import superresolution_aniso_mri_tpu_torch.tools.roofline\n"
            "import superresolution_aniso_mri_tpu_torch.tools.bench\n"
            "import superresolution_aniso_mri_tpu_torch.tools.infer_roofline\n"
            "import superresolution_aniso_mri_tpu_torch.tools.train_bench\n"
            "import superresolution_aniso_mri_tpu_torch.tools.pipeline_bench\n"
            "import superresolution_aniso_mri_tpu_torch.tools.loader_bench\n"
            "import superresolution_aniso_mri_tpu_torch.data.masi\n"
            "import superresolution_aniso_mri_tpu_torch.data.acdc_aux\n"
            "import superresolution_aniso_mri_tpu_torch.evaluate.sr_seg_eval\n"
            "import superresolution_aniso_mri_tpu_torch.utils.dicom\n"
            "import superresolution_aniso_mri_tpu_torch.utils.image_misc\n"
            "import superresolution_aniso_mri_tpu_torch.parallel\n"
            "import superresolution_aniso_mri_tpu_torch.infer.packed_decoder\n"
            "import superresolution_aniso_mri_tpu_torch.parallel.mesh\n"
            "import superresolution_aniso_mri_tpu_torch.data.native_loader\n"
            "import superresolution_aniso_mri_tpu_torch.evaluate.plots\n"
            "import superresolution_aniso_mri_tpu_torch.evaluate.journal2\n"
            "import superresolution_aniso_mri_tpu_torch.evaluate.spie2021\n"
            "import superresolution_aniso_mri_tpu_torch.utils.loss_curves\n"
            "from superresolution_aniso_mri_tpu_torch.evaluate import plots\n"
            "try:\n"
            "    plots.metric_boxplots({})\n"
            "except ModuleNotFoundError as e:\n"
            "    assert e.name == 'matplotlib', e\n"
            "else:\n"
            "    raise AssertionError('a figure drew without matplotlib')\n"
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
        r"|flax\b|optax\b|msgpack\b|yaml\b|PIL\b)", re.M)
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
            "checkpoint.py", "msgpack.py", "pairs.py", "settings.py",
            "arguments.py", "net_config.py", "nifti.py", "grids.py",
            "watchdog.py", "datasets.py", "synthetic.py", "entry.py",
            "train_loop.py", "__main__.py", "create_hr_images.py",
            "find_best_model.py", "sweep.py",
            "evaluate_image.py", "transforms.py", "device_cache.py",
            "data_config.py", "combine_ae_caisr.py", "reconstruction.py",
            "quantitative_comparison.py", "ppl.py", "drivers.py",
            "model_registry.py", "sax_to_lax.py", "seg_metrics.py",
            "clinical.py", "masi.py", "acdc_aux.py", "sr_seg_eval.py",
            "dicom.py", "image_misc.py", "lpips_gap_study.py",
            "fit_perceptual_head.py", "distributed.py", "mesh.py",
            "packed_decoder.py", "native_loader.py", "plots.py",
            "journal2.py", "spie2021.py", "loss_curves.py",
            "convert_lpips_weights.py", "roofline.py", "bench.py",
            "infer_roofline.py", "train_bench.py", "pipeline_bench.py",
            "loader_bench.py"} <= set(scanned)


# ---------------------------------------------------------------------------
# the output path: the image plane clamped on the device, read back into an
# array of each volume's own; the host clips only the verbatim tail
# ---------------------------------------------------------------------------

# no sigmoid: the decoded slices leave [0, 1], so the clamp shows
RAW = dict(SMALL, use_sigmoid=False)


@pytest.fixture(scope="module")
def raw_model():
    return ServingModel(AEConfig(**RAW), device="cpu",
                        generator=torch.Generator().manual_seed(3))


def _serve(call, model, vols, labels=None, **kw):
    """The results of ``vols`` through one entry point: ``one``
    (create_super_volume of the first), ``volumes1`` / ``volumes2``
    (create_super_volumes of the first / both: the per-volume and the
    batched path)."""
    if call == "one":
        return [create_super_volume(
            model, vols[0], labels=None if labels is None else labels[0],
            **kw)]
    n = 1 if call == "volumes1" else len(vols)
    return create_super_volumes(
        model, vols[:n], labels_list=None if labels is None else labels[:n],
        **kw)


def _host_clipped(monkeypatch, serve):
    """(raw, want): ``serve()`` with the device's clamp off, and its
    results with each image then clipped on the host, as the port served
    them while the host held the clamp (the class ids as they come)."""
    with monkeypatch.context() as mp:
        mp.setattr(tsv, "clip_with_label_channel", lambda vol, _ids: vol)
        raw = serve()
    return raw, [dict(r, upsampled_image=np.clip(r["upsampled_image"], 0.0,
                                                 1.0)) for r in raw]


def _out_of_range(results):
    return any(((r["upsampled_image"] < 0) | (r["upsampled_image"] > 1)).any()
               for r in results)


CALLS = ["one", "volumes1", "volumes2"]


@pytest.mark.parametrize("call", CALLS)
@pytest.mark.parametrize("latent_interp", ["linear", "lanczos3"])
def test_device_clamp_returns_the_host_clipped_values(raw_model, monkeypatch,
                                                      call, latent_interp):
    vols = [_volume(20 + i) for i in range(2)]

    def serve():
        return _serve(call, raw_model, vols, latent_interp=latent_interp,
                      **INBETWEEN)

    raw, want = _host_clipped(monkeypatch, serve)
    assert _out_of_range(raw)
    got = serve()
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g["upsampled_image"],
                                      w["upsampled_image"])
        np.testing.assert_array_equal(g["pred_alphas"], w["pred_alphas"])


@pytest.mark.parametrize("use_original", [False, True])
def test_combo_volume_is_clamped_on_the_device(monkeypatch, use_original):
    """The AE+CAISR combo, its SR decoder pushed outside [0, 1]: the
    synthesized slices come back clamped, with the values of the host
    clip."""
    from superresolution_aniso_mri_tpu_torch.models import (build_model,
                                                            reset_parameters)
    from superresolution_aniso_mri_tpu_torch.train import Trainer

    trainer = Trainer(dict(model="ae_combined", dataset="OASIS", **RAW,
                           lr=1e-4, seed=0), eval_mode=True, device="cpu")
    sr = build_model("VanillaACAI", trainer.model_config)
    reset_parameters(sr, torch.Generator().manual_seed(4))
    sr.eval().requires_grad_(False)
    decode = sr.decode
    sr.decode = lambda z: 4.0 * decode(z) - 1.5
    trainer.params_sr = sr
    # the primary's predict takes no stride padding: a 32 x 32 in-plane
    img = _volume(30, h=32, w=32)

    def serve():
        return [create_super_volume(trainer, img, use_original=use_original,
                                    **INBETWEEN)]

    raw, want = _host_clipped(monkeypatch, serve)
    assert _out_of_range(raw)
    got = serve()[0]["upsampled_image"]
    np.testing.assert_array_equal(got, want[0]["upsampled_image"])
    assert 0.0 <= got.min() and got.max() <= 1.0


@pytest.mark.parametrize("call", ["one", "volumes2"])
def test_an_out_of_range_verbatim_tail_is_clipped(raw_model, call):
    vols = [_volume(40 + i) for i in range(2)]
    for v in vols:
        v[-1] = np.linspace(-0.5, 1.5, v[-1].size,
                            dtype=np.float32).reshape(v[-1].shape)
    got = _serve(call, raw_model, vols, **INBETWEEN)
    for v, g in zip(vols, got):
        np.testing.assert_array_equal(g["upsampled_image"][-1],
                                      np.clip(v[-1], 0.0, 1.0))


@pytest.mark.parametrize("call", ["one", "volumes2"])
def test_multichannel_class_ids_are_never_clamped(monkeypatch, call):
    model = ServingModel(AEConfig(**RAW, colors=2, nclasses=4), device="cpu",
                         generator=torch.Generator().manual_seed(5),
                         ae_class="MultiChannelAE")
    rng = np.random.RandomState(6)
    vols = [_volume(50 + i) for i in range(2)]
    labels = [rng.randint(0, 4, v.shape) for v in vols]

    def serve():
        # no verbatim tail: every returned slice is read back
        return _serve(call, model, vols, labels=labels, downsample_steps=3,
                      alpha_range=[1 / 3, 2 / 3])

    _, want = _host_clipped(monkeypatch, serve)
    got = serve()
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g["upsampled_image"],
                                      w["upsampled_image"])
        np.testing.assert_array_equal(g["upsampled_labels"],
                                      w["upsampled_labels"])
        # decoded ids above 1 survive: the clamp leaves the id plane alone
        assert g["upsampled_labels"].max() > 1
        # the image plane, read apart from the ids, is an array of its own
        assert g["upsampled_image"].flags.c_contiguous


@pytest.mark.parametrize("call", CALLS)
def test_returned_images_are_arrays_of_their_own(raw_model, call):
    """Float32, C-contiguous and writable; a write into one volume leaves
    the request's other volume and a second request's volumes
    unchanged."""
    vols = [_volume(60 + i) for i in range(2)]
    kw = dict(latent_interp="lanczos3", alpha_range=[0.25, 0.5, 0.75])
    images = [r["upsampled_image"] for _ in range(2)
              for r in _serve(call, raw_model, vols, **kw)]
    for im in images:
        assert im.dtype == np.float32
        assert im.flags.c_contiguous and im.flags.writeable
    before = [im.copy() for im in images]
    images[0][...] = 7.0
    for im, was in zip(images[1:], before[1:]):
        np.testing.assert_array_equal(im, was)


def test_live_bytes_count_an_array_until_its_memory_is_freed():
    """The page-locked budget's count: a tracked array's bytes stay
    counted while the array or a view of it lives."""
    live = tsv._LiveBytes()
    t = torch.zeros(4, 5)
    arr = live.track(t.numpy())
    del t
    assert live.total == 80
    view = arr[1:]
    del arr
    assert live.total == 80
    del view
    assert live.total == 0
    live.track(np.zeros(3, np.float32))
    assert live.total == 0
