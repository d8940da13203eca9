"""PyTorch port, perceptual distances and MS-SSIM against the JAX
package on the CPU: ``ops/lpips.py`` (VGG16 LPIPS and the resolution of
its weights), ``ops/perceptual.py`` (the encoder-backbone distance over
the shipped artifact), the encoder's feature taps, ``msssim_volume`` and
LPIPS inside ``compute_volume_metrics``.

Inputs come from numpy seeds at 32² (the VGG stack is the cost). JAX
runs at ``jax.default_matmul_precision("highest")``. Tolerances:

- LPIPS, float32: 1e-5 relative (measured ≤ 2.3e-6: the same float32
  convolutions summed in another order); the input gradient 1e-4
  relative to its largest entry;
- LPIPS, bfloat16 VGG stack: 2e-3 relative (measured ~1.5e-4: both
  frameworks round each conv output and its bias add to bfloat16, at
  places that differ by the accumulation order);
- encoder taps and the latent: atol 1e-5; encoder distances 1e-5
  relative (bfloat16 encoder 2e-2);
- MS-SSIM: atol 1e-5 per slice.
"""
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from superresolution_aniso_mri_tpu.evaluate import metrics_driver as jdrv
from superresolution_aniso_mri_tpu.models.acai import Encoder as JaxEncoder
from superresolution_aniso_mri_tpu.ops import lpips as jl
from superresolution_aniso_mri_tpu.ops import metrics as jm
from superresolution_aniso_mri_tpu.ops import perceptual as jp
from superresolution_aniso_mri_tpu_torch.evaluate import (
    compute_volume_metrics, metrics_driver)
from superresolution_aniso_mri_tpu_torch.models import (AEConfig,
                                                        VanillaACAI,
                                                        flax_to_torch)
from superresolution_aniso_mri_tpu_torch.ops import lpips as tl
from superresolution_aniso_mri_tpu_torch.ops import metrics as tmet
from superresolution_aniso_mri_tpu_torch.ops import perceptual as tp
from torch_port_helpers import SMALL, jax_model


def _quiet(fn, *a, **kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return fn(*a, **kw)


@pytest.fixture(scope="module")
def vgg():
    """(JAX params, port params) of the default resolution."""
    return _quiet(jl.get_lpips_params), _quiet(tl.get_lpips_params,
                                               device="cpu")


@pytest.fixture(scope="module")
def enc():
    """(JAX, port) encoder-perceptual artifact: the shipped one."""
    return jp.get_enc_perceptual_params(), tp.get_enc_perceptual_params(
        device="cpu")


def _images(seed, shape=(3, 32, 32, 1)):
    rng = np.random.RandomState(seed)
    a = rng.rand(*shape).astype(np.float32)
    b = np.clip(a + 0.2 * rng.randn(*shape), 0, 1).astype(np.float32)
    return a, b


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _rel(got, want):
    return float(np.abs(np.asarray(got) - np.asarray(want)).max()
                 / np.abs(np.asarray(want)).max())


# ---------------------------------------------------------------------------
# VGG LPIPS
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype, rtol", [("float32", 1e-5),
                                         ("bfloat16", 2e-3)])
@pytest.mark.parametrize("use_lin", [True, False])
def test_lpips_distance_matches_jax(vgg, dtype, rtol, use_lin):
    a, b = _images(0)
    with jax.default_matmul_precision("highest"):
        want = jl.lpips_distance(vgg[0], a, b, use_lin=use_lin,
                                 compute_dtype=dtype)
    got = tl.lpips_distance(vgg[1], _nchw(a), _nchw(b), use_lin=use_lin,
                            compute_dtype=dtype)
    assert got.dtype == torch.float32 and got.shape == (3,)
    assert _rel(got, want) <= rtol


@pytest.mark.parametrize("shape", [(2, 3, 40, 1), (2, 5, 7, 1)])
def test_lpips_thin_inputs_stop_the_stack_like_jax(vgg, shape):
    """Long-axis-thin views stop the VGG stack before a pool would empty
    an axis (3 rows: after slice 1; 5 x 7: after slice 2), finite and
    equal to JAX."""
    a, b = _images(1, shape)
    want = jl.lpips_distance(vgg[0], a, b)
    got = tl.lpips_distance(vgg[1], _nchw(a), _nchw(b))
    assert np.isfinite(got.numpy()).all()
    assert _rel(got, want) <= 1e-5


def test_lpips_grayscale_broadcasts_like_rgb(vgg):
    a, b = _images(2)
    one = tl.lpips_distance(vgg[1], _nchw(a), _nchw(b))
    three = tl.lpips_distance(vgg[1], _nchw(np.repeat(a, 3, -1)),
                              _nchw(np.repeat(b, 3, -1)))
    torch.testing.assert_close(one, three, rtol=1e-6, atol=0)


def test_lpips_input_gradient_matches_jax(vgg):
    """The gradient of the mean distance with respect to the first
    input (what the perceptual loss trains through), finite also on
    all-black inputs (eps inside the sqrt)."""
    a, b = _images(3)
    a[0] = 0.0
    b[0] = 0.0
    with jax.default_matmul_precision("highest"):
        want = jax.grad(lambda x: jl.lpips_loss(vgg[0], x, b))(a)
    x = _nchw(a).requires_grad_(True)
    tl.lpips_loss(vgg[1], x, _nchw(b)).backward()
    got = x.grad.numpy().transpose(0, 2, 3, 1)
    assert np.isfinite(got).all()
    assert _rel(got, want) <= 1e-4


def test_lpips_refuses_the_encoder_artifact_like_jax(vgg, enc):
    a, b = _images(4, (1, 16, 16, 1))
    with pytest.raises(TypeError):
        jl.lpips_distance(enc[0], a, b)
    with pytest.raises(TypeError, match="get_lpips_params"):
        tl.lpips_distance(enc[1], _nchw(a), _nchw(b))


# ---------------------------------------------------------------------------
# weight resolution: modes, warnings, errors
# ---------------------------------------------------------------------------

def _resolve(module, **kw):
    """(params, mode, path, warning messages) of one resolution."""
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        params = module.get_lpips_params(**kw)
    info = module.lpips_weights_info()
    return params, info["mode"], info["path"], [str(w.message) for w in seen]


def _tiny_converted_npz(path):
    """A 'converted' npz: every conv kernel and bias and the lins."""
    rng = np.random.RandomState(5)
    arrays = {}
    cin = 3
    for i, (cout, _) in enumerate(jl._VGG_PLAN):
        arrays[f"conv{i}_kernel"] = (rng.randn(3, 3, cin, cout)
                                     * 0.05).astype(np.float32)
        arrays[f"conv{i}_bias"] = (rng.randn(cout) * 0.01).astype(np.float32)
        cin = cout
    for k, c in enumerate(jl.LPIPS_CHANNELS):
        arrays[f"lin{k}_kernel"] = rng.rand(1, 1, c, 1).astype(np.float32)
    np.savez(path, **arrays)


@pytest.mark.parametrize("mode", ["lin_converted_vgg_random", "converted",
                                  "random"])
def test_get_lpips_params_modes_match_jax(mode, tmp_path, monkeypatch):
    """Each mode resolves the same weights as JAX (distances within
    1e-5), records the same mode and path, and warns the same."""
    kw = {}
    if mode == "converted":
        kw["path"] = str(tmp_path / "vgg.npz")
        _tiny_converted_npz(kw["path"])
    if mode == "random":
        for module in (jl, tl):
            monkeypatch.setattr(module, "_LIN_NPZ", str(tmp_path / "none"))
    monkeypatch.delenv("LPIPS_WEIGHTS", raising=False)
    jparams, jmode, jpath, jwarn = _resolve(jl, **kw)
    tparams, tmode, tpath, twarn = _resolve(tl, device="cpu", **kw)
    assert (tmode, tpath, twarn) == (jmode, jpath, jwarn)
    assert tmode == mode and len(twarn) == (mode != "converted")
    for jc, tc in zip(jparams["convs"], tparams["convs"]):
        np.testing.assert_array_equal(
            tc["kernel"].numpy(), np.transpose(np.asarray(jc["kernel"]),
                                               (3, 2, 0, 1)))
        assert not tc["kernel"].requires_grad
    a, b = _images(6, (2, 16, 16, 1))
    assert _rel(tl.lpips_distance(tparams, _nchw(a), _nchw(b)),
                jl.lpips_distance(jparams, a, b)) <= 1e-5


def test_get_lpips_params_errors_match_jax(tmp_path, monkeypatch):
    """A missing explicit path or $LPIPS_WEIGHTS raises
    FileNotFoundError; an npz of other arrays raises ValueError; an
    explicit path shadows a stale $LPIPS_WEIGHTS."""
    missing = str(tmp_path / "missing.npz")
    bad = str(tmp_path / "bad.npz")
    np.savez(bad, something=np.zeros(3))
    for module, kw in ((jl, {}), (tl, {"device": "cpu"})):
        monkeypatch.delenv("LPIPS_WEIGHTS", raising=False)
        with pytest.raises(FileNotFoundError, match="not found"):
            module.get_lpips_params(path=missing, **kw)
        with pytest.raises(ValueError, match="not an LPIPS weights npz"):
            module.get_lpips_params(path=bad, **kw)
        monkeypatch.setenv("LPIPS_WEIGHTS", missing)
        with pytest.raises(FileNotFoundError, match="LPIPS_WEIGHTS"):
            module.get_lpips_params(**kw)
        _quiet(module.get_lpips_params, path=module._LIN_NPZ, **kw)
        assert module.lpips_weights_info()["mode"] == \
            "lin_converted_vgg_random"


# ---------------------------------------------------------------------------
# encoder taps and the encoder-backbone distance
# ---------------------------------------------------------------------------

def test_encoder_feature_taps_match_jax():
    """``Encoder(return_features=True)``: both post-LeakyReLU convs per
    scale and the pre-head conv, equal to flax's taps; the latent is the
    one without the flag."""
    model, params, stats = jax_model(0)
    cfg = AEConfig(**SMALL)
    port = VanillaACAI(cfg)
    port.load_state_dict(flax_to_torch(params, stats, cfg))
    port.eval()
    x = np.random.RandomState(7).rand(2, 32, 32, 1).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        jz, jfeats = JaxEncoder(model.config).apply(
            {"params": params["enc"], "batch_stats": stats["enc"]}, x,
            train=False, return_features=True)
    with torch.no_grad():
        z, feats = port.enc(_nchw(x), return_features=True)
        torch.testing.assert_close(z, port.enc(_nchw(x)), rtol=0, atol=0)
    assert len(feats) == len(jfeats) == 2 * cfg.scales + 1
    np.testing.assert_allclose(z.numpy().transpose(0, 2, 3, 1),
                               np.asarray(jz), atol=1e-5)
    for got, want in zip(feats, jfeats):
        np.testing.assert_allclose(got.numpy().transpose(0, 2, 3, 1),
                                   np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("dtype, rtol", [("float32", 1e-5),
                                         ("bfloat16", 2e-2)])
def test_enc_distance_on_the_shipped_artifact_matches_jax(enc, dtype, rtol):
    a, b = _images(8)
    assert enc[1]["cfg"] == AEConfig(**{
        k: getattr(enc[0]["cfg"], k) for k in tp._CFG_KEYS})
    with jax.default_matmul_precision("highest"):
        want = jp.enc_lpips_distance(enc[0], a, b, compute_dtype=dtype)
    got = tp.enc_lpips_distance(enc[1], _nchw(a), _nchw(b),
                                compute_dtype=dtype)
    assert _rel(got, want) <= rtol
    np.testing.assert_allclose(float(tp.enc_perceptual_loss(
        enc[1], _nchw(a), _nchw(b))), float(jnp.mean(
            jp.enc_lpips_distance(enc[0], a, b))), rtol=1e-5)


def test_enc_feature_diff_vectors_match_jax_and_the_distance(enc):
    a, b = _images(9)
    with jax.default_matmul_precision("highest"):
        want = jp.enc_feature_diff_vectors(enc[0], a, b)
    got = tp.enc_feature_diff_vectors(enc[1], _nchw(a), _nchw(b))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-9)
    lins = torch.cat(enc[1]["lins"])
    torch.testing.assert_close(got @ lins, tp.enc_lpips_distance(
        enc[1], _nchw(a), _nchw(b)), rtol=1e-5, atol=0)


def test_enc_artifact_written_by_jax_loads_in_the_port(tmp_path):
    """``save_enc_perceptual`` of JAX → ``load_enc_perceptual`` of the
    port (and the port's writer → JAX's reader) with uniform lins: the
    same config, lins and distances; the encoder state is frozen."""
    model, params, stats = jax_model(1)
    jcfg = model.config
    variables = {"params": params["enc"], "batch_stats": stats["enc"]}
    lins = jp.uniform_lins(jcfg)
    assert [x.tolist() for x in tp.uniform_lins(AEConfig(**SMALL))] == \
        [x.tolist() for x in lins]
    jpath, tpath = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    jp.save_enc_perceptual(jpath, jcfg, variables, lins, meta={"m": 1})
    tp.save_enc_perceptual(tpath, AEConfig(**SMALL), variables, lins,
                           meta={"m": 1})
    a, b = _images(10)
    for path in (jpath, tpath):
        port = tp.get_enc_perceptual_params(path, device="cpu")
        ref = jp.load_enc_perceptual(path)
        assert port["meta"] == ref["meta"] == {"m": 1}
        assert all(not t.requires_grad for t in port["variables"].values())
        with jax.default_matmul_precision("highest"):
            want = jp.enc_lpips_distance(ref, a, b)
        assert _rel(tp.enc_lpips_distance(port, _nchw(a), _nchw(b)),
                    want) <= 1e-5


def test_missing_enc_artifact_raises_like_jax(tmp_path, monkeypatch):
    monkeypatch.setenv("SR_PERCEPTUAL_ENC", str(tmp_path / "none.npz"))
    with pytest.raises(FileNotFoundError, match="fit_perceptual_head"):
        jp.get_enc_perceptual_params()
    with pytest.raises(FileNotFoundError, match="fit_perceptual_head"):
        tp.get_enc_perceptual_params(device="cpu")


# ---------------------------------------------------------------------------
# MS-SSIM
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape, win, levels", [((3, 128, 120), 7, 5),
                                                ((4, 64, 64), 7, 3),
                                                ((2, 97, 83), 5, 4),
                                                ((2, 64, 64), 11, 1)])
def test_msssim_volume_matches_jax(shape, win, levels):
    rng = np.random.RandomState(11)
    a = rng.rand(*shape).astype(np.float32)
    b = np.clip(a + 0.1 * rng.randn(*shape), 0, 1).astype(np.float32)
    b[0] = 1.0 - a[0]           # anti-correlated: negative cs terms clamp
    want = jm.msssim_volume(a, b, 1.0, win, levels)
    got = tmet.msssim_volume(torch.from_numpy(a), torch.from_numpy(b), 1.0,
                             win, levels)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    np.testing.assert_allclose(float(tmet.msssim2d(
        torch.from_numpy(a[1]), torch.from_numpy(b[1]), 1.0, win, levels)),
        float(want[1]), atol=1e-5)


def test_msssim_refuses_too_many_levels_like_jax():
    a = np.zeros((1, 64, 64), np.float32)
    with pytest.raises(ValueError, match="at most 4 dyadic levels"):
        jm.msssim_volume(a, a, 1.0, 7, 5)
    with pytest.raises(ValueError, match="at most 4 dyadic levels"):
        tmet.msssim_volume(torch.from_numpy(a), torch.from_numpy(a), 1.0, 7,
                           5)


# ---------------------------------------------------------------------------
# LPIPS scoring
# ---------------------------------------------------------------------------

def test_lpips_scoring_in_chunks_equals_one_call(vgg, monkeypatch):
    """Slices scored in chunks of 2 (a budget of 2 slices' features)
    equal one call over the volume, and both equal JAX's whole-volume
    call; a data range of 255 divides first."""
    rng = np.random.RandomState(12)
    a = rng.rand(7, 24, 28).astype(np.float32)
    b = np.clip(a + 0.1 * rng.randn(7, 24, 28), 0, 1).astype(np.float32)
    up, ref = torch.from_numpy(b), torch.from_numpy(a)
    one = metrics_driver.lpips_volume(vgg[1], up, ref)
    monkeypatch.setattr(metrics_driver, "LPIPS_CHUNK_BYTES",
                        metrics_driver._lpips_slice_bytes(24, 28) * 2)
    chunked = metrics_driver.lpips_volume(vgg[1], up, ref)
    torch.testing.assert_close(chunked, one, rtol=1e-6, atol=0)
    want = jdrv.compute_volume_metrics(a * 255, b * 255, downsample_steps=2,
                                       lpips_params=vgg[0], data_range=255.0)
    got = compute_volume_metrics(a * 255, b * 255, downsample_steps=2,
                                 lpips_params=vgg[1], data_range=255.0,
                                 device="cpu")
    for key in ("lpips", "lpips_synth"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-5,
                                   err_msg=key)
