"""PyTorch port, the conventional interpolation baselines and
``create_hr_images``' baselines and LPIPS scoring against the JAX
package on the CPU.

The baselines are host numpy and scipy code copied from the JAX
package: they are held bitwise. ``create_hr_images`` scores on the CPU:
per-volume metrics within 1e-4 (SSIM, PSNR, VIF, MSE; the JAX SSIM is
its XLA version) and LPIPS within 1e-5 relative, with the same
``lpips_mode``, npz files and saved volumes.
"""
import os
import warnings

import jax
import numpy as np
import pytest

from superresolution_aniso_mri_tpu import infer as jinfer
from superresolution_aniso_mri_tpu.data import Volume as JaxVolume
from superresolution_aniso_mri_tpu.evaluate import (
    create_hr_images as jax_create)
from superresolution_aniso_mri_tpu.infer import super_volume as jsv
from superresolution_aniso_mri_tpu.ops import lpips as jl
from superresolution_aniso_mri_tpu.ops import perceptual as jp
from superresolution_aniso_mri_tpu_torch import infer as tinfer
from superresolution_aniso_mri_tpu_torch.data import Volume
from superresolution_aniso_mri_tpu_torch.evaluate import (FILTER_BENCH,
                                                          create_hr_images)
from superresolution_aniso_mri_tpu_torch.infer import super_volume as tsv
from superresolution_aniso_mri_tpu_torch.ops import lpips as tl
from superresolution_aniso_mri_tpu_torch.ops import perceptual as tp
from superresolution_aniso_mri_tpu_torch.utils import read_image
from torch_port_helpers import serving_pair

METHODS = ("nearest", "linear", "bspline", "lanczos")


def _volume(seed, shape):
    rng = np.random.RandomState(seed)
    z = np.linspace(0, 1, shape[0])[:, None, None]
    base = np.sin(3 * z + rng.rand(1, *shape[1:]) * 2.0)
    return np.clip(0.5 + 0.4 * base + 0.05 * rng.randn(*shape),
                   0, 1).astype(np.float32)


# ---------------------------------------------------------------------------
# the baselines themselves, bitwise
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("method", METHODS)
def test_interp_weights_are_bitwise_jax(method):
    frac = np.arange(12, dtype=np.float64) / 4 % 1.0
    for got, want in zip(tsv._interp_weights(method, frac),
                         jsv._interp_weights(method, frac)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="unknown interpolation"):
        tsv._interp_weights("cubic", frac)


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("shape, factor", [((5, 12, 10), 3),
                                           ((9, 8, 7), 2), ((4, 6, 6), 6)])
def test_simple_interpolation_is_bitwise_jax(method, shape, factor):
    vol = _volume(0, shape)
    got = tinfer.simple_interpolation(vol, factor, method)
    want = jinfer.simple_interpolation(vol, factor, method)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("slices, ds", [(13, 3), (14, 3), (10, 2), (7, 6)])
def test_create_simple_interpolation_is_bitwise_jax(method, slices, ds):
    """In-between-slices mode (tails kept verbatim) and the plain
    expansion, at slice counts with and without a remainder."""
    vol = _volume(1, (slices, 9, 11))
    for inbetween in (True, False):
        got = tinfer.create_simple_interpolation(
            vol, ds, method, generate_inbetween_slices=inbetween)
        want = jinfer.create_simple_interpolation(
            vol, ds, method, generate_inbetween_slices=inbetween)
        assert got.shape == want.shape
        np.testing.assert_array_equal(got, want)


def test_blur_and_rescale_are_bitwise_jax():
    vol = _volume(2, (4, 20, 18)) * 3.0 - 1.0
    for sigma in (0.5, 1.0, 2.5):
        np.testing.assert_array_equal(tinfer.apply_blur_filter(vol, sigma),
                                      jsv.apply_blur_filter(vol, sigma))
    for v in (vol, np.full((2, 3, 3), 0.7, np.float32)):
        np.testing.assert_array_equal(tinfer.rescale_volume(v),
                                      jsv.rescale_volume(v))


# ---------------------------------------------------------------------------
# create_hr_images: baselines and LPIPS
# ---------------------------------------------------------------------------

def _volumes(cls):
    """Two 3D volumes (one with a slice remainder at ds 2) and a 4D one."""
    a, b = _volume(3, (9, 32, 36)), _volume(4, (10, 32, 36))
    return [cls(image=a, spacing=np.array([2.0, 1.0, 1.0]), patient_id="a"),
            cls(image=b, spacing=np.array([2.0, 1.0, 1.0]), patient_id="b"),
            cls(image=np.stack([a, a[::-1]]), spacing=np.array([2.0, 1, 1]),
                patient_id="cine")]


def _assert_same_scores(got, want, lpips_rtol=1e-5):
    assert list(got["per_volume"]) == list(want["per_volume"])
    for pid, m in want["per_volume"].items():
        assert list(got["per_volume"][pid]) == list(m)
        for k, v in m.items():
            if k.startswith("lpips"):
                np.testing.assert_allclose(got["per_volume"][pid][k], v,
                                           rtol=lpips_rtol, err_msg=k)
            else:
                np.testing.assert_allclose(got["per_volume"][pid][k], v,
                                           atol=1e-4, err_msg=f"{pid} {k}")
    assert got.get("lpips_mode") == want.get("lpips_mode")


@pytest.mark.parametrize("method", FILTER_BENCH)
def test_create_hr_images_baselines_match_jax(method, tmp_path):
    """Each baseline without a trainer: the same scores, npz and saved
    volumes (clipped to [0, 1]) as JAX."""
    want = jax_create(None, _volumes(JaxVolume), 2, str(tmp_path / "jax"),
                      interpol_method=method, save_volumes=True)
    got = create_hr_images(None, _volumes(Volume), 2, str(tmp_path / "port"),
                           interpol_method=method, save_volumes=True,
                           device="cpu")
    _assert_same_scores(got, want)
    name = os.path.join("results", f"{method}_2x.npz")
    g, w = np.load(tmp_path / "port" / name), np.load(tmp_path / "jax" / name)
    assert sorted(g.files) == sorted(w.files)
    np.testing.assert_array_equal(g["patient_ids"], w["patient_ids"])
    for pid, suffix in (("a", f"{method}_2x"), ("b", f"{method}_2x"),
                        ("cine", f"4d_{method}_2x")):
        rel = os.path.join(pid, f"{pid}_{suffix}.nii.gz")
        gv, wv = (read_image(str(tmp_path / side / rel))[0]
                  for side in ("port", "jax"))
        np.testing.assert_array_equal(gv, wv)
        assert 0.0 <= gv.min() and gv.max() <= 1.0


def _quiet(fn, *a, **kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return fn(*a, **kw)


def _pair_with(lpips_params=None, mode=None):
    """(JAX stand-in trainer, port ServingModel) with the same weights,
    their ``args`` and, given, the trainer's LPIPS weights and mode."""
    jt, pt = serving_pair(0)
    for t, lp in zip((jt, pt), lpips_params or (None, None)):
        t.args = {"model": "ae_combined"}
        if lp is not None:
            t.lpips_params = lp
            t.args["lpips_mode"] = mode
    return jt, pt


@pytest.mark.parametrize("source", ["resolved", "trainer", "baseline"])
def test_create_hr_images_lpips_matches_jax(source, tmp_path):
    """``compute_percept_metrics``: LPIPS with the trainer's weights and
    recorded mode, else resolved with ``get_lpips_params`` (also for a
    baseline without a trainer); the mode goes into the result and the
    npz."""
    method = "linear" if source == "baseline" else "model"
    if source == "baseline":
        jt = pt = None
    elif source == "trainer":
        jt, pt = _pair_with((_quiet(jl.get_lpips_params),
                             _quiet(tl.get_lpips_params, device="cpu")),
                            "converted-by-trainer")
    else:
        jt, pt = _pair_with()
    with jax.default_matmul_precision("highest"):
        want = _quiet(jax_create, jt, _volumes(JaxVolume)[:2], 2,
                      str(tmp_path / "jax"), interpol_method=method,
                      compute_percept_metrics=True)
    got = _quiet(create_hr_images, pt, _volumes(Volume)[:2], 2,
                 str(tmp_path / "port"), interpol_method=method,
                 compute_percept_metrics=True, device="cpu")
    _assert_same_scores(got, want)
    assert got["lpips_mode"] == ("converted-by-trainer"
                                 if source == "trainer"
                                 else "lin_converted_vgg_random")
    name = os.path.join("results", f"{method}_2x.npz")
    g, w = np.load(tmp_path / "port" / name), np.load(tmp_path / "jax" / name)
    assert sorted(g.files) == sorted(w.files)
    assert str(g["lpips_mode"]) == str(w["lpips_mode"]) == got["lpips_mode"]


def test_create_hr_images_with_a_perceptual_enc_trainer_raises_like_jax():
    """A ``perceptual_enc`` trainer's ``lpips_params`` is the encoder
    artifact, which the VGG LPIPS of the scoring refuses: JAX raises
    TypeError (the artifact is not an array tree), and so does the
    port."""
    jt, pt = _pair_with((jp.get_enc_perceptual_params(),
                         tp.get_enc_perceptual_params(device="cpu")),
                        "encoder_backbone")
    with pytest.raises(TypeError):
        jax_create(jt, _volumes(JaxVolume)[:1], 2,
                   compute_percept_metrics=True)
    with pytest.raises(TypeError, match="get_lpips_params"):
        create_hr_images(pt, _volumes(Volume)[:1], 2,
                         compute_percept_metrics=True, device="cpu")
