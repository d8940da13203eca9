"""PyTorch port, scoring layer: SSIM / PSNR / VIF, the slice masks and
compute_volume_metrics against the JAX package on the CPU (the CUDA
kernel's own check is tests/test_torch_port_cuda.py).

Inputs come from numpy seeds: smooth images (gaussian-filtered noise)
and a noisy copy, in [0, 1]. Tolerances: per-slice SSIM within 1e-5 of
both the JAX XLA version and the Pallas kernel run in interpret mode
(the bound the JAX package holds its own kernel to); PSNR within 1e-4
dB; VIF within 1e-5 relative (float32 sums in another order over
log10 terms). At the dHCP recipe's 256², the port's synthesized-slice
SSIM and VIF stay within SSIM64_ATOL / VIF64_ATOL of float64.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.ndimage
import torch

from superresolution_aniso_mri_tpu.evaluate import metrics_driver as jdrv
from superresolution_aniso_mri_tpu.ops import metrics as jm
from superresolution_aniso_mri_tpu.ops.pallas_kernels import (
    ssim_volume_pallas)
from superresolution_aniso_mri_tpu_torch.evaluate import (
    IdUniquifier, aggregate_metrics, compute_volume_metrics)
from superresolution_aniso_mri_tpu_torch.ops import cuda_kernels
from superresolution_aniso_mri_tpu_torch.ops import metrics as tm
from torch_port_float64 import ssim64, vif64

SSIM64_ATOL, VIF64_ATOL = 2e-7, 3e-6


def _pair(seed=1, shape=(4, 30, 34), noise=0.05):
    rng = np.random.RandomState(seed)
    a = scipy.ndimage.gaussian_filter(rng.rand(*shape), (0, 1.5, 1.5))
    a = ((a - a.min()) / (a.max() - a.min())).astype(np.float32)
    b = np.clip(a + noise * rng.rand(*shape), 0, 1).astype(np.float32)
    return a, b


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _flat_patch_pair():
    """Flat patches shared by both images (0.35, 0.9 and 0 areas), a
    textured corner, and an all-zero slice."""
    a, b = _pair(8, shape=(3, 30, 34))
    a[:, :10], b[:, :10] = 0.9, 0.9
    a[:, 10:20, :12], b[:, 10:20, :12] = 0.35, 0.35
    a[:, :, 26:], b[:, :, 26:] = 0.0, 0.0
    a[0], b[0] = 0.0, 0.0
    return a, b


@pytest.mark.parametrize("win, case", [
    (3, "smooth"), (5, "smooth"), (7, "smooth"), (11, "smooth"),
    (7, "flat_patch"), (11, "flat_patch"),
    (3, "win_sized"), (5, "win_sized"), (7, "win_sized"), (11, "win_sized"),
], ids=["3", "5", "7", "11", "flat_patch-7", "flat_patch-11", "win_sized-3",
        "win_sized-5", "win_sized-7", "win_sized-11"])
def test_ssim_matches_jax_and_pallas_interpret(win, case):
    if case == "flat_patch":
        a, b = _flat_patch_pair()
    elif case == "win_sized":   # h = w = win: a 1 x 1 map per slice
        a, b = _pair(9, shape=(4, win, win))
    else:
        a, b = _pair()
        a[1] = 0.5       # a flat slice: the E[x^2] - mu^2 form at its limit
        b[1] = 0.5
    want = np.asarray(jm.ssim_volume(jnp.asarray(a), jnp.asarray(b), 1.0,
                                     win))
    pallas = np.asarray(ssim_volume_pallas(jnp.asarray(a), jnp.asarray(b),
                                           1.0, win, interpret=True))
    got = tm.ssim_volume(_t(a), _t(b), 1.0, win).numpy()
    assert got.shape == a.shape[:1] and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-5)
    np.testing.assert_allclose(got, pallas, atol=1e-5)
    fused = cuda_kernels.ssim_volume_fused(_t(a), _t(b), 1.0, win).numpy()
    np.testing.assert_array_equal(fused, got)
    np.testing.assert_allclose(float(tm.ssim2d(_t(a[0]), _t(b[0]), 1.0, win)),
                               want[0], atol=1e-5)


def test_ssim_data_range_matches_jax():
    a, b = _pair(2)
    want = np.asarray(jm.ssim_volume(jnp.asarray(a * 255), jnp.asarray(b * 255),
                                     255.0, 7))
    got = tm.ssim_volume(_t(a * 255), _t(b * 255), 255.0, 7).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_psnr_matches_jax_including_identical_slice():
    a, b = _pair(3)
    b[2] = a[2]          # mse 0 → +inf on both sides
    want = np.asarray(jm.psnr_volume(jnp.asarray(a), jnp.asarray(b)))
    got = tm.psnr_volume(_t(a), _t(b)).numpy()
    assert np.isinf(got[2]) and np.isinf(want[2])
    np.testing.assert_allclose(got, want, atol=1e-4)
    np.testing.assert_allclose(float(tm.psnr2d(_t(a[0]), _t(b[0]))), want[0],
                               atol=1e-4)


def test_vif_matches_jax_uniform_slice_is_nan():
    a, b = _pair(4, shape=(3, 40, 36), noise=0.1)
    a[1] = 0.3           # uniform reference slice: den == 0 → NaN
    want = np.asarray(jm.vif_volume(jnp.asarray(a), jnp.asarray(b)))
    got = tm.vif_volume(_t(a), _t(b)).numpy()
    assert np.isnan(got[1]) and np.isnan(want[1])
    np.testing.assert_allclose(got, want, rtol=1e-5)
    np.testing.assert_allclose(
        float(tm.vif2d(_t(a[0]), _t(b[0]))),
        float(jm.vif2d(jnp.asarray(a[0]), jnp.asarray(b[0]))), rtol=1e-5)


@pytest.mark.parametrize("n, sigma", [(30, 1.0), (17, 3.4), (5, 1.8)])
def test_gaussian_filter_matches_jax_and_scipy(n, sigma):
    x = np.random.RandomState(5).rand(2, n, n + 3).astype(np.float32)
    want = np.asarray(jm.gaussian_filter2d(jnp.asarray(x), sigma))
    got = tm.gaussian_filter2d(_t(x), sigma).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)
    ref = scipy.ndimage.gaussian_filter(x.astype(np.float64),
                                        (0, sigma, sigma), mode="reflect")
    np.testing.assert_allclose(got, ref, atol=1e-5)


@pytest.mark.parametrize("s, ds, conv", [(31, 6, False), (14, 3, False),
                                         (17, 4, True), (5, 1, False)])
def test_synth_slice_mask_matches_jax(s, ds, conv):
    np.testing.assert_array_equal(tm.synth_slice_mask(s, ds, conv),
                                  jm.synth_slice_mask(s, ds, conv))


def test_masked_mean_drops_nonfinite_and_nans_on_empty():
    v = np.array([1.0, np.nan, 3.0, np.inf], np.float32)
    for mask in ([True, True, True, True], [False, True, False, True],
                 [True, False, False, False]):
        want = float(jm.masked_mean(jnp.asarray(v), np.array(mask)))
        got = float(tm.masked_mean(_t(v), np.array(mask)))
        np.testing.assert_equal(got, want)
    assert np.isnan(float(tm.masked_mean(_t(v), np.zeros(4, bool))))


@pytest.mark.parametrize("kw", [
    dict(downsample_steps=3),
    dict(downsample_steps=4, conv_interpol=True),
    dict(),
    dict(eval_axis=1),     # thin long-axis view: 14 x 34 slices, win 7
    dict(eval_axis=2, data_range=2.0),
])
def test_compute_volume_metrics_matches_jax(kw):
    a, b = _pair(6, shape=(14, 30, 34))
    a[:, :3] = 0.0       # black rows → all-black slices on eval_axis=1
    want = jdrv.compute_volume_metrics(a, b, **kw)
    got = compute_volume_metrics(a, b, device="cpu", **kw)
    assert got.keys() == want.keys()
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-5,
                                   atol=1e-6, err_msg=key)


def test_compute_volume_metrics_window_shrinks_on_very_thin_views():
    """Views thinner than 8 shrink the SSIM window (5, then 3); below 3
    SSIM is NaN like the reference."""
    for s in (6, 4, 2):
        a, b = _pair(7, shape=(s, 24, 20))
        want = jdrv.compute_volume_metrics(a, b, eval_axis=1)
        got = compute_volume_metrics(a, b, eval_axis=1, device="cpu")
        for key in want:
            np.testing.assert_allclose(got[key], want[key], rtol=1e-5,
                                       atol=1e-6, err_msg=f"{s} {key}")


def test_lpips_scoring_matches_jax():
    """compute_volume_metrics with LPIPS weights (it raised before the
    LPIPS port): 'lpips' and 'lpips_synth' within 1e-5 relative of JAX,
    every other key as without them."""
    import warnings

    from superresolution_aniso_mri_tpu.ops import lpips as jl
    from superresolution_aniso_mri_tpu_torch.ops import lpips as tl

    a, b = _pair(shape=(7, 32, 36))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jp, tp = jl.get_lpips_params(), tl.get_lpips_params(device="cpu")
    want = jdrv.compute_volume_metrics(a, b, downsample_steps=3,
                                       lpips_params=jp)
    got = compute_volume_metrics(a, b, downsample_steps=3, lpips_params=tp,
                                 device="cpu")
    assert list(got) == list(want)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-5,
                                   atol=1e-6, err_msg=key)


def test_aggregate_and_uniquifier_match_jax():
    per_volume = [{"ssim": 0.5, "vif": float("nan")},
                  {"ssim": 0.7, "vif": float("nan")},
                  {"ssim": float("inf"), "vif": float("nan")}]
    got = aggregate_metrics(per_volume)
    want = jdrv.aggregate_metrics(per_volume)
    np.testing.assert_equal(got, want)
    t, j = IdUniquifier(), jdrv.IdUniquifier()
    for pid in ("a", "b", "a", "a", 7, "7"):
        assert t.take(pid) == j.take(pid)


def test_ssim_kernel_wrapper_rejects_cpu_and_bad_inputs():
    a, b = _pair()
    with pytest.raises(ValueError, match="CUDA"):
        cuda_kernels.ssim_volume_cuda(_t(a), _t(b))
    with pytest.raises(ValueError, match="device"):
        cuda_kernels.ssim_volume_fused(_t(a).to("meta"), _t(b).to("meta"))


def test_build_path_depends_on_source_and_flags():
    from superresolution_aniso_mri_tpu_torch.ops import _build

    p1 = _build.library_path("ssim", ("-fmad=false",))
    p2 = _build.library_path("ssim")
    assert p1 != p2 and p1.parent == _build.BUILD_DIR
    assert p1.name.startswith("libssim_") and p1.suffix == ".so"


def test_recipe_scale_scores_track_float64():
    """The dHCP recipe's conventional scoring at 256², ds 4 (a tree
    phantom, its thick-slice LR, bspline through-plane): the port's
    float32 SSIM and VIF of the synthesized slices sit within
    ``SSIM64_ATOL`` / ``VIF64_ATOL`` of their float64 values, closer
    than JAX's float32 (whose SSIM reads ~1e-6 low and VIF ~1e-5 high:
    the fifth decimal of a recorded JAX row can differ from the port's
    by one unit, and then the port's is the float64 one)."""
    from superresolution_aniso_mri_tpu_torch.data.synthetic import \
        make_textured_rotated_volume
    from superresolution_aniso_mri_tpu_torch.data.volume import (
        rescale_intensities, simulate_thick_slices)
    from superresolution_aniso_mri_tpu_torch.infer.super_volume import \
        create_simple_interpolation

    s, ds = 9, 4
    hr = make_textured_rotated_volume(size=256, num_slices=s,
                                      seed=10_021).image
    lr = rescale_intensities(simulate_thick_slices(hr, float(ds)),
                             percs=(0, 100))
    hr = rescale_intensities(hr, percs=(0, 100)).astype(np.float32)
    up = np.clip(create_simple_interpolation(lr[::ds], ds,
                                             method="bspline")[:s],
                 0, 1).astype(np.float32)
    synth = tm.synth_slice_mask(s, ds)
    for name, f64, jfn, pfn, atol in (
            ("ssim", ssim64, jm.ssim_volume, tm.ssim_volume, SSIM64_ATOL),
            ("vif", vif64, jm.vif_volume, tm.vif_volume, VIF64_ATOL)):
        want = f64(hr.astype(np.float64), up.astype(np.float64))[synth].mean()
        port = float(pfn(_t(hr), _t(up)).numpy()[synth].mean())
        jax_ = float(np.asarray(jfn(jnp.asarray(hr),
                                    jnp.asarray(up)))[synth].mean())
        assert abs(port - want) <= atol, (name, port - want)
        assert abs(port - want) < abs(jax_ - want), (name, port - want,
                                                     jax_ - want)
