"""PyTorch port, augmentation: the random ops of ``data/transforms.py``
held against the JAX package's on the CPU.

``jax.random`` streams cannot be reproduced in torch, so the maps and the
draws are tested apart. Each test recomputes the JAX package's
per-sample draws from a key, split as ``augment_batch`` splits it, and
feeds them to the port's ``apply_augment``: crops, rot90 and mirror are
bitwise equal; intensity, blur and noise (JAX's field) within 1e-6; the
bilinear warps and the whole pipeline within 1e-5. The port's draws are
held against JAX's draw functions by distribution (N >= 2000, fixed
seeds). The per-dataset recipes of ``build_augment_config`` equal JAX's.
"""
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats
import torch

from superresolution_aniso_mri_tpu.cli.train_loop import (
    build_augment_config as jax_build_augment_config)
from superresolution_aniso_mri_tpu.data import (
    AugmentConfig as JaxAugmentConfig, augment_batch as jax_augment_batch)
from superresolution_aniso_mri_tpu.data import transforms as jt
from superresolution_aniso_mri_tpu_torch.cli.train_loop import (
    build_augment_config, epoch_generator)
from superresolution_aniso_mri_tpu_torch.data import (
    AugmentConfig, AugmentParams, apply_augment, augment_batch,
    draw_augment_params)
from superresolution_aniso_mri_tpu_torch.data import transforms as tt

PATCH = 24
ALL_ON = dict(rotate_any=True, max_degree=359, elastic=True,
              perspective=True, blur=True, mirror=True, noise=True)
ALL_FLAGS = ("random_crop", "rot90", "intensity", "rotate_any", "noise",
             "blur", "mirror", "elastic", "perspective",
             "crop_next_to_center")


def _image(b=3, h=32, w=40, c=3, seed=0):
    """[B, H, W, C] smooth-ish random images in [0, 1]."""
    rng = np.random.RandomState(seed)
    x = rng.rand(b, h, w, c).astype(np.float32)
    return 0.5 * x + 0.5 * np.roll(x, 1, axis=1)


def _pre_shape(x, cfg):
    """JAX's pad / aug center crop / pad stage, as augment_batch runs it."""
    x = jnp.asarray(x)
    if cfg.aug_patch_size is not None:
        x = jt._pad_batch_to_at_least(x, cfg.aug_patch_size)
        if x.shape[1] > cfg.aug_patch_size or x.shape[2] > cfg.aug_patch_size:
            x = jt.center_crop(x, cfg.aug_patch_size)
    return jt._pad_batch_to_at_least(x, cfg.patch_size)


def jax_draws(key, cfg: JaxAugmentConfig, b: int, h: int, w: int,
              c: int) -> AugmentParams:
    """The draws of JAX's augment_batch(key, x[B, h, w, c], cfg), per
    sample from the keys it splits (transforms.py:298-331), as the port's
    AugmentParams (noise with JAX's own field)."""
    split = jax.random.split(key, 9 * b)
    keys = split.reshape((9, b) + split.shape[1:])
    p = cfg.patch_size
    if cfg.aug_patch_size is not None:
        h = w = cfg.aug_patch_size
    h, w = max(h, p), max(w, p)
    out = AugmentParams()

    def each(i, fn):
        return [fn(keys[i][s]) for s in range(b)]

    def ints(vals):
        return torch.tensor([int(v) for v in vals], dtype=torch.int64)

    def floats(vals):
        return torch.from_numpy(np.asarray(vals, np.float32))

    if h > p or w > p:
        if cfg.crop_next_to_center:
            mt = cfg.max_translation

            def cnc(k):
                ky, kx = jax.random.split(k)
                dy = jax.random.randint(ky, (), -mt, mt + 1)
                dx = jax.random.randint(kx, (), -mt, mt + 1)
                return (np.clip((h - p) // 2 + int(dy), 0, max(h - p, 0)),
                        np.clip((w - p) // 2 + int(dx), 0, max(w - p, 0)))
            tl = each(0, cnc)
        else:
            def rc(k):
                kh, kw = jax.random.split(k)
                return (jax.random.randint(kh, (), 0, h - p + 1),
                        jax.random.randint(kw, (), 0, w - p + 1))
            tl = each(0, rc)
        out.crop_top = ints([t for t, _ in tl])
        out.crop_left = ints([l for _, l in tl])
    out.rot90_k = ints(each(1, lambda k: jax.random.randint(k, (), 0, 4)))

    def gc(k):
        kg, kc = jax.random.split(k)
        return (jax.random.uniform(kg, (), minval=2.5, maxval=7.5),
                jax.random.uniform(kc, (), minval=0.25, maxval=0.75))
    g = each(2, gc)
    out.gain, out.cutoff = floats([v for v, _ in g]), floats([v for _, v in g])
    out.degrees = ints(each(3, lambda k: jax.random.randint(
        k, (), 0, max(int(cfg.max_degree), 1))))

    def flips(k):
        kh, kv = jax.random.split(k)
        return bool(jax.random.bernoulli(kh)), bool(jax.random.bernoulli(kv))
    f = each(4, flips)
    out.flip_w = torch.tensor([a for a, _ in f])
    out.flip_h = torch.tensor([v for _, v in f])
    out.blur = torch.tensor(each(5, lambda k: bool(jax.random.bernoulli(
        k, 0.5))))

    def noise(k):
        ks, kn = jax.random.split(k)
        return (jax.random.uniform(ks, (), minval=0.0, maxval=0.05),
                np.asarray(jax.random.normal(kn, (p, p, c), jnp.float32)))
    nz = each(6, noise)
    out.noise_sigma = floats([s for s, _ in nz])
    out.noise_field = torch.from_numpy(
        np.stack([f for _, f in nz]).transpose(0, 3, 1, 2).copy())
    out.elastic_field = torch.from_numpy(np.stack(each(7, lambda k: np.asarray(
        jax.random.normal(k, (4, 4, 2)) * cfg.elastic_alpha))).transpose(
            0, 3, 1, 2).copy())
    out.homography = torch.from_numpy(np.stack(each(8, lambda k: np.asarray(
        jnp.eye(3, dtype=jnp.float32) + jax.random.uniform(
            k, (3, 3), jnp.float32, -0.002, 0.002)))))
    return out


def _both(x, flags, key=0, **kw):
    """(JAX augment_batch output, port apply_augment output given JAX's
    draws) as [B, H, W, C] numpy arrays."""
    base = dict(random_crop=False, rot90=False, intensity=False)
    base.update(kw)
    for f in flags:
        base[f] = True
    jcfg, cfg = JaxAugmentConfig(**base), AugmentConfig(**base)
    k = jax.random.PRNGKey(key)
    want = np.asarray(jax_augment_batch(k, jnp.asarray(x), jcfg))
    params = jax_draws(k, jcfg, *x.shape)
    got = apply_augment(torch.from_numpy(x).permute(0, 3, 1, 2), params, cfg)
    return want, got.permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("flags, kw", [
    (("random_crop",), dict(patch_size=PATCH)),
    (("random_crop",), dict(patch_size=PATCH, aug_patch_size=36)),
    (("crop_next_to_center",), dict(patch_size=PATCH, max_translation=6)),
    (("crop_next_to_center",), dict(patch_size=16, max_translation=35)),
    (("rot90",), dict(patch_size=PATCH)),
    (("mirror",), dict(patch_size=PATCH)),
    (("random_crop", "rot90", "mirror"), dict(patch_size=PATCH)),
], ids=["crop", "crop_aug_pad", "next_to_center", "next_to_center_clamped",
        "rot90", "mirror", "crop_rot90_mirror"])
def test_exact_ops_are_bitwise_jax(flags, kw):
    for key in range(3):
        want, got = _both(_image(seed=key), flags, key, **kw)
        assert got.shape == want.shape
        assert np.array_equal(got, want), (flags, key)


@pytest.mark.parametrize("flags", [("intensity",), ("blur",), ("noise",),
                                   ("intensity", "blur", "noise")],
                         ids=["intensity", "blur", "noise", "all_three"])
def test_pointwise_and_blur_ops_match_jax(flags):
    for key in range(3):
        want, got = _both(_image(seed=key), flags, key, patch_size=PATCH)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("flags, kw", [
    (("rotate_any",), dict(max_degree=359)),
    (("rotate_any",), dict(max_degree=45)),
    (("perspective",), {}),
    (("elastic",), {}),
    (("elastic",), dict(elastic_alpha=3.0)),
], ids=["rotate_any_359", "rotate_any_45", "perspective", "elastic",
        "elastic_alpha3"])
def test_bilinear_warps_match_jax(flags, kw):
    for key in range(3):
        want, got = _both(_image(seed=key), flags, key, patch_size=PATCH,
                          **kw)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("size", [(4, 24, 24), (4, 48, 40)])
def test_elastic_field_upsample_matches_jax_image_resize(size):
    g, h, w = size
    coarse = np.random.RandomState(g + h).randn(2, g, g, 2).astype(
        np.float32) * 10
    want = np.stack([np.asarray(jax.image.resize(jnp.asarray(c), (h, w, 2),
                                                 method="bilinear"))
                     for c in coarse])
    got = tt.upsample_field(torch.from_numpy(coarse.transpose(0, 3, 1, 2)
                                             .copy()), h, w)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("kw", [
    dict(patch_size=PATCH, **ALL_ON),
    dict(patch_size=PATCH, aug_patch_size=36, **ALL_ON),
    dict(patch_size=16, crop_next_to_center=True, max_translation=4,
         **ALL_ON),
], ids=["random_crop", "aug_patch", "next_to_center"])
def test_whole_pipeline_matches_jax(kw):
    for key in range(2):
        want, got = _both(_image(seed=key), ("random_crop", "rot90",
                                             "intensity"), key, **kw)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------
# draws, by distribution
# ---------------------------------------------------------------------------

N = 2000


def _port_draws(cfg, h, w, seed=0):
    return draw_augment_params(torch.Generator().manual_seed(seed), cfg, N,
                               h, w)


def _jax_scalar(fn, seed=1):
    keys = jax.random.split(jax.random.PRNGKey(seed), N)
    return np.asarray(jax.vmap(fn)(keys))


def _same_discrete(a, b, support):
    """Chi-square test of two samples over ``support`` (p > 0.001)."""
    table = np.array([[np.sum(np.asarray(a) == v) for v in support],
                      [np.sum(np.asarray(b) == v) for v in support]])
    table = table[:, table.sum(0) > 0]
    assert table.sum() == 2 * N
    p = scipy.stats.chi2_contingency(table)[1]
    assert p > 1e-3, p


def _same_continuous(a, b):
    p = scipy.stats.ks_2samp(np.ravel(a), np.ravel(b)).pvalue
    assert p > 1e-3, p


def test_crop_and_rot90_draws_match_jax_distribution():
    cfg = AugmentConfig(patch_size=PATCH)
    port = _port_draws(cfg, 32, 40)
    _same_discrete(port.crop_top, _jax_scalar(
        lambda k: jax.random.randint(jax.random.split(k)[0], (), 0, 9)),
        range(9))
    _same_discrete(port.crop_left, _jax_scalar(
        lambda k: jax.random.randint(jax.random.split(k)[1], (), 0, 17)),
        range(17))
    _same_discrete(port.rot90_k, _jax_scalar(
        lambda k: jax.random.randint(k, (), 0, 4)), range(4))
    assert port.crop_top.max() == 8 and port.crop_left.max() == 16


def test_crop_next_to_center_draws_keep_the_clamped_border_mass():
    """±35 around the center of a 48-wide window range of 0..8: most of
    the mass piles onto the two clamped borders, as in JAX."""
    cfg = AugmentConfig(patch_size=40, crop_next_to_center=True)
    port = _port_draws(cfg, 48, 48)

    def jax_top(k):
        dy = jax.random.randint(jax.random.split(k)[0], (), -35, 36)
        return jnp.clip(4 + dy, 0, 8)
    ref = _jax_scalar(jax_top)
    _same_discrete(port.crop_top, ref, range(9))
    border = float(np.mean((port.crop_top.numpy() == 0)
                           | (port.crop_top.numpy() == 8)))
    assert abs(border - 64 / 71) < 0.03


def test_continuous_draws_match_jax_distribution():
    cfg = AugmentConfig(patch_size=PATCH, **ALL_ON)
    port = _port_draws(cfg, 32, 32)
    _same_continuous(port.gain, _jax_scalar(lambda k: jax.random.uniform(
        jax.random.split(k)[0], (), minval=2.5, maxval=7.5)))
    _same_continuous(port.cutoff, _jax_scalar(lambda k: jax.random.uniform(
        jax.random.split(k)[1], (), minval=0.25, maxval=0.75)))
    _same_continuous(port.noise_sigma, _jax_scalar(
        lambda k: jax.random.uniform(jax.random.split(k)[0], (),
                                     minval=0.0, maxval=0.05)))
    _same_continuous(port.elastic_field[:, 0, 0, 0], _jax_scalar(
        lambda k: jax.random.normal(k, (4, 4, 2))[0, 0, 0] * 10.0))
    _same_continuous(port.homography[:, 0, 1], _jax_scalar(
        lambda k: jax.random.uniform(k, (3, 3), jnp.float32, -0.002,
                                     0.002)[0, 1]))
    assert torch.all(port.homography[:, 2, 2] - 1 < 0.002)
    _same_discrete(port.degrees, _jax_scalar(
        lambda k: jax.random.randint(k, (), 0, 359)), range(359))


def test_coin_draws_match_jax_distribution():
    cfg = AugmentConfig(patch_size=PATCH, **ALL_ON)
    port = _port_draws(cfg, 24, 24)
    ref = _jax_scalar(lambda k: jax.random.bernoulli(k, 0.5))
    for coin in (port.flip_w, port.flip_h, port.blur):
        _same_discrete(coin, ref, (False, True))


def test_noise_field_is_standard_normal_and_seeded():
    x = torch.full((4, 3, 32, 32), 0.5)
    params = AugmentParams(noise_sigma=torch.full((4,), 0.05), noise_seed=7)
    cfg = AugmentConfig(patch_size=32, random_crop=False, rot90=False,
                        intensity=False, noise=True)
    a, b = apply_augment(x, params, cfg), apply_augment(x, params, cfg)
    assert torch.equal(a, b)
    field = ((a - 0.5) / 0.05).numpy().ravel()
    _same_continuous(field[:N], np.random.RandomState(0).randn(N))


def test_one_seed_gives_the_same_draws():
    cfg = AugmentConfig(patch_size=16, **ALL_ON)
    x = torch.from_numpy(_image(4, 20, 20)).permute(0, 3, 1, 2)
    a = augment_batch(x, cfg, epoch_generator(3, 1))
    b = augment_batch(x, cfg, epoch_generator(3, 1))
    c = augment_batch(x, cfg, epoch_generator(3, 2))
    assert torch.equal(a, b) and not torch.equal(a, c)


# ---------------------------------------------------------------------------
# recipes and edge cases (tests/test_aug_recipe_parity.py,
# tests/test_transforms_fixes.py)
# ---------------------------------------------------------------------------

DATASETS = ("ACDC", "ACDCC", "ACDCLBL", "OASIS", "dHCP", "ADNI", "brainMASI",
            "MNIST3D", "MNISTRoto")
FLAG_SETS = [dict(zip(("rotate_any", "aug_noise", "aug_blur", "get_masks"),
                      bits)) for bits in itertools.product((False, True),
                                                           repeat=4)]


@pytest.mark.parametrize("dataset", DATASETS)
@pytest.mark.parametrize("aug_patch", [None, 180])
def test_build_augment_config_equals_jax(dataset, aug_patch):
    for flags in FLAG_SETS:
        args = dict(dataset=dataset, width=32, aug_patch_size=aug_patch,
                    **flags)
        got = dataclasses_asdict(build_augment_config(dict(args)))
        want = dataclasses_asdict(jax_build_augment_config(dict(args)))
        assert got == want, (dataset, flags)


def dataclasses_asdict(cfg):
    import dataclasses
    return dataclasses.asdict(cfg)


def test_recipes_compose_what_the_reference_clis_compose():
    def cfg(dataset, **over):
        return build_augment_config({"dataset": dataset, "width": 32,
                                     "aug_patch_size": None, **over})
    for dataset in ("ACDC", "ACDCC"):
        c = cfg(dataset)
        assert c.rot90 and c.random_crop and c.intensity
        assert not c.rotate_any and not c.elastic
    oasis = cfg("OASIS")
    assert oasis.rot90 and oasis.random_crop and oasis.intensity
    assert not oasis.crop_next_to_center and not oasis.elastic
    for dataset in ("dHCP", "ADNI", "brainMASI"):
        c = cfg(dataset)
        assert c.crop_next_to_center and c.max_translation == 35
    assert not cfg("ACDCLBL").intensity
    assert not cfg("ACDC", get_masks=True).intensity
    m = cfg("MNIST3D")
    assert not m.random_crop and not m.rot90 and not m.intensity
    assert cfg("ACDC", rotate_any=True).max_degree == 359
    c = cfg("ACDC", aug_noise=True, aug_blur=True)
    assert c.noise and c.blur
    c = cfg("ACDC", aug_noise=True, aug_blur=True, get_masks=True)
    assert not c.noise and not c.blur


@pytest.mark.parametrize("shape", [(2, 128, 216), (2, 100, 140)])
def test_non_square_inputs_land_on_the_square_patch(shape):
    x = torch.rand(shape[0], 3, *shape[1:])
    cfg = AugmentConfig(patch_size=128, rot90=True, intensity=False)
    out = augment_batch(x, cfg, torch.Generator().manual_seed(0))
    assert out.shape == (2, 3, 128, 128)


def test_undersized_inputs_pad_centered():
    x = torch.rand(2, 3, 24, 20)
    cfg = AugmentConfig(patch_size=32, rot90=False, intensity=False,
                        random_crop=False)
    out = augment_batch(x, cfg)
    assert out.shape == (2, 3, 32, 32)
    assert torch.equal(out[:, :, 4:28, 6:26], x)


def test_intensity_before_warp_keeps_borders_black():
    x = torch.full((8, 3, 64, 64), 0.8)
    cfg = AugmentConfig(patch_size=64, rot90=False, random_crop=False,
                        intensity=True, rotate_any=True, max_degree=45)
    out = augment_batch(x, cfg, torch.Generator().manual_seed(0))
    corners = out[:, 0][:, [0, 0, -1, -1], [0, -1, 0, -1]]
    assert (corners == 0.0).any()
    assert torch.all((corners == 0.0) | (corners > 0.5))


def test_rotate_any_zero_degrees_is_identity():
    x = torch.rand(2, 3, 32, 32)
    cfg = AugmentConfig(patch_size=32, rot90=False, random_crop=False,
                        intensity=False, rotate_any=True, max_degree=359)
    params = AugmentParams(degrees=torch.zeros(2, dtype=torch.int64))
    assert torch.equal(apply_augment(x, params, cfg), x)
    cfg0 = AugmentConfig(patch_size=32, rot90=False, random_crop=False,
                         intensity=False, rotate_any=True, max_degree=0)
    assert torch.equal(augment_batch(x, cfg0), x)


def test_missing_params_raise():
    cfg = AugmentConfig(patch_size=16)
    with pytest.raises(ValueError, match="crop_top"):
        apply_augment(torch.rand(2, 3, 20, 20), AugmentParams(), cfg)
