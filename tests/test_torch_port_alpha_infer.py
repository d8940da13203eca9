"""PyTorch port: probe-predicted mixes (``infer/alpha_interp.py``),
patch-tiled reconstruction and interpolation (``infer/patches.py``), the
legacy block models (``models/legacy.py``) and the alpha families
through the train command, held against the JAX package on the CPU.

Weights are numpy-seeded trees on ``jax.eval_shape``; the JAX trainers
are built without their ``__init__`` (the attributes their encode,
decode and ``predict_alpha`` read); JAX runs at
``default_matmul_precision("highest")``. Tolerances:

- feature rows: exact;
- ``latent_space_interp_pred_alpha``: the coefficients and the decoded
  slices atol 1e-5;
- ``reconstruct_in_patches`` / ``interpolate_in_patches``: atol 1e-5;
  ``extract_patches`` / ``assemble_patches``: exact;
- ``bilinear_upsample2x``: atol 1e-6 (JAX's formula, term for term);
  legacy forwards (eval mode, and train mode with the moved BatchNorm
  statistics): atol 1e-5;
- the legacy initialisers: the sample standard deviation of a large
  kernel within 3% of flax's, no entry past the truncation.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from superresolution_aniso_mri_tpu.models import AEConfig as JaxConfig
from superresolution_aniso_mri_tpu.models import VanillaACAI as JaxACAI
from superresolution_aniso_mri_tpu.models import (
    make_alpha_probe as jax_make_alpha_probe)
from superresolution_aniso_mri_tpu.train.state import (
    SRTrainState, make_optimizer as jax_make_optimizer)
from superresolution_aniso_mri_tpu.train.steps import (
    LossConfig as JaxLossConfig)
from superresolution_aniso_mri_tpu_torch.models import flax_to_torch
from torch_port_helpers import (numpy_tree,
                                one_torch_thread)  # noqa: F401 (autouse)

CFG = dict(width=16, latent_width=4, depth=4, latent=4, use_batchnorm=True,
           use_sigmoid=True)


def _highest():
    return jax.default_matmul_precision("highest")


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().cpu().numpy().transpose(0, 2, 3, 1)


# ---------------------------------------------------------------------------
# alpha_interp
# ---------------------------------------------------------------------------

def test_feature_rows_match_jax():
    """``synthesize_cardiac_features``, ``create_features`` (and its raise
    for another anatomy) and ``get_alpha_probe_features`` (a batch's
    rows as they are, rows from raw slice metadata, the KeyError without
    either) give JAX's arrays exactly."""
    from superresolution_aniso_mri_tpu.infer import alpha_interp as jai
    from superresolution_aniso_mri_tpu_torch.infer import alpha_interp as pai

    for args in ((0.25, 10, 10.0, 2), (0.0, 9, 6.5, 3), (1.0, 2, 1.0, 1)):
        np.testing.assert_array_equal(pai.synthesize_cardiac_features(*args),
                                      jai.synthesize_cardiac_features(*args))
    fd = {"anatomy": "cardiac", "norm_frame_id": 0.5, "orig_num_slices": 11,
          "spacing": 8.0}
    np.testing.assert_array_equal(pai.create_features(fd, 3),
                                  jai.create_features(fd, 3))
    for mod in (jai, pai):
        with pytest.raises(NotImplementedError, match="brain"):
            mod.create_features({"anatomy": "brain"})
    rng = np.random.RandomState(0)
    batches = [{"alpha_features": rng.rand(3, 5)},
               {"alpha_from": np.zeros(3), "slice_id_from": np.arange(3),
                "slice_id_to": np.arange(3) + 2, "num_slices": np.full(3, 9),
                "frame_id": rng.rand(3)},
               {"slice_id_to": np.array([1, 4]), "spacing": np.ones(2)}]
    for b in batches:
        got = pai.get_alpha_probe_features(fd, b)
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, jai.get_alpha_probe_features(fd, b))
    for mod in (jai, pai):
        with pytest.raises(KeyError, match="alpha_features"):
            mod.get_alpha_probe_features(fd, {"alpha_from": np.zeros(2)})


def _jax_trainer(models, params, stats, loss_cfg):
    """A JAX ``Trainer`` without ``__init__``: what encode, decode,
    predict and predict_alpha read."""
    from superresolution_aniso_mri_tpu.train import Trainer

    t = object.__new__(Trainer)
    t.model = models
    ae = models["ae"] if isinstance(models, dict) else models
    t.model_config = ae.config
    t.loss_config, t.family = loss_cfg, loss_cfg.family
    t.state = SRTrainState.create(apply_fn=ae.apply, params=params,
                                  tx=jax_make_optimizer(lr=1e-5),
                                  batch_stats=stats)
    t.mesh = t.params_sr = t._jit_encode = t._jit_decode = None
    t.args = {"latent": ae.config.latent}
    return t


def _port_trainer(args, params, stats, **cfg):
    from superresolution_aniso_mri_tpu_torch.train import Trainer

    t = Trainer({**args, **CFG, **cfg, "lr": 1e-4}, eval_mode=True,
                device="cpu")
    t.model.load_state_dict(flax_to_torch(params, stats, t.model_config,
                                          t.model))
    return t


@pytest.mark.parametrize("alpha_class", ["AlphaProbe16v1", "AlphaProbe256v1",
                                         "AlphaProbe"])
def test_latent_space_interp_pred_alpha_matches_jax(alpha_class):
    """The probe-predicted mix of 4 adjacent-slice pairs of a 9-slice
    frame at ds 2: the coefficients and the decoded slices."""
    from superresolution_aniso_mri_tpu.infer.alpha_interp import (
        latent_space_interp_pred_alpha as jax_interp)
    from superresolution_aniso_mri_tpu.train.trainer import (
        loss_config_from_args as jax_loss_config)
    from superresolution_aniso_mri_tpu_torch.infer import (
        latent_space_interp_pred_alpha)

    jcfg = JaxConfig(**CFG)
    lw, lat = CFG["latent_width"], CFG["latent"]
    ae = JaxACAI(jcfg)
    probe = jax_make_alpha_probe(alpha_class, jcfg, additional_dims=5,
                                 use_batchnorm=True)
    trees = {"ae": numpy_tree(ae, 0, jnp.zeros((1, 16, 16, 1))),
             "probe": numpy_tree(probe, 1, jnp.zeros((1, lw, lw, 2 * lat)),
                                 jnp.zeros((1, 5)))}
    params = {k: v[0] for k, v in trees.items()}
    stats = {k: v[1] for k, v in trees.items()}
    args = dict(model="alpha_end_to_end", alpha_class=alpha_class,
                use_batchnorm_probe=True, dataset="ACDC", **CFG)
    jt = _jax_trainer({"ae": ae, "probe": probe}, params, stats,
                      jax_loss_config(args))
    pt = _port_trainer(args, params, stats)
    frame = np.random.RandomState(3).rand(9, 16, 16, 1).astype(np.float32)
    kept = frame[::2]
    fd = {"anatomy": "cardiac", "norm_frame_id": 0.25, "orig_num_slices": 9,
          "spacing": 10.0}
    with _highest():
        jdec, jalpha = jax_interp(jt, kept[:-1], kept[1:], 2, fd)
    pdec, palpha = latent_space_interp_pred_alpha(
        pt, _nchw(kept[:-1]), _nchw(kept[1:]), 2, fd)
    assert palpha.shape == (4, pt.num_alphas)
    np.testing.assert_allclose(palpha, jalpha, atol=1e-5)
    np.testing.assert_allclose(_nhwc(pdec), np.asarray(jdec), atol=1e-5)
    with pytest.raises(ValueError, match="feature_dict"):
        latent_space_interp_pred_alpha(pt, _nchw(kept[:-1]),
                                       _nchw(kept[1:]), 2)


# ---------------------------------------------------------------------------
# patches
# ---------------------------------------------------------------------------

def _plain_pair(colors=1, seed=0):
    jcfg = JaxConfig(**{**CFG, "colors": colors})
    ae = JaxACAI(jcfg)
    params, stats = numpy_tree(ae, seed, jnp.zeros((1, 16, 16, colors)))
    args = dict(model="ae_combined", dataset="ACDC", colors=colors)
    jt = _jax_trainer(ae, params, stats, JaxLossConfig(model="ae_combined"))
    return jt, _port_trainer(args, params, stats, colors=colors)


def test_extract_and_assemble_patches_match_jax():
    """The tiling and its inverse are JAX's exactly; a size that is not
    a multiple of the patch raises."""
    from superresolution_aniso_mri_tpu.infer import patches as jp
    from superresolution_aniso_mri_tpu_torch.infer import patches as pp

    vol = np.random.RandomState(1).rand(3, 16, 24).astype(np.float32)
    tiles = pp.extract_patches(torch.from_numpy(vol), 8)
    want = np.asarray(jp.extract_patches(jnp.asarray(vol), 8))
    np.testing.assert_array_equal(_nhwc(tiles), want)
    np.testing.assert_array_equal(
        pp.assemble_patches(tiles[:, 0], 3, 16, 24, 8).numpy(), vol)
    with pytest.raises(ValueError, match="multiples of patch"):
        pp.extract_patches(torch.from_numpy(vol), 5)


@pytest.mark.parametrize("colors", [1, 2])
def test_reconstruct_and_interpolate_in_patches_match_jax(colors):
    """A [3, 16, 32] volume reconstructed in 8² tiles and one slice pair
    interpolated at alpha 0.3 (alpha weights ``img1``); with 2 input
    channels the tiles get a zero plane and a warning, as in JAX."""
    from superresolution_aniso_mri_tpu.infer import patches as jp
    from superresolution_aniso_mri_tpu_torch.infer import (
        interpolate_in_patches, reconstruct_in_patches)

    jt, pt = _plain_pair(colors)
    vol = np.random.RandomState(2).rand(3, 16, 32).astype(np.float32)
    with _highest(), _warns(colors):
        want = jp.reconstruct_in_patches(jt, vol, 8)
        want_i = jp.interpolate_in_patches(jt, vol[0], vol[2], 0.3, 8)
    with _warns(colors):
        got = reconstruct_in_patches(pt, vol, 8)
        got_i = interpolate_in_patches(pt, vol[0], vol[2], 0.3, 8)
    assert got.shape == vol.shape and got_i.shape == vol[0].shape
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-5)
    np.testing.assert_allclose(got_i, np.asarray(want_i), atol=1e-5)


def _warns(colors):
    import contextlib

    return (pytest.warns(UserWarning, match="input channels") if colors > 1
            else contextlib.nullcontext())


def test_patches_with_an_sr_model_raise():
    """``use_sr_model`` routes through the SR model when one is loaded:
    the interpolation equals JAX's with its ``params_sr`` and differs
    from the autoencoder's; a ``params_sr`` that is not a module (JAX's
    (params, batch_stats) pair) raises a TypeError."""
    import copy

    from superresolution_aniso_mri_tpu.infer import patches as jp
    from superresolution_aniso_mri_tpu_torch.infer import (
        interpolate_in_patches)

    jt, pt = _plain_pair()
    img = np.random.RandomState(4).rand(2, 16, 16).astype(np.float32)
    ae_only = interpolate_in_patches(pt, img[0], img[1], 0.5, 8)
    sr_params, sr_stats = numpy_tree(jt._ae_model(), 9,
                                     jnp.zeros((1, 16, 16, 1)))
    jt.params_sr = (sr_params, sr_stats)
    sr = copy.deepcopy(pt._ae_model())
    sr.load_state_dict(flax_to_torch(sr_params, sr_stats, pt.model_config,
                                     sr))
    pt.params_sr = sr
    with _highest():
        want = jp.interpolate_in_patches(jt, img[0], img[1], 0.5, 8)
    got = interpolate_in_patches(pt, img[0], img[1], 0.5, 8)
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-5)
    assert np.abs(got - ae_only).max() > 1e-3
    pt.params_sr = object()
    with pytest.raises(TypeError, match="load_caisr"):
        interpolate_in_patches(pt, img[0], img[1], 0.5, 8)


# ---------------------------------------------------------------------------
# legacy models
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(2, 5, 7, 3), (1, 1, 4, 2), (2, 6, 1, 1)])
def test_bilinear_upsample2x_matches_jax(shape):
    from superresolution_aniso_mri_tpu.models.legacy import (
        bilinear_upsample2x as jax_up)
    from superresolution_aniso_mri_tpu_torch.models import bilinear_upsample2x

    x = np.random.RandomState(sum(shape)).randn(*shape).astype(np.float32)
    np.testing.assert_allclose(_nhwc(bilinear_upsample2x(_nchw(x))),
                               np.asarray(jax_up(x)), atol=1e-6)


LEGACY = {
    "LegacyAE": dict(jax=dict(channel_list=(4, 8), downsample_list=(True,
                                                                    False),
                              latent_dim=6),
                     port=dict(channel_list=(4, 8),
                               downsample_list=(True, False), latent_dim=6)),
    "LegacyAEAdv": dict(jax=dict(channel_list=(4, 8), latent_dim=6,
                                 downsample_list=(True, True),
                                 latent_dim_chan=3),
                        port=dict(channel_list=(4, 8), latent_dim=6,
                                  downsample_list=(True, True),
                                  latent_dim_chan=3)),
    "DiscriminatorSpatial": dict(jax=dict(channel_list=(4, 8),
                                          downsample_list=(True, False)),
                                 port=dict(channel_list=(4, 8),
                                           downsample_list=(True, False),
                                           width=16)),
    "DiscriminatorFakeReal": dict(jax=dict(channel=8, latent_dim_chan=4,
                                           n_res_block=2, n_res_channel=4),
                                  port=dict(channel=8, latent_dim_chan=4,
                                            n_res_block=2, n_res_channel=4)),
}


@pytest.mark.parametrize("name", sorted(LEGACY))
def test_legacy_forward_matches_jax(name):
    """Each legacy class's eval-mode forward (the autoencoders' encode
    and decode too) and, for LegacyAEAdv, its train-mode forward with
    the moved BatchNorm statistics (atol 1e-5)."""
    import superresolution_aniso_mri_tpu.models.legacy as jl
    import superresolution_aniso_mri_tpu_torch.models.legacy as pl
    from superresolution_aniso_mri_tpu_torch.models import torch_to_flax

    spec = LEGACY[name]
    jm = getattr(jl, name)(**spec["jax"])
    params, stats = numpy_tree(jm, 7, jnp.zeros((1, 16, 16, 1)))
    pm = getattr(pl, name)(**spec["port"])
    pm.load_state_dict(flax_to_torch(params, stats, None, pm))
    x = np.random.RandomState(8).rand(3, 16, 16, 1).astype(np.float32)
    v = {"params": params, **({"batch_stats": stats} if stats else {})}
    with _highest():
        want = jm.apply(v, x)
    with torch.no_grad():
        got = pm(_nchw(x))
        got = got.numpy() if got.ndim == 1 else _nhwc(got)
        np.testing.assert_allclose(got, np.asarray(want), atol=1e-5)
        if name.startswith("LegacyAE"):
            with _highest():
                z = jm.apply(v, x, method=jm.encode)
                dec = jm.apply(v, z, method=jm.decode)
            zt = pm.encode(_nchw(x))
            np.testing.assert_allclose(_nhwc(zt), np.asarray(z), atol=1e-5)
            np.testing.assert_allclose(_nhwc(pm.decode(zt)),
                                       np.asarray(dec), atol=1e-5)
        if name == "LegacyAEAdv":
            with _highest():
                want_tr, moved = jm.apply(v, x, train=True,
                                          mutable=["batch_stats"])
            np.testing.assert_allclose(_nhwc(pm(_nchw(x), train=True)),
                                       np.asarray(want_tr), atol=1e-5)
            _, got_stats = torch_to_flax(pm.state_dict())
            jax.tree_util.tree_map(
                lambda a, b: np.testing.assert_allclose(b, np.asarray(a),
                                                        atol=1e-5),
                moved["batch_stats"], got_stats)


def test_legacy_initialisers_are_flax_distributions():
    """``reset_parameters``: the block convs draw flax's
    ``kaiming_normal`` (std sqrt(2 / fan_in), truncated at 2 of the
    underlying normal's standard deviations), the 1x1 projections
    ``lecun_normal`` (std sqrt(1 / fan_in)); biases zero."""
    from superresolution_aniso_mri_tpu_torch.models import (LegacyAEAdv,
                                                            reset_parameters)

    m = LegacyAEAdv(channel_list=(64, 64), downsample_list=(True, True),
                    latent_dim=256, latent_dim_chan=128)
    reset_parameters(m, torch.Generator().manual_seed(0))
    for w, scale in ((m.enc.convs[0].weight.detach(), 2.0),
                     (m.to_latent.weight.detach(), 1.0)):
        fan_in = w.shape[1] * w.shape[2] * w.shape[3]
        std = math.sqrt(scale / fan_in)
        assert abs(float(w.std()) / std - 1.0) < 0.03
        assert float(w.abs().max()) <= 2.0 * std / 0.87962566103423978
    assert all(float(b.abs().max()) == 0 for n, b in m.named_parameters()
               if n.endswith("bias"))


# ---------------------------------------------------------------------------
# the train command
# ---------------------------------------------------------------------------

TINY = ["-d", "MNIST3D", "--use_synthetic_data", "--downsample_steps", "2",
        "--epoch_threshold", "-1", "--width", "16", "--latent_width", "4",
        "--depth", "4", "--latent", "4", "--limited_load", "-b", "4",
        "-bt", "4", "--num_val_batches", "1", "--lr", "1e-4", "-e", "1",
        "--device", "cpu"]


@pytest.mark.parametrize("extra", [
    ["-m", "alpha_end_to_end", "--steps_per_dispatch", "2"],
    ["-m", "alpha_combined", "--alpha_class", "AlphaProbe256v1",
     "--alpha_loss_func", "mse"],
])
def test_train_command_trains_an_alpha_family(extra, tmp_path):
    """``train-brain -m alpha_*`` trains on the sampler's
    ``alpha_features``, logs the probe's metrics, selects
    ``caisr.models`` and writes a checkpoint whose trees are the JAX
    package's ``{"ae", "probe"[, "decoder_mix"]}``."""
    from superresolution_aniso_mri_tpu.train.checkpoint import (
        load_checkpoint_raw as jax_raw)
    from superresolution_aniso_mri_tpu_torch.cli import entry

    tr = entry.train_brain(TINY + extra + ["-o", str(tmp_path), "-id", "a"])
    exper = tmp_path / "a"
    losses = np.load(exper / "losses_train.npz")
    for k in ("loss_latent_1", "loss_latent_2", "pred_alpha_mean",
              "loss_ae_dist_extra", "loss_ae"):
        assert np.isfinite(losses[k]).all(), k
    assert "pred_alphas" in tr.test_predictions
    raw = jax_raw(str(exper / "models" / "caisr.models"))
    want = {"ae", "probe"} | ({"decoder_mix"} if "alpha_combined" in extra
                              else set())
    assert set(raw["model_dict_ae"]) == set(raw["batch_stats"]) == want
