"""PyTorch port, the AE+CAISR combo (S3): ``Trainer.load_caisr`` from
the three checkpoint formats, SR-routed ``encode`` / ``decode`` /
``predict``, the combo branch of ``create_super_volume(s)`` (the SR model
synthesizes, the primary reconstructs), its per-model synthesis cores,
fit-latent-taps through the SR model, and an eval-mode trainer of a
``perceptual_enc`` experiment without the encoder artifact (item 19).
Held against the JAX package on the CPU: weights from numpy-seeded
trees on ``jax.eval_shape`` (``torch_port_helpers``), JAX at
``default_matmul_precision("highest")``. Tolerances: latents and served
volumes atol 1e-5 (decoded labels exact); the tap table atol 1e-5.
"""
import os
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from superresolution_aniso_mri_tpu.infer import (
    create_super_volume as jax_create_super_volume)
from superresolution_aniso_mri_tpu.train import checkpoint as jckpt
from superresolution_aniso_mri_tpu_torch.infer import (create_super_volume,
                                                       create_super_volumes)
from superresolution_aniso_mri_tpu_torch.models import flax_to_torch
from superresolution_aniso_mri_tpu_torch.train import Trainer
from torch_port_helpers import (SMALL, jax_eval_trainer, jax_family_model,
                                jax_train_state,
                                one_torch_thread)  # noqa: F401 (autouse)

MC = dict(colors=2, nclasses=4, use_batchnorm=True)
# the JAX AEConfig's defaults, which the settings of a trainer spell out
NET = dict(SMALL, use_batchnorm=True, use_sigmoid=True)
ARGS = {"plain": dict(model="ae_combined", dataset="OASIS"),
        "multichannel": dict(model="multichannel_combined",
                             dataset="ACDCLBL", **MC)}
CLASSES = {"plain": ("VanillaACAI", {}), "multichannel": ("MultiChannelAE",
                                                         MC)}
DS = 2


def _highest():
    return jax.default_matmul_precision("highest")


def _jax_trainer(kind, seed):
    ae_class, kw = CLASSES[kind]
    return jax_eval_trainer(*jax_family_model(ae_class, seed, **kw),
                            family="multichannel" if kind == "multichannel"
                            else "ae")


def _port_trainer(kind, seed):
    ae_class, kw = CLASSES[kind]
    _, params, stats = jax_family_model(ae_class, seed, **kw)
    t = Trainer({**ARGS[kind], **NET, "lr": 1e-4}, eval_mode=True,
                device="cpu")
    t.model.load_state_dict(flax_to_torch(params, stats, t.model_config,
                                          t.model))
    return t


def _pair(kind, seed=0):
    """(JAX trainer, port trainer) with the same primary weights."""
    return _jax_trainer(kind, seed), _port_trainer(kind, seed)


def _load_sr(jt, pt, kind, sr_seed, tmp):
    """The same SR weights in both: JAX's as its (params, batch_stats),
    the port's through ``load_caisr`` of JAX's ``SRTPU1`` file."""
    ae_class, kw = CLASSES[kind]
    model, params, stats = jax_family_model(ae_class, sr_seed, **kw)
    jt.params_sr = (params, stats)
    path = os.path.join(tmp, f"sr_{kind}_{sr_seed}.models")
    jckpt.save_checkpoint(path, jax_train_state(model, params, stats,
                                                lr=1e-4), 3)
    pt.load_caisr(path)


def _volume(seed=0, s=9, hw=32):
    rng = np.random.RandomState(seed)
    base = rng.rand(s, hw, hw).astype(np.float32)
    return np.clip(base + 0.1 * np.roll(base, 1, axis=0), 0, 1) / 1.1


def _labels(seed=0, s=9, hw=32):
    return np.random.RandomState(seed + 50).randint(0, 4, (s, hw, hw))


def _serve(jt, pt, kind, **kw):
    img = _volume(1)
    lbl = _labels(1) if kind == "multichannel" else None
    kw = dict(alpha_range=[0.5], downsample_steps=DS,
              generate_inbetween_slices=True, labels=lbl, **kw)
    with _highest():
        want = jax_create_super_volume(jt, img, **kw)
    got = create_super_volume(pt, img, **kw)
    return got, want


def _assert_volumes(got, want):
    np.testing.assert_allclose(got["upsampled_image"],
                               np.asarray(want["upsampled_image"]),
                               atol=1e-5)
    if want["upsampled_labels"] is None:
        assert got["upsampled_labels"] is None
    else:
        np.testing.assert_array_equal(got["upsampled_labels"],
                                      want["upsampled_labels"])


# ---------------------------------------------------------------------------
# load_caisr and the SR-routed encode / decode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("source", ["srtpu1", "family", "reference_torch"])
def test_load_caisr_encodes_like_jax(source, tmp_path):
    """``load_caisr`` of an ``SRTPU1`` file of a bare AE, of an ACAI
    family checkpoint (its ``ae`` subtree) and of a reference torch
    pickle: ``encode`` / ``decode(use_sr_model=True)`` equal JAX's after
    its ``load_caisr`` of the same file, and differ from the primary's."""
    from superresolution_aniso_mri_tpu_torch.train.export_torch import (
        save_reference_checkpoint)

    jt, pt = _pair("plain")
    sr = _port_trainer("plain", seed=7)
    path = str(tmp_path / "sr.models")
    if source == "srtpu1":
        sr.save_models(path, 4)
    elif source == "family":
        fam = Trainer({**ARGS["plain"], **NET, "lr": 1e-4,
                       "model": "acai_combined"}, device="cpu")
        fam.model["ae"].load_state_dict(sr.model.state_dict())
        fam.save_models(path, 4)
    else:
        save_reference_checkpoint(path, sr.model)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")   # the stem-geometry note
        with _highest():
            jt.load_caisr(path)
        pt.load_caisr(path)
    x = _volume(2, s=3)[:, None]
    with _highest():
        want_z = np.asarray(jt.encode(jnp.asarray(x.transpose(0, 2, 3, 1)),
                                      use_sr_model=True))
        want_x = np.asarray(jt.decode(jnp.asarray(want_z),
                                      use_sr_model=True))
    got_z = pt.encode(x, use_sr_model=True).numpy()
    np.testing.assert_allclose(got_z, want_z.transpose(0, 3, 1, 2),
                               atol=1e-5)
    got_x = pt.decode(got_z, use_sr_model=True).numpy()
    np.testing.assert_allclose(got_x, want_x.transpose(0, 3, 1, 2),
                               atol=1e-5)
    assert np.abs(pt.encode(x).numpy() - got_z).max() > 1e-3
    assert not pt.params_sr.training
    assert all(not p.requires_grad for p in pt.params_sr.parameters())


def test_use_sr_model_without_an_sr_model_is_the_autoencoder():
    _, pt = _pair("plain")
    x = _volume(3, s=2)[:, None]
    assert torch.equal(pt.predict(x, use_sr_model=True), pt.predict(x))


# ---------------------------------------------------------------------------
# the combo's synthesis
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("use_original", [False, True])
@pytest.mark.parametrize("kind", ["plain", "multichannel"])
def test_combo_volume_matches_jax(kind, use_original, tmp_path):
    """The SR model synthesizes, the primary reconstructs (or the kept
    slices stay): the served volume (and a MultiChannelAE's decoded
    labels) equal JAX's combo."""
    jt, pt = _pair(kind)
    _load_sr(jt, pt, kind, 5, tmp_path)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        got, want = _serve(jt, pt, kind, use_original=use_original)
    _assert_volumes(got, want)


@pytest.mark.parametrize("kind", ["plain", "multichannel"])
def test_combo_uses_the_sr_core_not_a_cached_autoencoder_core(kind,
                                                             tmp_path):
    """Serve without an SR model (the autoencoder's core is cached), load
    one, serve again, then load another: each served volume equals
    JAX's for the weights loaded then, so the synthesized slices follow
    each SR model and the reconstructed ones stay the primary's."""
    jt, pt = _pair(kind)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ae_only, want = _serve(jt, pt, kind)
        _assert_volumes(ae_only, want)
        served = []
        for sr_seed in (5, 6):
            _load_sr(jt, pt, kind, sr_seed, tmp_path)
            got, want = _serve(jt, pt, kind)
            _assert_volumes(got, want)
            served.append(got["upsampled_image"])
    synth = np.arange(ae_only["upsampled_image"].shape[0]) % DS == 1
    for vol in served:
        assert np.abs(vol[synth] - ae_only["upsampled_image"][synth]).max() \
            > 1e-3
        np.testing.assert_allclose(vol[~synth],
                                   ae_only["upsampled_image"][~synth],
                                   atol=1e-6)
    assert np.abs(served[0][synth] - served[1][synth]).max() > 1e-3
    # the first SR model's cores went with it
    assert [k[0] for k in pt.synth_cache
            if k[0] is not pt._ae_model()] == [pt.params_sr]


def test_combo_batched_volumes_take_the_per_volume_path(tmp_path):
    """``create_super_volumes`` serves the combo volume by volume, equal
    to single calls; the chunked reconstruction (a decode budget smaller
    than the kept stack) equals the unchunked one."""
    jt, pt = _pair("plain")
    _load_sr(jt, pt, "plain", 5, tmp_path)
    vols = [_volume(1), _volume(2)]
    kw = dict(alpha_range=[0.5], downsample_steps=DS,
              generate_inbetween_slices=True)
    batched = create_super_volumes(pt, vols, **kw)
    for vol, got in zip(vols, batched):
        single = create_super_volume(pt, vol, **kw)
        np.testing.assert_array_equal(got["upsampled_image"],
                                      single["upsampled_image"])
        chunked = create_super_volume(pt, vol, decode_batch=2, **kw)
        np.testing.assert_allclose(chunked["upsampled_image"],
                                   single["upsampled_image"], atol=1e-6)


# ---------------------------------------------------------------------------
# fit-latent-taps through the SR model
# ---------------------------------------------------------------------------

def test_fit_latent_taps_fits_through_the_sr_model(tmp_path):
    """With an SR model loaded, the tap table is fitted through it, as
    JAX's ``fit_latent_taps`` fits through ``params_sr``."""
    from superresolution_aniso_mri_tpu.data import Volume as JaxVolume
    from superresolution_aniso_mri_tpu.infer.latent_taps import (
        fit_latent_taps as jax_fit)
    from superresolution_aniso_mri_tpu_torch.data import Volume
    from superresolution_aniso_mri_tpu_torch.infer import fit_latent_taps

    jt, pt = _pair("plain")
    _load_sr(jt, pt, "plain", 5, tmp_path)
    imgs = [_volume(11, s=13), _volume(12, s=13)]
    kw = dict(steps=12, batch_pairs=4, seed=3)
    with _highest():
        want = jax_fit(jt, [JaxVolume(image=v, spacing=np.ones(3))
                            for v in imgs], 4, **kw)
    got = fit_latent_taps(pt, [Volume(image=v, spacing=np.ones(3))
                               for v in imgs], 4, **kw)
    np.testing.assert_allclose(got["weights"], np.asarray(want["weights"]),
                               atol=1e-5)
    assert got["loss_init"] == pytest.approx(float(want["loss_init"]),
                                             rel=1e-4)
    pt.params_sr = None
    ae_fit = fit_latent_taps(pt, [Volume(image=v, spacing=np.ones(3))
                                  for v in imgs], 4, **kw)
    assert ae_fit["loss_init"] != pytest.approx(got["loss_init"], rel=1e-3)


# ---------------------------------------------------------------------------
# item 19: an eval-mode trainer resolves no loss weights
# ---------------------------------------------------------------------------

def test_perceptual_enc_experiment_serves_without_the_encoder_artifact(
        tmp_path, monkeypatch):
    """``get_trainer`` on a ``perceptual_enc`` experiment with
    ``$SR_PERCEPTUAL_ENC`` pointing at a missing file serves the volume
    it serves with the artifact present, and keeps the experiment's
    ``lpips_mode``."""
    from superresolution_aniso_mri_tpu_torch.config import load_settings
    from superresolution_aniso_mri_tpu_torch.ops import perceptual
    from superresolution_aniso_mri_tpu_torch.train import get_trainer

    args = dict(ARGS["plain"], **NET, lr=1e-4, epochs=1,
                image_mix_loss_func="perceptual_enc",
                output_dir=str(tmp_path / "exp"))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        tr = Trainer(args, device="cpu")
    tr.prepare_run()
    tr.save_models(os.path.join(tr.dir_models, "caisr.models"), 1)
    saved = load_settings(str(tmp_path / "exp" / "settings.yaml"))
    assert saved["lpips_mode"] == "encoder_backbone"
    img = _volume(4)
    kw = dict(alpha_range=[0.5], downsample_steps=DS,
              generate_inbetween_slices=True)
    with_artifact = create_super_volume(
        get_trainer(str(tmp_path / "exp"), "caisr", device="cpu"), img, **kw)
    monkeypatch.setenv("SR_PERCEPTUAL_ENC", str(tmp_path / "missing.npz"))
    with pytest.raises(FileNotFoundError):
        perceptual.get_enc_perceptual_params(device="cpu")
    served = get_trainer(str(tmp_path / "exp"), "caisr", device="cpu")
    assert served.lpips_params is None
    assert served.args["lpips_mode"] == "encoder_backbone"
    got = create_super_volume(served, img, **kw)
    np.testing.assert_array_equal(got["upsampled_image"],
                                  with_artifact["upsampled_image"])
