"""PyTorch port, serving and scoring the comparison families: the VAEs,
ACAI, LargerAE and VanillaACAIStrided, held against the JAX package on
the CPU.

``create_super_volume`` of each class against JAX's at atol 1e-5 (the
VAEs serve through the mean: ``encode → heads → mu → unflatten``). JAX's
own ``create_super_volume`` cannot serve a ``VAE2``: its mix broadcasts
the flat [B, K, latent] latent as a conv latent and fails to
concatenate, so the VAE2 reference is built here from the JAX model's
``encode`` / ``heads`` / ``decode`` and the same lerp and interleave. A
VAE serves only volumes whose padded in-plane size is ``--width``.

Then one tiny experiment of each family trained by the port's
``train-brain`` (the JAX CLI test's config: width 32, latent_width 16,
depth 8, latent 8, one epoch): ``find-best-model`` plain and
``--batched`` agree within 1e-4, ``serve-hr-volumes --once`` writes what
``generate-hr-volumes`` writes, and JAX serves the port's checkpoint as
the port does (atol 1e-5).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from superresolution_aniso_mri_tpu.infer.super_volume import (
    create_super_volume as jax_create_super_volume)
from superresolution_aniso_mri_tpu_torch.cli import entry
from superresolution_aniso_mri_tpu_torch.infer import (ServingModel,
                                                       create_super_volume,
                                                       create_super_volumes)
from superresolution_aniso_mri_tpu_torch.models import AEConfig
from superresolution_aniso_mri_tpu_torch.utils import read_image, write_image
from torch_port_helpers import (SMALL, JaxServingStub, jax_family_model,
                                one_torch_thread)  # autouse

ATOL = 1e-5
TINY = ["-d", "MNIST3D", "--use_synthetic_data", "--image_mix_loss_func",
        "mse", "--downsample_steps", "2", "--epoch_threshold", "-1",
        "--width", "32", "--latent_width", "16", "--depth", "8",
        "--latent", "8", "--limited_load", "-b", "8", "-bt", "4",
        "--num_val_batches", "1", "--lr", "1e-4", "-e", "1", "--device",
        "cpu"]
FAMILIES = {
    "acai": ["-m", "acai_combined"],
    "vae": ["-m", "vae_combined"],
    "larger": ["-m", "ae_combined", "--ae_class", "LargerAE"],
    "strided": ["-m", "ae_combined", "--ae_class", "VanillaACAIStrided"],
}


def _highest():
    return jax.default_matmul_precision("highest")


def _volume(seed=0, shape=(9, 32, 32)):
    return np.random.RandomState(seed).rand(*shape).astype(np.float32)


def _vae2_reference(model, params, stats, vol, ds, alphas):
    """The VAE2 volume from the JAX model's pieces: the kept slices'
    means, the lerp of each pair at ``alphas``, decoded with the
    reconstructions and interleaved, clipped (no tail slices: the
    volume's length is 1 + a multiple of ``ds``)."""
    v = {"params": params, "batch_stats": stats}
    kept = vol[::ds][..., None]
    with _highest():
        z = model.apply(v, model.apply(v, kept, method=model.encode),
                        method=model.heads)[0]
        a = jnp.asarray(alphas)[None, :, None]
        mix = a * z[1:, None] + (1.0 - a) * z[:-1, None]
        rec = model.apply(v, z, method=model.decode)[..., 0]
        syn = model.apply(v, mix.reshape(-1, z.shape[-1]),
                          method=model.decode)[..., 0]
    rec, syn = np.asarray(rec), np.asarray(syn).reshape(
        (len(z) - 1, len(alphas)) + rec.shape[1:])
    out = [rec[0]]
    for i in range(len(z) - 1):
        out += list(syn[i]) + [rec[i + 1]]
    return np.clip(np.stack(out), 0.0, 1.0)


@pytest.mark.parametrize("ae_class, opts", [
    ("VAE", dict(downsample_steps=2)),
    ("VAE", dict(downsample_steps=4, latent_interp="cubic")),
    ("VAE2", dict(downsample_steps=2)),
    ("VAE2", dict(downsample_steps=4)),
    ("LargerAE", dict(downsample_steps=2)),
    ("LargerAE", dict(downsample_steps=3, latent_interp="lanczos3",
                      shape=(10, 36, 40))),
    ("VanillaACAIStrided", dict(downsample_steps=2, shape=(9, 30, 44))),
    ("VanillaACAI", dict(downsample_steps=4, wrapped=True)),
])
def test_create_super_volume_matches_jax(ae_class, opts):
    """Each class against JAX (VAE2 against its JAX-piece reference);
    ``wrapped`` serves the ``ae`` of an ACAI ``{'ae', 'disc'}`` tree."""
    opts = dict(opts)
    kw = dict(use_batchnorm=True, use_sigmoid=True)
    model, params, stats = jax_family_model(ae_class, 0, **kw)
    ds = opts.pop("downsample_steps")
    vol = _volume(1, opts.pop("shape", (1 + 2 * ds, 32, 32)))
    tree = (params, stats)
    if opts.pop("wrapped", False):
        _, p_d, s_d = jax_family_model("Discriminator", 1, **kw)
        tree = ({"ae": params, "disc": p_d}, {"ae": stats, "disc": s_d})
    port = ServingModel.from_flax(AEConfig(**SMALL, **kw), *tree,
                                  device="cpu", ae_class=ae_class)
    alphas = (np.arange(1, ds) / ds).tolist()
    got = create_super_volume(port, vol, alpha_range=alphas,
                              downsample_steps=ds,
                              generate_inbetween_slices=True, **opts)
    if ae_class == "VAE2":
        want = _vae2_reference(model, params, stats, vol, ds, alphas)
    else:
        with _highest():
            want = jax_create_super_volume(
                JaxServingStub(model, params, stats), vol,
                alpha_range=alphas, downsample_steps=ds,
                generate_inbetween_slices=True, **opts)["upsampled_image"]
    assert got["upsampled_image"].shape == want.shape
    np.testing.assert_allclose(got["upsampled_image"], want, atol=ATOL)


@pytest.mark.parametrize("ae_class", ["VAE", "VAE2"])
def test_vae_serves_only_its_width(ae_class):
    """A VAE's Dense heads fix the in-plane size: a volume whose padded
    in-plane size is not ``--width`` raises a ValueError that says so,
    from the single and the batched entry points (a 30 x 32 volume pads
    to 32 x 32 and serves)."""
    kw = dict(use_batchnorm=True, use_sigmoid=True)
    _, params, stats = jax_family_model(ae_class, 0, **kw)
    port = ServingModel.from_flax(AEConfig(**SMALL, **kw), params, stats,
                                  device="cpu", ae_class=ae_class)
    for shape in ((5, 36, 40), (5, 64, 64), (5, 16, 32)):
        with pytest.raises(ValueError, match="padded in-plane size is "
                                             "--width"):
            create_super_volume(port, _volume(2, shape), downsample_steps=2)
        with pytest.raises(ValueError, match="--width"):
            create_super_volumes(port, [_volume(2, (5, 32, 32)),
                                        _volume(3, shape)],
                                 downsample_steps=2)
    out = create_super_volume(port, _volume(2, (5, 30, 32)),
                              downsample_steps=2)
    assert out["upsampled_image"].shape == (9, 30, 32)


@pytest.fixture(scope="module")
def exper(tmp_path_factory):
    """{family: a port-trained experiment dir}, plus 'inputs': volumes to
    densify (in-plane 32 x 32, the VAEs' width)."""
    root = tmp_path_factory.mktemp("families")
    out = {}
    for fam, argv in FAMILIES.items():
        entry.train_brain(TINY + argv + ["-o", str(root), "-id", fam])
        out[fam] = str(root / fam)
    inputs = root / "inputs"
    inputs.mkdir()
    rng = np.random.RandomState(0)
    write_image(str(inputs / "a.nii.gz"),
                rng.rand(5, 32, 32).astype(np.float32),
                spacing=(3.0, 1.1, 1.2))
    write_image(str(inputs / "b.nii"),
                (rng.rand(7, 32, 32) * 900 - 100).astype(np.float32),
                spacing=(2.0, 1.0, 1.0))
    out["inputs"] = str(inputs)
    return out


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_family_experiments_serve_and_score_through_the_clis(exper, family,
                                                             tmp_path):
    """find-best-model plain and --batched (the epoch-0 checkpoint, the
    histories within 1e-4), generate-hr-volumes and serve-hr-volumes
    --once (the same volumes) on a port-trained experiment of the
    family."""
    d = exper[family]
    argv = ["--exper_dir", d, "--use_synthetic_data"]
    plain = entry.find_best_model(argv, device="cpu")
    batched = entry.find_best_model(argv + ["--batched"], device="cpu")
    for k, v in plain["history"].items():
        np.testing.assert_allclose(batched["history"][k], v, atol=1e-4,
                                   rtol=0, err_msg=k)
    perf = np.load(os.path.join(d, "model_perf_ds2.npz"))
    np.testing.assert_array_equal(perf["epochs"], [0])
    assert all(np.isfinite(perf[k]).all() for k in perf.files)
    gen, served = tmp_path / "gen", tmp_path / "served"
    entry.generate_hr_volumes(["--exper_dir", d, "--data_input_dir",
                               exper["inputs"], "--output_dir", str(gen)],
                              device="cpu")
    assert entry.serve_hr_volumes(
        ["--exper_dir", d, "--watch_dir", exper["inputs"], "--output_dir",
         str(served), "--once"], device="cpu") == 2
    assert sorted(os.listdir(gen)) == sorted(os.listdir(served)) == [
        "a_ni01.nii.gz", "b_ni01.nii.gz"]
    for name in os.listdir(gen):
        a = read_image(str(gen / name))[0]
        np.testing.assert_array_equal(a, read_image(str(served / name))[0])
        assert np.isfinite(a).all()


@pytest.mark.parametrize("family", ["acai", "vae", "larger", "strided"])
def test_jax_serves_the_port_checkpoint_as_the_port_does(exper, family):
    """The port's caisr.models of each family, read by JAX's checkpoint
    reader (the ACAI tree's ``ae`` selected, as JAX's load_caisr selects
    it) into the model of the settings' ``ae_class``, serves the volume
    the port serves through get_trainer (atol 1e-5)."""
    from superresolution_aniso_mri_tpu.config.settings import load_settings
    from superresolution_aniso_mri_tpu.models import AEConfig as JaxConfig
    from superresolution_aniso_mri_tpu.models import build_model
    from superresolution_aniso_mri_tpu.train.checkpoint import (
        load_checkpoint_raw)
    from superresolution_aniso_mri_tpu_torch.train import get_trainer

    d = exper[family]
    settings = load_settings(os.path.join(d, "settings.yaml"))
    raw = load_checkpoint_raw(os.path.join(d, "models", "caisr.models"))
    params, stats = raw["model_dict_ae"], raw.get("batch_stats", {})
    if family == "acai":
        assert sorted(params) == ["ae", "disc"]
        params, stats = params["ae"], stats["ae"]
    model = build_model(settings["ae_class"], JaxConfig.from_args(settings))
    vol = _volume(4, (9, 32, 32))
    opts = dict(alpha_range=[0.5], downsample_steps=2,
                generate_inbetween_slices=True)
    with _highest():
        want = jax_create_super_volume(JaxServingStub(model, params, stats),
                                       vol, **opts)
    got = create_super_volume(get_trainer(d, "caisr", device="cpu"), vol,
                              **opts)
    np.testing.assert_allclose(got["upsampled_image"],
                               want["upsampled_image"], atol=ATOL)
