"""PyTorch port, the train commands on on-disk datasets (the README's
production recipes at a tiny size) on the CPU: train-brain on a
fabricated OASIS tree with its random recipe (crop, rot90, intensity),
train-cardiac on an ACDC tree with ``--train_latent_interp lanczos3``,
the same losses from the same seed, and find-best-model on the OASIS
experiment against the JAX package's sweep of the same directory.

Tiny config: width 16, latent_width 8, depth 8, latent 8, 2 epochs,
``--aug_patch_size 24`` (the fabricated trees are 24 px in-plane),
``--epoch_threshold -1`` (numbered checkpoints for find-best).
"""
import os
import shutil
import sys

import jax
import numpy as np
import pytest
import torch

from superresolution_aniso_mri_tpu.cli import entry as jentry
from superresolution_aniso_mri_tpu_torch.cli import entry

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))
import dress_rehearsal  # noqa: E402

COMMON = ["-m", "ae_combined", "--image_mix_loss_func", "mse",
          "--epoch_threshold", "-1", "--width", "16", "--latent_width", "8",
          "--depth", "8", "--latent", "8", "-b", "4", "-bt", "4",
          "--num_val_batches", "2", "--lr", "1e-3", "-e", "2",
          "--aug_patch_size", "24", "--device", "cpu"]
OASIS = ["-d", "OASIS", "--downsample_steps", "3"] + COMMON
ACDC = ["-d", "ACDC", "--downsample_steps", "2",
        "--train_latent_interp", "lanczos3", "--ex_loss_weight1", "0.05",
        "--volume_preview_interval", "0"] + COMMON


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """{'root': data root, 'out': experiments dir}: OASIS and ACDC trees,
    one OASIS and one ACDC experiment trained by the port."""
    root = tmp_path_factory.mktemp("disk")
    data = str(root / "data")
    dress_rehearsal.make_oasis_tree(data, ds=3, n_patients=5)
    dress_rehearsal.make_acdc_tree(data, n_patients=4)
    old = os.environ.get("SR_DATA_ROOT")
    os.environ["SR_DATA_ROOT"] = data
    out = str(root / "expers")
    entry.train_brain(OASIS + ["-o", out, "-id", "oasis"])
    entry.train_cardiac(ACDC + ["-o", out, "-id", "acdc"])
    yield {"root": data, "out": out}
    if old is None:
        del os.environ["SR_DATA_ROOT"]
    else:
        os.environ["SR_DATA_ROOT"] = old


@pytest.mark.parametrize("exper", ["oasis", "acdc"])
def test_train_commands_write_the_experiment_files(trained, exper):
    d = os.path.join(trained["out"], exper)
    assert sorted(os.listdir(os.path.join(d, "models"))) == [
        "0.models", "1.models", "ae.models", "caisr.models", "last.models"]
    assert {"settings.yaml", "loss_iters.npz", "losses_train.npz",
            "losses_test.npz"} <= set(os.listdir(d))
    assert os.listdir(os.path.join(d, "log_images"))
    with np.load(os.path.join(d, "losses_train.npz")) as f:
        loss = f["loss_ae"]
    assert loss.shape == (2,) and np.isfinite(loss).all()
    from superresolution_aniso_mri_tpu_torch.config import load_settings

    settings = load_settings(os.path.join(d, "settings.yaml"))
    assert settings["dataset"] == exper.upper()
    assert settings["aug_patch_size"] == 24


def test_same_seed_gives_the_same_losses(trained, tmp_path):
    entry.train_brain(OASIS + ["-o", str(tmp_path), "-id", "again"])
    for npz in ("losses_train.npz", "losses_test.npz"):
        with np.load(os.path.join(trained["out"], "oasis", npz)) as a, \
                np.load(os.path.join(str(tmp_path), "again", npz)) as b:
            assert sorted(a.files) == sorted(b.files)
            for k in a.files:
                assert np.array_equal(a[k], b[k]), (npz, k)


def test_another_seed_draws_other_augmentations(trained, tmp_path):
    entry.train_brain(OASIS + ["-o", str(tmp_path), "-id", "other", "-s",
                               "7"])
    with np.load(os.path.join(trained["out"], "oasis",
                              "losses_train.npz")) as a, \
            np.load(os.path.join(str(tmp_path), "other",
                                 "losses_train.npz")) as b:
        assert not np.array_equal(a["loss_ae"], b["loss_ae"])


def test_find_best_model_on_the_oasis_experiment_matches_jax(trained,
                                                             tmp_path):
    """find-best-model loads the OASIS validation split from disk, as
    JAX's does (cli/entry.py:522), and scores every checkpoint of the
    port-trained directory within 1e-4 of the JAX sweep of it."""
    exper = str(tmp_path / "exper")
    shutil.copytree(os.path.join(trained["out"], "oasis"), exper)
    npz = os.path.join(exper, "model_perf_ds3.npz")
    with jax.default_matmul_precision("highest"):
        want_res = jentry.find_best_model(["--exper_dir", exper])
    want = dict(np.load(npz))
    os.remove(npz)
    got_res = entry.find_best_model(["--exper_dir", exper], device="cpu")
    got = dict(np.load(npz))
    np.testing.assert_array_equal(got["epochs"], [0, 1])
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=1e-4, rtol=0,
                                   err_msg=k)
    assert {k: v["epoch"] for k, v in got_res["best"].items()} == {
        k: v["epoch"] for k, v in want_res["best"].items()}


def test_resumed_epoch_redraws_its_augmentation_stream(trained, tmp_path,
                                                      monkeypatch):
    """--auto_resume from epoch 0's checkpoint reruns epoch 1 with the
    augmentation draws of the uninterrupted run's epoch 1 (the generator
    is seeded from (seed, epoch); the sampler's order is not restored,
    as in the JAX package)."""
    from superresolution_aniso_mri_tpu_torch.data import transforms

    draws = []
    draw = transforms.draw_augment_params

    def recording(*a, **kw):
        params = draw(*a, **kw)
        if params.crop_top is not None:
            draws.append((params.crop_top, params.rot90_k, params.gain))
        return params

    monkeypatch.setattr(transforms, "draw_augment_params", recording)
    entry.train_brain(OASIS + ["-o", str(tmp_path), "-id", "full"])
    full, draws[:] = list(draws), []
    models = tmp_path / "full" / "models"
    shutil.copy(models / "0.models", models / "last.models")
    entry.train_brain(OASIS + ["-o", str(tmp_path), "-id", "full",
                               "--auto_resume"])
    assert draws and len(full) == 2 * len(draws)
    for got, want in zip(draws, full[len(draws):]):
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert not all(torch.equal(g, w) for g, w in zip(full[0], draws[0]))
