"""PyTorch port, the fitted latent tap table against the JAX package on
the CPU: ``infer/latent_taps.py::fit_latent_taps`` (the Adam fit of the
[A, 6] table through the frozen decoder), ``save_latent_taps`` and the
``fit-latent-taps`` command.

Both fits take the same numpy-seeded weights (``torch_port_helpers``;
the JAX side is its ``Trainer`` without the eager flax init) and the
same toy volumes, and draw the same batches from
``np.random.RandomState(seed)``. JAX runs at ``default_matmul_precision
("highest")``. Tolerances: the table within 1e-4 after 10 steps,
``loss_init`` and ``loss_final`` (holdout MSEs) rtol 1e-4.
"""
import os

import jax
import numpy as np
import pytest
import torch

from superresolution_aniso_mri_tpu.data import make_toy_dataset
from superresolution_aniso_mri_tpu.infer.latent_taps import (
    fit_latent_taps as jax_fit, load_latent_taps as jax_load,
    save_latent_taps as jax_save)
from superresolution_aniso_mri_tpu_torch.cli import entry
from superresolution_aniso_mri_tpu_torch.infer import ServingModel
from superresolution_aniso_mri_tpu_torch.infer.latent_taps import (
    fit_latent_taps, load_latent_taps, save_latent_taps)
from superresolution_aniso_mri_tpu_torch.models import AEConfig, flax_to_torch
from superresolution_aniso_mri_tpu_torch.ops import lanczos3_weights
from torch_port_helpers import SMALL, jax_model, jax_trainer

OFFSETS = (-2, -1, 0, 1, 2, 3)
TINY = ["-d", "MNIST3D", "--use_synthetic_data", "-m", "ae_combined",
        "--image_mix_loss_func", "mse", "--downsample_steps", "3",
        "--epoch_threshold", "-1", "--width", "32", "--latent_width", "16",
        "--depth", "8", "--latent", "8", "--limited_load", "-b", "8",
        "-bt", "4", "--num_val_batches", "1", "--lr", "1e-4", "-e", "1"]


@pytest.fixture(scope="module")
def pair():
    """(JAX trainer, port ServingModel) with the same weights."""
    model, params, stats = jax_model(5)
    jt = jax_trainer(model, params, stats, dict(model="ae_combined"),
                     lr=1e-4)
    port = ServingModel(AEConfig(**SMALL),
                        flax_to_torch(params, stats, AEConfig(**SMALL)),
                        device="cpu")
    return jt, port


def _lanczos3(alphas):
    return lanczos3_weights(torch.from_numpy(np.asarray(alphas,
                                                        np.float32))).numpy()


def test_fit_matches_jax(pair):
    jt, port = pair
    vols = make_toy_dataset(2, 32, 13, seed=11)
    kw = dict(steps=10, lr=0.02, batch_pairs=4, seed=0, l2_to_init=0.5)
    with jax.default_matmul_precision("highest"):
        want = jax_fit(jt, vols, 3, **kw)
    got = fit_latent_taps(port, vols, 3, **kw)
    assert (got["n_pairs"], got["n_holdout"]) == (want["n_pairs"],
                                                  want["n_holdout"]) == (8, 2)
    np.testing.assert_array_equal(got["alphas"], want["alphas"])
    np.testing.assert_array_equal(got["offsets"], want["offsets"])
    np.testing.assert_allclose(got["weights"], want["weights"], atol=1e-4)
    for k in ("loss_init", "loss_final"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=k)
    assert got["loss_final"] < got["loss_init"]
    assert not np.allclose(got["weights"], _lanczos3(got["alphas"]))


def test_fit_never_ships_worse_than_init(pair):
    """A diverging fit (absurd lr) returns the analytic lanczos3 rows."""
    _, port = pair
    vols = make_toy_dataset(1, 32, 13, seed=13)
    res = fit_latent_taps(port, vols, 3, steps=8, lr=1e3, batch_pairs=4,
                          seed=0)
    assert res["loss_final"] == res["loss_init"]
    np.testing.assert_allclose(res["weights"], _lanczos3(res["alphas"]),
                               atol=1e-6)


def test_fit_handles_ragged_inplane_shapes(pair, capsys):
    """Mixed in-plane sizes fit on the dominant shape, with a warning."""
    _, port = pair
    vols = make_toy_dataset(2, 32, 13, seed=29)
    odd = make_toy_dataset(1, 48, 13, seed=31)
    res = fit_latent_taps(port, vols + odd, 3, steps=4, batch_pairs=4,
                          seed=0)
    assert res["n_pairs"] == 2 * 4
    assert "ragged" in capsys.readouterr().out


def test_table_round_trips_through_both_packages(tmp_path):
    """The port's file reads back in the port and in JAX, with the alpha
    0/1 boundary rows added; JAX's file reads in the port."""
    alphas = np.array([1 / 3, 2 / 3], np.float32)
    w = np.random.RandomState(0).rand(2, 6).astype(np.float32)
    ours, theirs = str(tmp_path / "a.npz"), str(tmp_path / "b.npz")
    save_latent_taps(ours, OFFSETS, alphas, w, meta={"downsample_steps": 3})
    jax_save(theirs, OFFSETS, alphas, w, meta={"downsample_steps": 3})
    tables = [load_latent_taps(ours), jax_load(ours), load_latent_taps(theirs)]
    for t in tables:
        assert sorted(t) == ["alphas", "meta_downsample_steps", "offsets",
                             "weights"]
        np.testing.assert_array_equal(t["alphas"], [0, *alphas, 1])
        np.testing.assert_array_equal(t["weights"][1:3], w)
        np.testing.assert_array_equal(t["weights"][0], [0, 0, 1, 0, 0, 0])
        np.testing.assert_array_equal(t["weights"][3], [0, 0, 0, 1, 0, 0])
        for k in t:
            np.testing.assert_array_equal(t[k], tables[0][k])
    with pytest.raises(ValueError, match="pair taps"):
        save_latent_taps(ours, (-1, 0, 2), alphas, w[:, :3])


def test_fit_latent_taps_cli_writes_a_table_the_port_serves(tmp_path):
    """``fit-latent-taps`` on a port experiment writes
    ``models/latent_taps.npz`` with its metadata, and
    ``generate-hr-volumes --latent_interp fitted`` serves it."""
    from superresolution_aniso_mri_tpu_torch.utils import (read_image,
                                                           write_image)

    entry.train_brain(TINY + ["-o", str(tmp_path), "-id", "x", "--device",
                              "cpu"])
    exper = str(tmp_path / "x")
    res = entry.fit_latent_taps(["--exper_dir", exper, "--model_nbr", "0",
                                 "--steps", "6", "--batch_pairs", "4"],
                                device="cpu")
    table = load_latent_taps(os.path.join(exper, "models", "latent_taps.npz"))
    assert int(table["meta_downsample_steps"]) == 3
    assert str(table["meta_model_nbr"]) == "0"
    assert table["weights"].shape == (4, 6)
    assert res["loss_final"] <= res["loss_init"]
    inputs, out = tmp_path / "in", tmp_path / "out"
    inputs.mkdir()
    write_image(str(inputs / "v.nii.gz"),
                np.random.RandomState(1).rand(4, 32, 32).astype(np.float32),
                spacing=(3.0, 1.0, 1.0))
    entry.generate_hr_volumes(["--exper_dir", exper, "--model_nbr", "0",
                               "--data_input_dir", str(inputs),
                               "--output_dir", str(out),
                               "--num_interpolations", "2",
                               "--latent_interp", "fitted"], device="cpu")
    vol, spacing, _ = read_image(str(out / "v_ni02.nii.gz"))
    assert vol.shape == (10, 32, 32) and np.isfinite(vol).all()
    np.testing.assert_allclose(spacing[0], 1.0, rtol=1e-6)
