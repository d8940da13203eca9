"""PyTorch port, reference-format torch checkpoints against the JAX
package on the CPU: ``train/import_torch.py`` (reading the reference's
``nn.Sequential`` ``.models`` pickles), ``train/export_torch.py``
(writing them) and the ``convert-reference-checkpoint`` /
``export-reference-checkpoint`` commands.

No reference file is downloaded: the files are written by JAX's and the
port's exporters from numpy-seeded weights (``torch_port_helpers``), as
``tests/test_export_torch.py`` does. Tolerances: a JAX-exported file
loads in the port with the same tensors (bitwise) and a forward within
1e-5 of JAX's at ``default_matmul_precision("highest")``; the port's
file loads in JAX's importer with identical parameters; export → import
is bitwise.
"""
import os
import shutil

import jax
import numpy as np
import pytest
import torch

from superresolution_aniso_mri_tpu.train.export_torch import (
    save_reference_checkpoint as jax_save_reference)
from superresolution_aniso_mri_tpu.train.import_torch import (
    load_torch_reference as jax_load_reference)
from superresolution_aniso_mri_tpu_torch.cli import entry
from superresolution_aniso_mri_tpu_torch.models import (AEConfig, VanillaACAI,
                                                        flax_to_torch)
from superresolution_aniso_mri_tpu_torch.models.convert import torch_to_flax
from superresolution_aniso_mri_tpu_torch.train import (get_trainer,
                                                       load_checkpoint_raw)
from superresolution_aniso_mri_tpu_torch.train.export_torch import (
    save_reference_checkpoint)
from superresolution_aniso_mri_tpu_torch.train.import_torch import (
    is_torch_checkpoint)
from torch_port_helpers import (SMALL, jax_model, jax_train_state,
                                port_trainer)

ARGS = dict(model="ae_combined", dataset="OASIS", use_batchnorm=True,
            use_sigmoid=True, lr=1e-4, epochs=1, image_mix_loss_func="mse",
            downsample_steps=3, seed=0)
TINY = ["-d", "MNIST3D", "--use_synthetic_data", "-m", "ae_combined",
        "--image_mix_loss_func", "mse", "--downsample_steps", "2",
        "--epoch_threshold", "-1", "--width", "32", "--latent_width", "16",
        "--depth", "8", "--latent", "8", "--limited_load", "-b", "8",
        "-bt", "4", "--num_val_batches", "1", "--lr", "1e-4", "-e", "1"]
CASES = {"plain": {}, "res_blocks": dict(n_res_block=2)}


def _jax_export(path, model_kw, seed=0, epoch=42):
    """A reference .models written by JAX's exporter; returns the JAX
    model, params and batch stats."""
    model, params, stats = jax_model(seed, **model_kw)
    cfg = model.config
    jax_save_reference(path, params, stats, width=cfg.width,
                       latent_width=cfg.latent_width, depth=cfg.depth,
                       latent=cfg.latent, colors=cfg.colors,
                       use_batchnorm=cfg.use_batchnorm,
                       use_sigmoid=cfg.use_sigmoid,
                       n_res_block=cfg.n_res_block, epoch=epoch)
    return model, params, stats


@pytest.mark.parametrize("case", sorted(CASES))
def test_jax_export_loads_in_the_port(case, tmp_path):
    """``Trainer.load`` detects the pickle (read with
    ``weights_only=True``; the file holds a real Adam state dict) and
    takes its tensors as they are; the forward matches JAX's; the
    optimizer restarts; the shape-exact stem is warned about."""
    model_kw = CASES[case]
    path = str(tmp_path / "ref.models")
    model, params, stats = _jax_export(path, model_kw)
    assert is_torch_checkpoint(path)
    raw = torch.load(path, map_location="cpu", weights_only=True)
    assert raw["optimizer_dict_ae"]["param_groups"]
    t = port_trainer(*jax_model(7, **model_kw)[1:], ARGS, model_kw)
    with pytest.warns(UserWarning, match="shape-exact stem"):
        t.load(path)
    assert t.epoch == 42 and t.state.opt_state.count == 0
    want = flax_to_torch(params, stats, t.model_config)
    for k, v in t.model.state_dict().items():
        assert torch.equal(v, want[k]), k
    x = np.random.RandomState(5).rand(3, 32, 32, 1).astype(np.float32)
    variables = {"params": params, "batch_stats": stats}
    with jax.default_matmul_precision("highest"):
        z = model.apply(variables, x, method=model.encode)
        out_jax = np.asarray(model.apply(variables, z, method=model.decode))
    with torch.no_grad():
        out = t.model(torch.from_numpy(x.transpose(0, 3, 1, 2))).numpy()
    assert np.abs(out.transpose(0, 2, 3, 1) - out_jax).max() <= 1e-5


def test_get_trainer_serves_a_reference_experiment(tmp_path):
    """A reference experiment (settings.yaml + a torch ``models/*.models``)
    loads through ``get_trainer``; ``load_checkpoint_raw`` names the
    converter for it."""
    from superresolution_aniso_mri_tpu_torch.config import (
        save_experiment_settings)

    (tmp_path / "models").mkdir()
    path = str(tmp_path / "models" / "120.models")
    _, params, stats = _jax_export(path, {})
    save_experiment_settings(dict(ARGS, **SMALL, device="cuda"),
                             str(tmp_path / "settings.yaml"))
    with pytest.warns(UserWarning, match="shape-exact stem"):
        t = get_trainer(str(tmp_path), model_nbr=120, device="cpu")
    want = flax_to_torch(params, stats, t.model_config)
    for k, v in t.model.state_dict().items():
        assert torch.equal(v, want[k]), k
    with pytest.raises(ValueError, match="convert-reference-checkpoint"):
        load_checkpoint_raw(path)


@pytest.mark.parametrize("case", sorted(CASES))
def test_port_export_loads_in_jax(case, tmp_path):
    """JAX's importer reads the port's file into exactly the port's
    parameters and batch statistics."""
    model_kw = CASES[case]
    _, params, stats = jax_model(2, **model_kw)
    t = port_trainer(params, stats, ARGS, model_kw)
    path = str(tmp_path / "port.models")
    save_reference_checkpoint(path, t.model, epoch=7)
    jmodel, jparams, jstats = jax_model(9, **model_kw)
    state, epoch = jax_load_reference(
        path, jax_train_state(jmodel, jparams, jstats, lr=1e-4))
    assert epoch == 7
    want_p, want_s = torch_to_flax(t.model.state_dict())
    for got, want in ((state.params, want_p), (state.batch_stats, want_s)):
        jax.tree_util.tree_map(np.testing.assert_array_equal,
                               jax.device_get(got), want)


@pytest.mark.parametrize("case", sorted(CASES))
def test_export_import_round_trip_is_bit_identical(case, tmp_path):
    model_kw = CASES[case]
    src = port_trainer(*jax_model(3, **model_kw)[1:], ARGS, model_kw)
    dst = port_trainer(*jax_model(4, **model_kw)[1:], ARGS, model_kw)
    path = str(tmp_path / "rt.models")
    save_reference_checkpoint(path, src.model, epoch=3)
    with pytest.warns(UserWarning, match="shape-exact stem"):
        dst.load(path)
    assert dst.epoch == 3
    for k, v in src.model.state_dict().items():
        assert torch.equal(dst.model.state_dict()[k], v), k


def test_partial_and_mismatched_checkpoints_raise(tmp_path):
    """An encoder-only artifact, other widths, an unknown submodule and
    a transposed-conv decoder all raise instead of loading."""
    path = str(tmp_path / "ref.models")
    _jax_export(path, {})
    sd = torch.load(path, map_location="cpu", weights_only=True)
    t = port_trainer(*jax_model(1)[1:], ARGS)
    for name, bad, match in (
            ("partial", {k: v for k, v in sd["model_dict_ae"].items()
                         if k.startswith("enc.")}, "missing submodules"),
            ("extra", {**sd["model_dict_ae"],
                       "disc.0.weight": torch.zeros(1, 1, 3, 3)},
             "no counterpart")):
        p = str(tmp_path / f"{name}.models")
        torch.save({"model_dict_ae": bad, "epoch": 1}, p)
        with pytest.raises(ValueError, match=match):
            t.load(p)
    wide = port_trainer(*jax_model(1, depth=8)[1:], ARGS, dict(depth=8))
    with pytest.raises(ValueError, match="shape|do not match"):
        wide.load(path)
    strided = VanillaACAI(AEConfig(**SMALL, use_upsample=False))
    with pytest.raises(NotImplementedError, match="transposed"):
        save_reference_checkpoint(str(tmp_path / "s.models"), strided)


def test_convert_and_export_commands_round_trip(tmp_path):
    """export-reference-checkpoint writes a torch .models of a port
    experiment; convert-reference-checkpoint rewrites a reference
    experiment of it as SRTPU1 (into a new directory, then in place,
    keeping the original as ``.torch``); the weights come back bitwise."""
    entry.train_brain(TINY + ["-o", str(tmp_path), "-id", "x", "--device",
                              "cpu"])
    exper = tmp_path / "x"
    ref = tmp_path / "ref"
    (ref / "models").mkdir(parents=True)
    shutil.copy2(exper / "settings.yaml", ref / "settings.yaml")
    entry.export_reference_checkpoint(
        ["--exper_dir", str(exper), "--model_nbr", "0", "--out",
         str(ref / "models" / "0.models")], device="cpu")
    assert is_torch_checkpoint(str(ref / "models" / "0.models"))
    conv = tmp_path / "conv"
    assert entry.convert_reference_checkpoint(
        ["--exper_dir", str(ref), "--output_dir", str(conv)],
        device="cpu") == 1
    original = get_trainer(str(exper), model_nbr=0, device="cpu")
    converted = get_trainer(str(conv), model_nbr=0, device="cpu")
    assert not is_torch_checkpoint(str(conv / "models" / "0.models"))
    assert converted.epoch == original.epoch == 1
    for k, v in original.model.state_dict().items():
        assert torch.equal(converted.model.state_dict()[k], v), k
    assert entry.convert_reference_checkpoint(
        ["--exper_dir", str(ref)], device="cpu") == 1
    assert sorted(os.listdir(ref / "models")) == ["0.models",
                                                  "0.models.torch"]
    assert not is_torch_checkpoint(str(ref / "models" / "0.models"))
