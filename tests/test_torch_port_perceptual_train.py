"""PyTorch port, training with the perceptual and SSIM losses against the
JAX package on the CPU: 5 train steps of the small model for the
``perceptual`` synthesis loss (the default of ``ae_combined``),
``perceptual_enc``, ``use_percept_loss`` (perceptual reconstruction
too), ``use_ssim_loss`` and a bfloat16 model whose LPIPS VGG stack runs
in bfloat16 (``lpips_dtype``); the eval step; and the Trainer's and the
train command's resolution of the frozen weights (``lpips_mode`` in
``settings.yaml``).

Weights come from ``torch_port_helpers.jax_model``, batches from numpy
seeds (32², 2 pairs), the LPIPS weights from each package's
``get_lpips_params`` (the same numpy draws) and the shipped encoder
artifact. JAX runs at ``default_matmul_precision("highest")``.
Tolerances are those of ``test_torch_port_train.py``: every metric at
every step rtol 1e-4 (bfloat16 2e-2), parameters within 2·lr·steps,
BatchNorm statistics rtol 1e-4 with atol 1e-5 (a running mean near 0
differs by ~2e-6) and bfloat16 2e-2 with atol 1e-3. The learning rate
is the README OASIS recipe's 1e-5, not that file's 1e-4: the first
step's gradients through the 13-layer VGG stack agree only to ~5e-3 of
their largest entry (float32 sums in another order; the LPIPS input
gradient itself to 1e-4, ``test_torch_port_lpips.py``), and at 1e-4
Adam's near-sign updates turn that into a 1.1e-4 gap of
``loss_ae_dist`` by step 3 with ``use_percept_loss``; at 1e-5 every
metric stays within 5e-6.
"""
import os
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import yaml

from superresolution_aniso_mri_tpu.ops import lpips as jl
from superresolution_aniso_mri_tpu.ops import perceptual as jp
from superresolution_aniso_mri_tpu.train.steps import (
    LossConfig as JaxLossConfig, make_eval_step as jax_make_eval_step,
    make_train_step as jax_make_train_step)
from superresolution_aniso_mri_tpu_torch.models.convert import torch_to_flax
from superresolution_aniso_mri_tpu_torch.ops import lpips as tl
from superresolution_aniso_mri_tpu_torch.ops import perceptual as tp
from superresolution_aniso_mri_tpu_torch.train import (LossConfig,
                                                       make_eval_step,
                                                       make_train_step)
from torch_port_helpers import (jax_model, jax_train_state, np_batch,
                                port_train_state, torch_batch)

LR, STEPS, MIX = 1e-5, 5, 0.3


@pytest.fixture(scope="module")
def weights():
    """{'vgg': (JAX, port) LPIPS weights, 'enc': (JAX, port) artifact}."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return {"vgg": (jl.get_lpips_params(),
                        tl.get_lpips_params(device="cpu")),
                "enc": (jp.get_enc_perceptual_params(),
                        tp.get_enc_perceptual_params(device="cpu"))}


CASES = {
    "mix_perceptual": dict(loss=dict(image_mix_loss_func="perceptual")),
    "mix_perceptual_enc": dict(loss=dict(
        image_mix_loss_func="perceptual_enc"), weights="enc"),
    "use_percept_loss": dict(loss=dict(recon_loss="perceptual",
                                       image_mix_loss_func="perceptual")),
    "ssim": dict(loss=dict(image_mix_loss_func="mse", use_ssim_loss=True),
                 weights=None),
    "bf16": dict(loss=dict(image_mix_loss_func="perceptual",
                           lpips_dtype="bfloat16"),
                 model=dict(compute_dtype="bfloat16"), rtol=2e-2),
}


def _jax_batch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


@pytest.mark.parametrize("case", sorted(CASES))
def test_perceptual_train_steps_match_jax(case, weights):
    spec = CASES[case]
    loss_kw = dict(model="ae_combined", **spec["loss"])
    model_kw = spec.get("model", {})
    rtol = spec.get("rtol", 1e-4)
    wkey = spec.get("weights", "vgg")
    jw, pw = weights[wkey] if wkey else (None, None)
    model, params, stats = jax_model(0, **model_kw)
    jstate = jax_train_state(model, params, stats, lr=LR)
    pstate = port_train_state(params, stats, model_kw, lr=LR)
    jstep = jax_make_train_step(model, JaxLossConfig(**loss_kw), jw,
                                donate=False)
    pstep = make_train_step(LossConfig(**loss_kw), pw)
    with jax.default_matmul_precision("highest"):
        for i in range(STEPS):
            nb = np_batch(i)
            jstate, jm = jstep(jstate, _jax_batch(nb), jax.random.PRNGKey(i),
                               jnp.float32(MIX))
            pstate, pm = pstep(pstate, torch_batch(nb), MIX)
            assert sorted(pm) == sorted(jm)
            for k in jm:
                np.testing.assert_allclose(float(pm[k]), float(jm[k]),
                                           rtol=rtol, err_msg=f"step {i} {k}")
    got_params, got_stats = torch_to_flax(pstate.model.state_dict())
    drift = jax.tree_util.tree_map(
        lambda a, b: float(np.abs(np.asarray(a) - b).max()), jstate.params,
        got_params)
    assert max(jax.tree_util.tree_leaves(drift)) <= 2 * LR * STEPS
    atol = 1e-5 if rtol <= 1e-4 else 1e-3
    jax.tree_util.tree_map(
        lambda a, b: np.testing.assert_allclose(b, np.asarray(a), rtol=rtol,
                                                atol=atol),
        jstate.batch_stats, got_stats)


@pytest.mark.parametrize("case", ["mix_perceptual", "mix_perceptual_enc",
                                  "use_percept_loss"])
def test_perceptual_eval_step_matches_jax(case, weights):
    """Eval-mode losses with the perceptual weights, mix-weighted
    (rtol 1e-4)."""
    spec = CASES[case]
    loss_kw = dict(model="ae_combined", **spec["loss"])
    jw, pw = weights[spec.get("weights", "vgg")]
    model, params, stats = jax_model(1)
    pmodel = port_train_state(params, stats, lr=LR).model
    nb = np_batch(9)
    with jax.default_matmul_precision("highest"):
        jm, _ = jax_make_eval_step(model, JaxLossConfig(**loss_kw), jw)(
            params, stats, _jax_batch(nb), jnp.float32(MIX))
    pm, _ = make_eval_step(LossConfig(**loss_kw), pw)(pmodel,
                                                      torch_batch(nb), MIX)
    assert sorted(pm) == sorted(jm)
    for k in jm:
        np.testing.assert_allclose(float(pm[k]), float(jm[k]), rtol=1e-4,
                                   err_msg=k)


@pytest.mark.parametrize("extra, mode", [
    (dict(image_mix_loss_func="perceptual"), "lin_converted_vgg_random"),
    (dict(image_mix_loss_func="perceptual_enc"), "encoder_backbone"),
    (dict(image_mix_loss_func="mse", compute_dtype="bfloat16"), None),
])
def test_trainer_resolves_the_weights_like_jax(extra, mode, monkeypatch):
    """A training Trainer's loss config (``lpips_dtype`` = the compute
    dtype), its ``lpips_mode`` and the kind of weights it resolves, as
    the JAX Trainer's (which resolves them in both modes); an eval-mode
    Trainer resolves none and keeps the ``lpips_mode`` of its settings
    (ROADMAP item 19)."""
    from superresolution_aniso_mri_tpu.train import trainer as jtrainer
    from superresolution_aniso_mri_tpu_torch.train import Trainer

    args = dict(model="ae_combined", dataset="OASIS", width=32,
                latent_width=8, depth=4, latent=6, lr=1e-4, epochs=1,
                ex_loss_weight1=0.3, batch_size=2, downsample_steps=2,
                **extra)
    monkeypatch.setattr(jtrainer, "create_train_state",
                        lambda *a, **kw: None)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = jtrainer.Trainer(dict(args), eval_mode=True)
        got = Trainer(dict(args), device="cpu")
        served = Trainer(dict(args, lpips_mode="as-saved"), eval_mode=True,
                         device="cpu")
    assert got.args.get("lpips_mode") == want.args.get("lpips_mode") == mode
    for field in ("recon_loss", "image_mix_loss_func", "lpips_dtype"):
        assert getattr(got.loss_config, field) == getattr(want.loss_config,
                                                          field)
    assert (got.lpips_params is None) == (want.lpips_params is None)
    if mode == "encoder_backbone":
        assert got.lpips_params["kind"] == "enc"
    assert served.lpips_params is None
    assert served.args["lpips_mode"] == "as-saved"


def _settings(exper):
    with open(os.path.join(exper, "settings.yaml")) as f:
        return yaml.safe_load(f)


def test_default_ae_combined_run_writes_the_jax_settings(tmp_path):
    """``train-brain -m ae_combined`` without ``--image_mix_loss_func``
    trains the perceptual default in both packages and writes the same
    settings.yaml keys and values (but the device and the paths),
    ``lpips_mode`` included."""
    from superresolution_aniso_mri_tpu.cli.train_loop import run_training
    from superresolution_aniso_mri_tpu.config import arguments as jargs
    from superresolution_aniso_mri_tpu_torch.cli import entry

    argv = ["-d", "MNIST3D", "--use_synthetic_data", "-m", "ae_combined",
            "--downsample_steps", "2", "--width", "32", "--latent_width",
            "16", "--depth", "8", "--latent", "8", "--limited_load", "-b",
            "8", "-bt", "4", "--num_val_batches", "1", "-e", "1",
            "--volume_preview_interval", "0", "-o", str(tmp_path)]
    _, d = jargs.parse_args(argv + ["-id", "jax"])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with jax.default_matmul_precision("highest"):
            run_training(d, verbose=False)
        entry.train_brain(argv + ["-id", "port", "--device", "cpu"])
    got, want = (_settings(tmp_path / side) for side in ("port", "jax"))
    assert got["image_mix_loss_func"] == "perceptual"
    assert got["lpips_mode"] == "lin_converted_vgg_random"
    assert (got.pop("device"), want.pop("device")) == ("cpu", "tpu")
    for key in ("output_dir", "dir_models", "dir_images", "exper_id"):
        assert got.pop(key) != want.pop(key)
    assert got == want
    for side in ("port", "jax"):
        loss = np.load(os.path.join(tmp_path, side, "losses_train.npz"))
        assert np.isfinite(loss["loss_ae_dist_extra"]).all()
