"""PyTorch port, training the labeled cardiac path (ACDCLBL): the
``multichannel`` and ``multichannel_combined`` train and eval steps,
the trainer's routing and its ``caisr.models`` selection, and the
``train-cardiac -d ACDCLBL`` → ``generate-hr-volumes`` round trip, held
against the JAX package on the CPU.

Weights come from ``torch_port_helpers.jax_family_model``, batches from
numpy seeds ((image, label) planes, labels in {0, 1, 2, 3}); JAX runs
at ``default_matmul_precision("highest")``. Tolerances:

- one step's gradient: within 1e-5 of the largest entry of JAX's
  float64 gradient. JAX's own float32 gradient is no oracle here: the
  train-mode BatchNorms amplify its float32 rounding to 3.1e-5 of the
  largest entry in this case (labels all 0, 4 images; 3% at depth 8),
  where the port's float32 gradient stays within 4.2e-6;
- 5 train steps at the cardiac recipe's lr 1e-5: every metric at every
  step rtol 1e-4 (the comparison families' tolerance), BatchNorm
  statistics rtol 1e-4 (atol 1e-5), the final parameters atol 1e-5 for
  98.5 % of the entries and 2·lr·steps for all (Adam's first steps are
  near-sign steps, so an entry whose tiny gradient rounds to another
  sign moves the other way); the Adam count equal. At lr 1e-4 the same rounding
  moves the combined family's metrics apart by 5e-4 within 5 steps;
- eval steps: rtol 1e-4, the reconstruction and synthesized slices
  atol 1e-5;
- the CLI round trip: the port's checkpoint loads in JAX exactly, and
  both packages densify the same volume to images within 1e-5 and
  decoded labels exactly.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from superresolution_aniso_mri_tpu.train.state import (
    SRTrainState, make_optimizer as jax_make_optimizer)
from superresolution_aniso_mri_tpu.train.steps import (
    LossConfig as JaxLossConfig, _multichannel_losses as jax_losses,
    make_eval_step as jax_make_eval_step,
    make_train_step as jax_make_train_step)
from superresolution_aniso_mri_tpu_torch.cli import entry
from superresolution_aniso_mri_tpu_torch.models import (
    AEConfig, build_model, flax_to_torch, torch_to_flax)
from superresolution_aniso_mri_tpu_torch.train import (
    LossConfig, create_train_state, make_eval_step, make_train_step)
from superresolution_aniso_mri_tpu_torch.train.steps import (
    _multichannel_losses)
from superresolution_aniso_mri_tpu_torch.utils import read_image, write_image
from torch_port_helpers import (SMALL, JaxServingStub, jax_family_model,
                                numpy_variables,
                                one_torch_thread)  # autouse

LR, STEPS, MIX, B = 1e-5, 5, 0.3, 2
MC = dict(colors=2, nclasses=4, use_batchnorm=True, use_sigmoid=True)


def _highest():
    return jax.default_matmul_precision("highest")


def _nhwc(t):
    return t.detach().numpy().transpose(0, 2, 3, 1)


def _batch(seed=0, b=B, hw=32, mask=False, labels=4):
    """A numpy-seeded NHWC batch of (image, label) planes."""
    rng = np.random.RandomState(seed)

    def planes(n):
        return np.concatenate([rng.rand(n, hw, hw, 1),
                               rng.randint(0, labels, (n, hw, hw, 1))],
                              axis=-1).astype(np.float32)

    a_to = rng.uniform(0.1, 0.9, b).astype(np.float32)
    batch = {"image": planes(2 * b), "slice_between": planes(b),
             "alpha_from": (1.0 - a_to).astype(np.float32), "alpha_to": a_to,
             "is_inbetween": (np.arange(b) % 2 == 0).astype(np.float32)}
    if mask:
        batch["loss_mask"] = (rng.rand(b, hw, hw, 1) > 0.3).astype(np.float32)
    return batch


def _port_batch(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(
        v.transpose(0, 3, 1, 2) if v.ndim == 4 else v))
        for k, v in batch.items()}


def _states(seed=0, **opt):
    """(JAX MultiChannelAE, JAX state, port state) from one tree."""
    model, params, stats = jax_family_model("MultiChannelAE", seed, **MC)
    jstate = SRTrainState.create(apply_fn=model.apply, params=params,
                                 tx=jax_make_optimizer(**opt),
                                 batch_stats=stats)
    cfg = AEConfig(**{**SMALL, **MC})
    port = build_model("MultiChannelAE", cfg)
    port.load_state_dict(flax_to_torch(params, stats, cfg, port))
    return model, jstate, create_train_state(port, **opt)


CASES = {
    "multichannel": dict(model="multichannel"),
    "multichannel_masked": dict(model="multichannel", use_masks=True),
    "multichannel_combined": dict(model="multichannel_combined"),
    "multichannel_combined_masked_laploss": dict(
        model="multichannel_combined", use_masks=True, use_laploss=True),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_train_steps_match_jax(case):
    """5 steps; every logged metric (``loss_label``, ``loss_latent_1``
    and, combined, ``loss_ae_dist_labels`` / ``loss_ae_extra``) at every
    step; with ``use_masks`` the batch carries ``loss_mask``, which
    neither package reads."""
    loss_kw = {"image_mix_loss_func": "mse", **CASES[case]}
    model, jstate, pstate = _states(0, lr=LR)
    jstep = jax_make_train_step(model, JaxLossConfig(**loss_kw),
                                donate=False)
    pstep = make_train_step(LossConfig(**loss_kw))
    with _highest():
        for i in range(STEPS):
            nb = _batch(i, mask=loss_kw.get("use_masks", False))
            jstate, jm = jstep(jstate, {k: jnp.asarray(v)
                                        for k, v in nb.items()},
                               jax.random.PRNGKey(i), jnp.float32(MIX))
            pstate, pm = pstep(pstate, _port_batch(nb), MIX)
            assert sorted(pm) == sorted(jm)
            for k in jm:
                np.testing.assert_allclose(float(pm[k]), float(jm[k]),
                                           rtol=1e-4,
                                           err_msg=f"step {i} {k}")
    assert "loss_label" in pm and ("loss_ae_extra" in pm) == (
        "combined" in case)
    got_params, got_stats = torch_to_flax(pstate.model.state_dict())
    gap = np.concatenate([np.abs(np.ravel(np.asarray(a)) - np.ravel(b))
                          for a, b in zip(jax.tree_util.tree_leaves(
                              jstate.params), jax.tree_util.tree_leaves(
                              got_params))])
    assert np.mean(gap <= 1e-5) >= 0.985
    assert gap.max() <= 2 * LR * STEPS
    jax.tree_util.tree_map(
        lambda a, b: np.testing.assert_allclose(b, np.asarray(a), rtol=1e-4,
                                                atol=1e-5),
        jstate.batch_stats, got_stats)
    assert pstate.opt_state.count == STEPS == int(jstate.step)


def test_gradient_matches_jax_float64():
    """One step's gradient of the combined loss against JAX's float64
    gradient of the same network (see the module docstring)."""
    loss_kw = dict(model="multichannel_combined", image_mix_loss_func="mse")
    kw = {**MC, "compute_dtype": "float64"}
    nb = _batch(3, b=2, labels=1)
    with jax.enable_x64(True):
        from superresolution_aniso_mri_tpu.models import config as jax_config
        from superresolution_aniso_mri_tpu.models import (
            AEConfig as JaxConfig, MultiChannelAE as JaxMultiChannelAE)

        dtypes = dict(jax_config._DTYPES)
        jax_config._DTYPES["float64"] = jnp.float64
        try:
            model = JaxMultiChannelAE(JaxConfig(**{**SMALL, **kw}))
            params, stats = numpy_variables(
                jax_family_model("MultiChannelAE", 1, **MC)[0], 1)
            f64 = jax.tree_util.tree_map(
                lambda a: jnp.asarray(a, jnp.float64), (params, stats, nb))
            grads = jax.jit(jax.grad(lambda p, s, b: jax_losses(
                model, JaxLossConfig(**loss_kw), None, p, s, b,
                jnp.float64(MIX))[0]))(*f64)
            want = np.concatenate([np.ravel(np.asarray(g)) for g in
                                   jax.tree_util.tree_leaves(grads)])
        finally:
            jax_config._DTYPES.clear()
            jax_config._DTYPES.update(dtypes)
    cfg = AEConfig(**{**SMALL, **MC})
    port = build_model("MultiChannelAE", cfg)
    port.load_state_dict(flax_to_torch(params, stats, cfg, port))
    loss, _ = _multichannel_losses(port, LossConfig(**loss_kw), None,
                                   _port_batch(nb), MIX)
    named = dict(port.named_parameters())
    got, _ = torch_to_flax(dict(zip(named, torch.autograd.grad(
        loss, list(named.values())))))
    got = np.concatenate([np.ravel(g) for g in
                          jax.tree_util.tree_leaves(got)])
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("model_name", ["multichannel",
                                        "multichannel_combined"])
def test_eval_steps_match_jax(model_name):
    """Eval-mode losses on the image plane (the mask unused, as in
    training), the combined family's label Dice and its selection sum,
    weighted by mix_weight; the reconstruction and the synthesized
    slices."""
    loss_kw = dict(model=model_name, image_mix_loss_func="mse",
                   use_laploss=True, use_masks=True)
    model, jstate, pstate = _states(2, lr=LR)
    nb = _batch(7, mask=True)
    with _highest():
        jm, jaux = jax_make_eval_step(model, JaxLossConfig(**loss_kw))(
            jstate.params, jstate.batch_stats,
            {k: jnp.asarray(v) for k, v in nb.items()}, jnp.float32(MIX))
    pm, paux = make_eval_step(LossConfig(**loss_kw))(pstate.model,
                                                     _port_batch(nb), MIX)
    assert sorted(pm) == sorted(jm)
    for k in jm:
        np.testing.assert_allclose(float(pm[k]), float(jm[k]), rtol=1e-4,
                                   err_msg=k)
    for k in ("reconstruction", "slice_inbetween_mix"):
        np.testing.assert_allclose(_nhwc(paux[k]), np.asarray(jaux[k]),
                                   atol=1e-5, err_msg=k)


@pytest.mark.parametrize("args", [
    dict(model="ae_combined", dataset="ACDCLBL", nclasses=3),
    dict(model="ae", dataset="ACDCLBL", get_masks=True),
    dict(model="multichannel_combined", dataset="ACDC"),
    dict(model="ae_combined", dataset="ACDC"),
])
def test_loss_config_and_caisr_selection_match_jax(args, tmp_path):
    """``loss_config_from_args`` as JAX's (ACDCLBL routes to the
    multichannel families; ``nclasses`` from the args); the multichannel
    trainer writes ``caisr.models`` on ``loss_ae_extra``, the others on
    ``loss_ae_dist_extra``, as JAX selects."""
    from superresolution_aniso_mri_tpu.train import Trainer as JaxTrainer
    from superresolution_aniso_mri_tpu.train.trainer import (
        loss_config_from_args as jax_loss_config)
    from superresolution_aniso_mri_tpu_torch.train import Trainer
    from superresolution_aniso_mri_tpu_torch.train.trainer import (
        loss_config_from_args)

    import dataclasses

    got, want = loss_config_from_args(args), jax_loss_config(args)
    for f in dataclasses.fields(got):
        assert getattr(got, f.name) == getattr(want, f.name), f.name
    jt = object.__new__(JaxTrainer)
    jt.family = want.family
    labeled = args["dataset"] == "ACDCLBL"
    tr = Trainer({**args, **SMALL, **MC, "colors": 2 if labeled else 1,
                  "lr": LR, "output_dir": str(tmp_path)}, device="cpu",
                 eval_mode=not labeled)
    assert tr._caisr_selection_key() == jt._caisr_selection_key()
    if not labeled:
        return
    tr.prepare_run()
    tr.epoch = 1
    tr.mean_losses_test.update(loss_ae_dist=[0.5], loss_ae_extra=[-0.2],
                               loss_ae_dist_extra=[9.0])
    tr.save_best_val_model()
    tr.mean_losses_test.update(loss_ae_dist=[0.5, 0.6],
                               loss_ae_extra=[-0.2, -0.1],
                               loss_ae_dist_extra=[9.0, 1.0])
    os.remove(tmp_path / "models" / "caisr.models")
    tr.save_best_val_model()
    assert not (tmp_path / "models" / "caisr.models").exists()


TINY = ["-d", "ACDCLBL", "--use_synthetic_data", "-m", "ae_combined",
        "--image_mix_loss_func", "mse", "--downsample_steps", "2",
        "--epoch_threshold", "-1", "--width", "32", "--latent_width", "16",
        "--depth", "8", "--latent", "8", "--limited_load", "-b", "8",
        "-bt", "4", "--num_val_batches", "1", "--lr", "1e-4", "-e", "1",
        "--get_masks", "--steps_per_dispatch", "2", "--device", "cpu"]


def test_train_cardiac_acdclbl_then_generate_with_labels(tmp_path):
    """``train-cardiac -d ACDCLBL --get_masks --steps_per_dispatch 2`` on
    synthetic volumes writes an experiment JAX loads; ``generate`` with
    ``--label_suffix _gt`` writes the decoded labels as JAX's
    ``_densify_file`` does from the same checkpoint, and a volume
    without a label file gets no label output."""
    from superresolution_aniso_mri_tpu.cli import entry as jentry
    from superresolution_aniso_mri_tpu.models import (
        AEConfig as JaxConfig, build_model as jax_build_model)
    from superresolution_aniso_mri_tpu.train.checkpoint import (
        load_checkpoint as jax_load)
    from superresolution_aniso_mri_tpu_torch.config import load_settings

    tr = entry.train_cardiac(TINY + ["-o", str(tmp_path), "-id", "mc"])
    exper = tmp_path / "mc"
    settings = load_settings(str(exper / "settings.yaml"))
    assert (settings["ae_class"], settings["colors"], settings["get_masks"]
            ) == ("MultiChannelAE", 2, True)
    assert tr.family == "multichannel_combined"
    losses = np.load(exper / "losses_test.npz")
    assert {"loss_ae_extra", "loss_ae_dist_labels"} <= set(losses.files)
    assert np.isfinite(np.load(exper / "losses_train.npz")["loss_label"]
                       ).all()

    jmodel = jax_build_model("MultiChannelAE", JaxConfig.from_args(settings))
    params, stats = numpy_variables(jmodel, 0)
    template = SRTrainState.create(
        apply_fn=jmodel.apply, params=params, batch_stats=stats,
        tx=jax_make_optimizer(float(settings["lr"]),
                              momentum=float(settings["momentum"])))
    jstate, epoch = jax_load(str(exper / "models" / "caisr.models"),
                             template)
    want_p, want_s = torch_to_flax(tr.model.state_dict())
    jax.tree_util.tree_map(
        lambda a, b: np.testing.assert_array_equal(np.asarray(a), b),
        (jstate.params, jstate.batch_stats), (want_p, want_s))

    inputs, out = tmp_path / "in", tmp_path / "out"
    inputs.mkdir()
    rng = np.random.RandomState(0)
    sp = np.array([10.0, 1.4, 1.4])
    write_image(str(inputs / "p1.nii.gz"),
                rng.rand(6, 32, 32).astype(np.float32), spacing=sp)
    write_image(str(inputs / "p1_gt.nii.gz"),
                rng.randint(0, 4, (6, 32, 32)).astype(np.int16), spacing=sp,
                dtype=np.int16)
    write_image(str(inputs / "p2.nii.gz"),
                rng.rand(5, 32, 32).astype(np.float32), spacing=sp)
    entry.generate_hr_volumes(["--exper_dir", str(exper), "--data_input_dir",
                               str(inputs), "--output_dir", str(out),
                               "--num_interpolations", "2"], device="cpu")
    assert sorted(os.listdir(out)) == ["p1_ni02.nii.gz", "p1_ni02_gt.nii.gz",
                                       "p2_ni02.nii.gz"]
    stub = JaxServingStub(jmodel, jstate.params, jstate.batch_stats)
    ref = tmp_path / "ref"
    ref.mkdir()
    with _highest():
        jentry._densify_file(stub, str(inputs / "p1.nii.gz"), str(ref), 2,
                             "_gt")
    img, spacing, _ = read_image(str(out / "p1_ni02.nii.gz"))
    want_img, want_spacing, _ = read_image(str(ref / "p1_ni02.nii.gz"))
    np.testing.assert_allclose(img, want_img, atol=1e-5)
    np.testing.assert_allclose(spacing, want_spacing)
    lbl = read_image(str(out / "p1_ni02_gt.nii.gz"))[0]
    want_lbl = read_image(str(ref / "p1_ni02_gt.nii.gz"))[0]
    assert lbl.shape == (16, 32, 32) and np.array_equal(lbl, want_lbl)
    assert set(np.unique(lbl)) <= {0, 1, 2, 3}
