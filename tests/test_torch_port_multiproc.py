"""PyTorch port, data-parallel training on two gloo ranks on the CPU
(``parallel/``, the sharded step of ``train/steps.py``, the data-parallel
``Trainer`` and train loop).

One module-scoped cluster of two spawned ranks runs every case of
``torch_port_multiproc_cases`` in turn (torch is imported once per rank,
not once per case). Each case holds the 2-rank step against the port's
single-process step on the same global batch: the loss metrics
(rtol 1e-4), the all-reduced gradient entry by entry (2e-5 of each
leaf's largest entry: Adam's first update is about ``lr·sign(g)`` and
would hide a gradient N times too large), the BatchNorm running
statistics and θ − θ0. The ``ae_combined`` BN case is also held against
JAX's ``make_sharded_train_step`` on a 2-device CPU mesh (under
``jax.default_matmul_precision("highest")``), and ``train-brain
--num_devices 2 --device cpu`` runs as the ranks and through the CLI's
own launcher; JAX loads the checkpoint that rank 0 wrote.
"""
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_multiproc_cases as cases
from torch_port_helpers import jax_train_state, one_torch_thread  # noqa: F401

GRAD_RTOL = 2e-5


@pytest.fixture(scope="module")
def cluster(tmp_path_factory):
    from superresolution_aniso_mri_tpu_torch.parallel import launch

    out = tmp_path_factory.mktemp("ranks")
    launch(cases.run_all, (str(out),), ["cpu", "cpu"], "gloo",
           timeout_s=120, join_timeout_s=240)
    return out


def _load(root, name, rank):
    with np.load(os.path.join(root, f"{name}.r{rank}.npz")) as f:
        return dict(f)


def _leaves(res, prefix):
    return {k[len(prefix):]: v for k, v in res.items() if k.startswith(prefix)}


def _assert_theta_steps_match(got0, got1, want0, want1, grads):
    """θ1 − θ0 entry by entry within 1e-4 of the leaf's largest step,
    where the gradient is resolved: at an entry whose gradient is below
    1e-3 of the leaf's largest (the float32 noise of two reduction orders
    is ~1e-5 of it) Adam's first step ``lr·g/(|g| + eps)`` turns that
    noise into a sign, so the entry is held to the gradient check
    alone."""
    for leaf, g in grads.items():
        want = want1[leaf] - want0[leaf]
        got = got1[leaf] - got0[leaf]
        resolved = np.abs(g) >= 1e-3 * np.abs(g).max()
        assert resolved.any(), leaf
        gap = np.abs(got - want)[resolved].max()
        assert gap <= 1e-4 * np.abs(want).max(), (leaf, gap)


@pytest.mark.parametrize("name", sorted(cases.CASES))
def test_two_rank_step_is_the_single_process_step(cluster, name):
    r0, r1 = _load(cluster, name, 0), _load(cluster, name, 1)
    dp, single = _leaves(r0, "dp/"), _leaves(r0, "single/")
    assert sorted(dp) == sorted(single)
    want_m, got_m = _leaves(single, "metric/"), _leaves(dp, "metric/")
    assert sorted(got_m) == sorted(want_m) and "loss_ae" in got_m
    for k in want_m:
        np.testing.assert_allclose(got_m[k], want_m[k], rtol=1e-4,
                                   atol=1e-7, err_msg=k)
    grads = _leaves(single, "grad/")
    for leaf, want in grads.items():
        gap = np.abs(_leaves(dp, "grad/")[leaf] - want).max()
        assert gap <= GRAD_RTOL * np.abs(want).max(), (leaf, gap)
    for leaf, want in _leaves(single, "buffer/").items():
        np.testing.assert_allclose(_leaves(dp, "buffer/")[leaf], want,
                                   rtol=1e-5, atol=1e-7, err_msg=leaf)
    _assert_theta_steps_match(_leaves(dp, "theta0/"), _leaves(dp, "theta1/"),
                              _leaves(single, "theta0/"),
                              _leaves(single, "theta1/"), grads)
    # every rank holds the same state
    for k, v in r1.items():
        if k.startswith(("dp/theta1/", "dp/buffer/")):
            np.testing.assert_array_equal(v, r0[k], err_msg=k)


def test_two_rank_step_matches_jax_sharded_step(cluster):
    """The ``ae_combined`` BN case against JAX's data-parallel step on a
    2-device CPU mesh from the same weights and global batch."""
    from superresolution_aniso_mri_tpu.models import AEConfig as JaxConfig
    from superresolution_aniso_mri_tpu.models import VanillaACAI as JaxACAI
    from superresolution_aniso_mri_tpu.parallel import (
        create_mesh, make_sharded_train_step, replicate_state, shard_batch)
    from superresolution_aniso_mri_tpu.train.trainer import (
        loss_config_from_args)
    from superresolution_aniso_mri_tpu_torch.models import torch_to_flax

    name = "ae_combined_bn"
    dp = _leaves(_load(cluster, name, 0), "dp/")
    args = {**cases.BASE, **cases.CASES[name]["args"]}
    cfg = JaxConfig(**{k: args[k] for k in (
        "width", "latent_width", "depth", "latent", "use_batchnorm",
        "use_sigmoid")})
    model = JaxACAI(cfg)
    params0, stats0 = torch_to_flax({**_leaves(dp, "theta0/"),
                                     **_leaves(dp, "buffer0/")})
    params1, stats1 = torch_to_flax({**_leaves(dp, "theta1/"),
                                     **_leaves(dp, "buffer/")})
    grads, _ = torch_to_flax(_leaves(dp, "grad/"))
    batch = {k: (v.numpy().transpose(0, 2, 3, 1) if v.ndim == 4
                 else v.numpy())
             for k, v in cases.global_batch(len(name)).items()}
    mesh = create_mesh(jax.devices()[:2])
    step = make_sharded_train_step(model, loss_config_from_args(args), None,
                                   mesh)
    with jax.default_matmul_precision("highest"), mesh:
        state = replicate_state(mesh, jax_train_state(
            model, params0, stats0, lr=float(args["lr"])))
        new, metrics = step(state, shard_batch(mesh, batch),
                            jax.random.PRNGKey(0),
                            jnp.float32(args["ex_loss_weight1"]))
    np.testing.assert_allclose(dp["metric/loss_ae"],
                               float(metrics["loss_ae"]), rtol=1e-4)
    flat = jax.tree_util.tree_flatten_with_path
    want1 = {jax.tree_util.keystr(p): np.asarray(v)
             for p, v in flat(new.params)[0]}
    got = {jax.tree_util.keystr(p): np.asarray(v)
           for p, v in flat(params1)[0]}
    got0 = {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in flat(params0)[0]}
    g = {jax.tree_util.keystr(p): np.asarray(v) for p, v in flat(grads)[0]}
    assert sorted(got) == sorted(want1)
    _assert_theta_steps_match(got0, got, got0, want1, g)
    jax.tree_util.tree_map(
        lambda a, b: np.testing.assert_allclose(np.asarray(a), b,
                                                rtol=1e-5, atol=1e-7),
        new.batch_stats, stats1)


def _check_experiment(exper, epochs):
    from superresolution_aniso_mri_tpu.models import AEConfig as JaxConfig
    from superresolution_aniso_mri_tpu.models import VanillaACAI as JaxACAI
    from superresolution_aniso_mri_tpu.train.checkpoint import (
        load_checkpoint as jax_load_checkpoint)
    from superresolution_aniso_mri_tpu_torch.config.settings import (
        load_settings)
    from superresolution_aniso_mri_tpu_torch.train import get_trainer
    from torch_port_helpers import numpy_variables

    assert {"settings.yaml", "loss_iters.npz", "losses_train.npz",
            "losses_test.npz"} <= set(os.listdir(exper))
    assert "last.models" in os.listdir(os.path.join(exper, "models"))
    settings = load_settings(os.path.join(exper, "settings.yaml"))
    assert settings["num_devices"] == 2
    port = get_trainer(str(exper), "last", device="cpu")
    assert port.epoch == epochs
    model = JaxACAI(JaxConfig.from_args(settings))
    params, stats = numpy_variables(model, 0)
    jstate, epoch = jax_load_checkpoint(
        os.path.join(exper, "models", "last.models"),
        jax_train_state(model, params, stats, lr=1e-3))
    assert epoch == epochs
    from superresolution_aniso_mri_tpu_torch.models import torch_to_flax

    want, _ = torch_to_flax(port.model.state_dict())
    jax.tree_util.tree_map(
        lambda a, b: np.testing.assert_array_equal(np.asarray(a), b),
        jstate.params, want)


def test_train_brain_on_two_ranks_writes_once_and_loads_in_jax(
        cluster, tmp_path, monkeypatch):
    """As ranks of the cluster (each rank given its own directory), only
    rank 0 writes; through the CLI's launcher (two ranks spawned by
    ``train-brain --num_devices 2``) the experiment is written once and
    the caller gets its trainer back. JAX loads both checkpoints."""
    from superresolution_aniso_mri_tpu_torch.cli import entry, train_loop
    from superresolution_aniso_mri_tpu_torch.parallel import launch

    assert not os.path.exists(cluster / "cli_r1")
    _check_experiment(cluster / "cli_r0" / "x", 1)
    # one intra-op thread in each spawned rank: the tier-1 run's workers
    # share the cores; a hung rank fails the test instead of holding it
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    monkeypatch.setattr(train_loop, "launch", functools.partial(
        launch, timeout_s=120, join_timeout_s=240))
    tr = entry.train_brain(cases.CLI_ARGV + ["-o", str(tmp_path), "-id", "y"])
    assert tr.epoch == 1 and tr.eval_mode
    _check_experiment(tmp_path / "y", 1)
    assert not torch.distributed.is_initialized()
