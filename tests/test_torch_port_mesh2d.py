"""PyTorch port, the 2-D data × model mesh on 4 gloo ranks on the CPU
(``parallel/mesh.py``'s ``create_mesh_2d`` / ``state_sharding_2d`` /
``shard_state_2d`` / ``gather_state_2d`` / ``make_sharded_train_step_2d``,
the model group's collectives in ``parallel/distributed.py``, the split
convs of ``models/acai.py`` and the optimizer's norm across shards).

One module-scoped cluster of four spawned ranks (dp 2 × mp 2) runs every
case of ``torch_port_mesh2d_cases`` in turn. Each case holds the 2-D step
against the port's single-process step on the same global batch, with
the gates of ``test_torch_port_multiproc.py``: the loss metrics
(rtol 1e-4), the gradient assembled from the shards entry by entry
(2e-5 of each leaf's largest entry), the BatchNorm running statistics
and θ − θ0. The ``ae_combined`` BN case is also held against JAX's
``make_sharded_train_step_2d`` on a dp 2 × mp 2 CPU mesh. The split
kernels hold ``cout / mp`` channels on each rank, the replicated leaves
are the same bits on every rank, also when the model ranks' backwards
disagree, and JAX loads the state that ``gather_state_2d`` gives. A
rank-free test holds the port's partition rule against JAX's
``state_sharding_2d`` for each family's tree.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_mesh2d_cases as cases
import torch_port_multiproc_cases as dp_cases
from test_torch_port_multiproc import GRAD_RTOL, _assert_theta_steps_match
from torch_port_helpers import jax_train_state, one_torch_thread  # noqa: F401

WORLD = cases.DP * cases.MP


@pytest.fixture(scope="module")
def cluster(tmp_path_factory):
    from superresolution_aniso_mri_tpu_torch.parallel import launch

    out = tmp_path_factory.mktemp("ranks")
    launch(cases.run_all, (str(out),), ["cpu"] * WORLD, "gloo",
           timeout_s=120, join_timeout_s=240)
    return out


def _load(root, name, rank):
    with np.load(os.path.join(root, f"{name}.r{rank}.npz")) as f:
        return dict(f)


def _leaves(res, prefix):
    return {k[len(prefix):]: v for k, v in res.items() if k.startswith(prefix)}


def _ranks(root, name):
    return [_load(root, name, r) for r in range(WORLD)]


def _assembled(ranks, prefix, rule):
    """The whole leaves of data row 0 from its model ranks' shards."""
    row = [_leaves(r, prefix) for r in ranks[:cases.MP]]
    return {k: (np.concatenate([r[k] for r in row], axis=rule[k])
                if rule[k] >= 0 else row[0][k]) for k in row[0]}


@pytest.mark.parametrize("name", sorted(cases.CASES))
def test_2d_step_is_the_single_process_step(cluster, name):
    ranks = _ranks(cluster, name)
    rule = {k: int(v) for k, v in _leaves(ranks[0], "rule/").items()}
    single = _leaves(ranks[0], "single/")
    want_m = _leaves(single, "metric/")
    for r in ranks:
        got_m = _leaves(r, "mesh/metric/")
        assert sorted(got_m) == sorted(want_m) and "loss_ae" in got_m
        for k in want_m:
            np.testing.assert_allclose(got_m[k], want_m[k], rtol=1e-4,
                                       atol=1e-7, err_msg=k)
    grads = _leaves(single, "grad/")
    got_g = _assembled(ranks, "mesh/grad/", rule)
    assert sorted(got_g) == sorted(grads)
    for leaf, want in grads.items():
        gap = np.abs(got_g[leaf] - want).max()
        assert gap <= GRAD_RTOL * np.abs(want).max(), (leaf, gap)
    for leaf, want in _leaves(single, "buffer/").items():
        np.testing.assert_allclose(_leaves(ranks[0], "mesh/buffer/")[leaf],
                                   want, rtol=1e-5, atol=1e-7, err_msg=leaf)
    _assert_theta_steps_match(_assembled(ranks, "mesh/theta0/", rule),
                              _assembled(ranks, "mesh/theta1/", rule),
                              _leaves(single, "theta0/"),
                              _leaves(single, "theta1/"), grads)


@pytest.mark.parametrize("name", sorted(cases.CASES))
def test_2d_shards_replicas_and_gathered_state(cluster, name):
    """Each split kernel holds ``cout / mp`` channels (dim 0 of a conv,
    dim 1 of a transposed conv) on each rank, the ranks of a model
    column hold the same shard, every replicated leaf and statistic is
    the same bits on all four ranks, and ``gather_state_2d`` gives the
    shards put together, its moments equal on every rank; placing the
    placed state again raises."""
    ranks = _ranks(cluster, name)
    assert all(r.get("placed_twice_refused") == 1 for r in ranks)
    rule = {k: int(v) for k, v in _leaves(ranks[0], "rule/").items()}
    split = [k for k, d in rule.items() if d >= 0]
    assert split and any(d < 0 for d in rule.values())
    if name == "transpose_decoder":
        assert {rule[k] for k in split if ".ups." in k} == {1}
    full = _leaves(ranks[0], "full/")
    for k in split:
        d = rule[k]
        for r in ranks:
            assert r[f"mesh/theta1/{k}"].shape[d] * cases.MP == \
                full[k].shape[d], k
    for prefix in ("mesh/theta1/", "mesh/grad/", "mesh/buffer/"):
        for r in range(WORLD):
            for k, v in _leaves(ranks[r], prefix).items():
                same = ranks[r % cases.MP if rule.get(k, -1) >= 0 else 0]
                np.testing.assert_array_equal(v, same[prefix + k],
                                              err_msg=f"{prefix}{k} r{r}")
    assembled = _assembled(ranks, "mesh/theta1/", rule)
    for r in ranks:
        for k, v in _leaves(r, "full/").items():
            np.testing.assert_array_equal(v, assembled[k], err_msg=k)
        for mom in ("full_mu/", "full_nu/"):
            for k, v in _leaves(r, mom).items():
                np.testing.assert_array_equal(v, ranks[0][mom + k])
                assert v.shape == full[k].shape


def test_2d_replicated_leaves_agree_when_backwards_differ(cluster):
    """When the model ranks' gradients of a replicated parameter differ
    (here one is the other's negation), the step averages them over the
    model group: every replicated parameter is the same bits on all
    four ranks after it."""
    ranks = _ranks(cluster, "disagree")
    assert ranks[0]
    for r in ranks[1:]:
        assert sorted(r) == sorted(ranks[0])
        for k, v in r.items():
            np.testing.assert_array_equal(v, ranks[0][k], err_msg=k)


def _jax_model(args):
    from superresolution_aniso_mri_tpu.models import AEConfig as JaxConfig
    from superresolution_aniso_mri_tpu.models import VanillaACAI as JaxACAI

    return JaxACAI(JaxConfig(**{k: args[k] for k in (
        "width", "latent_width", "depth", "latent", "use_batchnorm",
        "use_sigmoid")}, use_upsample=bool(args.get("use_upsample", True))))


def test_2d_step_matches_jax_2d_step(cluster):
    """The ``ae_combined`` BN case against JAX's 2-D step on a dp 2 ×
    mp 2 CPU mesh from the same weights and global batch."""
    from superresolution_aniso_mri_tpu.parallel import (
        create_mesh_2d, make_sharded_train_step_2d, shard_batch,
        shard_state_2d)
    from superresolution_aniso_mri_tpu.train.trainer import (
        loss_config_from_args)
    from superresolution_aniso_mri_tpu_torch.models import torch_to_flax

    name = "ae_combined_bn"
    ranks = _ranks(cluster, name)
    rule = {k: int(v) for k, v in _leaves(ranks[0], "rule/").items()}
    mesh_res = _leaves(ranks[0], "mesh/")
    args = {**dp_cases.BASE, **cases.CASES[name]["args"]}
    model = _jax_model(args)
    params0, stats0 = torch_to_flax({
        **_assembled(ranks, "mesh/theta0/", rule),
        **_leaves(mesh_res, "buffer0/")})
    params1, stats1 = torch_to_flax({
        **_assembled(ranks, "mesh/theta1/", rule),
        **_leaves(mesh_res, "buffer/")})
    grads, _ = torch_to_flax(_assembled(ranks, "mesh/grad/", rule))
    batch = {k: (v.numpy().transpose(0, 2, 3, 1) if v.ndim == 4
                 else v.numpy())
             for k, v in dp_cases.global_batch(len(name)).items()}
    mesh = create_mesh_2d(jax.devices()[:WORLD], dp=cases.DP, mp=cases.MP)
    step = make_sharded_train_step_2d(model, loss_config_from_args(args),
                                      None, mesh)
    with jax.default_matmul_precision("highest"), mesh:
        state = shard_state_2d(mesh, jax_train_state(
            model, params0, stats0, lr=float(args["lr"])))
        new, metrics = step(state, shard_batch(mesh, batch),
                            jax.random.PRNGKey(0),
                            jnp.float32(args["ex_loss_weight1"]))
    np.testing.assert_allclose(mesh_res["metric/loss_ae"],
                               float(metrics["loss_ae"]), rtol=1e-4)
    flat = jax.tree_util.tree_flatten_with_path

    def named(tree):
        return {jax.tree_util.keystr(p): np.asarray(v)
                for p, v in flat(tree)[0]}

    got0, got1, want1 = named(params0), named(params1), named(new.params)
    assert sorted(got1) == sorted(want1)
    _assert_theta_steps_match(got0, got1, got0, want1, named(grads))
    jax.tree_util.tree_map(
        lambda a, b: np.testing.assert_allclose(np.asarray(a), b,
                                                rtol=1e-5, atol=1e-7),
        new.batch_stats, stats1)


@pytest.mark.parametrize("name", ["ae_combined_bn", "transpose_decoder"])
def test_gathered_state_loads_in_jax(cluster, name):
    """Rank 0's checkpoint of ``gather_state_2d``'s state loads into a
    JAX train state: the parameters and Adam moments are the gathered
    ones, bit for bit."""
    from superresolution_aniso_mri_tpu.train.checkpoint import (
        load_checkpoint as jax_load_checkpoint)
    from superresolution_aniso_mri_tpu_torch.models import torch_to_flax
    from torch_port_helpers import adam_moments

    r0 = _load(cluster, name, 0)
    args = {**dp_cases.BASE, **cases.CASES[name]["args"]}
    model = _jax_model(args)
    params, stats = torch_to_flax({**_leaves(r0, "full/"),
                                   **_leaves(r0, "mesh/buffer/")})
    template = jax_train_state(
        model, jax.tree_util.tree_map(np.zeros_like, params),
        jax.tree_util.tree_map(np.zeros_like, stats), lr=1e-3,
        max_grad_norm=float(args.get("max_grad_norm", 0.0)))
    state, epoch = jax_load_checkpoint(
        os.path.join(cluster, f"{name}.models"), template)
    assert epoch == 1
    count, mu, nu = adam_moments(state.opt_state)
    assert count == 1
    for tree, want in ((state.params, params),
                       (mu, torch_to_flax(_leaves(r0, "full_mu/"))[0]),
                       (nu, torch_to_flax(_leaves(r0, "full_nu/"))[0]),
                       (state.batch_stats, stats)):
        jax.tree_util.tree_map(
            lambda a, b: np.testing.assert_array_equal(np.asarray(a), b),
            tree, want)


RULE_CASES = {**{k: v["args"] for k, v in dp_cases.CASES.items()},
              "transpose_decoder": dict(use_upsample=False)}


@pytest.mark.parametrize("name", sorted(RULE_CASES))
def test_partition_rule_matches_jax(name):
    """For each family's tree and for mp 2, 3 and 4, the port shards the
    leaves that JAX's ``state_sharding_2d`` shards (its flax tree made
    from the port's weights), along the output-channel dim."""
    from jax.sharding import PartitionSpec as P

    from superresolution_aniso_mri_tpu.parallel import mesh as jax_mesh
    from superresolution_aniso_mri_tpu_torch.models import torch_to_flax
    from superresolution_aniso_mri_tpu_torch.models.convert import (
        _torch_path)
    from superresolution_aniso_mri_tpu_torch.parallel import (
        create_mesh_2d, state_sharding_2d)
    from superresolution_aniso_mri_tpu_torch.train import Trainer

    args = {**dp_cases.BASE, **RULE_CASES[name], "num_devices": 1}
    tr = Trainer(args, device="cpu")
    params, _ = torch_to_flax(tr.model.state_dict())
    for mp in (2, 3, 4):
        jmesh = jax_mesh.create_mesh_2d(jax.devices()[:2 * mp], dp=2, mp=mp)
        specs = jax.tree_util.tree_flatten_with_path(
            jax_mesh.state_sharding_2d(jmesh, params))[0]
        want = set()
        for path, sharding in specs:
            if sharding.spec != P():
                keys = [p.key for p in path]
                assert keys[-1] == "kernel"
                want.add(_torch_path(keys[:-1]) + ".weight")
        rule = state_sharding_2d(create_mesh_2d(["cpu"] * 2 * mp, mp=mp),
                                 tr.state)
        assert sorted(rule) == sorted(tr.state.params())
        assert {k for k, d in rule.items() if d is not None} == want, mp
        for k, d in rule.items():
            if d is not None:
                assert d == (1 if ".ups." in k else 0), k


def test_create_mesh_2d_raises_jax_value_error():
    from superresolution_aniso_mri_tpu.parallel import (
        create_mesh_2d as jax_create_mesh_2d)
    from superresolution_aniso_mri_tpu_torch.parallel import (
        MODEL_AXIS, create_mesh_2d)

    for dp, mp in ((3, 2), (None, 3)):
        with pytest.raises(ValueError) as want:
            jax_create_mesh_2d(jax.devices()[:4], dp=dp, mp=mp)
        with pytest.raises(ValueError) as got:
            create_mesh_2d(["cpu"] * 4, dp=dp, mp=mp)
        assert str(got.value) == str(want.value)
    mesh = create_mesh_2d(["cpu"] * 4, mp=2)
    assert (mesh.dp, mesh.mp, mesh.shape[MODEL_AXIS]) == (2, 2, 2)
    assert mesh.flat == [torch.device("cpu")] * 4
