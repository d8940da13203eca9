"""The cases of ``tests/test_torch_port_mesh2d.py``, run on every rank of
a gloo cluster of 4 spawned processes on the CPU (a dp 2 × mp 2 mesh).
Imports torch and the port only (no JAX): the ranks are fresh
interpreters.

Each case builds a ``Trainer`` of the case's seed on every rank, places
its state on the mesh (``shard_state_2d``) and takes one 2-D step on a
numpy-seeded global batch (the family's noise drawn once by the
trainer); rank 0 also steps a second trainer of the same seed as one
process on the same batch, outside the group. Each records the loss
metrics, the gradient that reaches the optimizer (a rank's shard for a
split kernel), θ before and after, the BatchNorm running statistics
and, from ``gather_state_2d``, the whole state after the step; rank 0
also writes that state as a checkpoint. Every rank writes
``<case>.r<rank>.npz``. A last run makes the model ranks' gradients of
the replicated parameters disagree (``run_disagreeing_backwards``).
"""
from __future__ import annotations

import os

import numpy as np
import torch

from torch_port_multiproc_cases import BASE, global_batch

DP, MP = 2, 2

CASES = {
    "ae_combined_bn": dict(args={}),
    "acai_combined": dict(args=dict(model="acai_combined",
                                    max_grad_norm=0.05)),
    "transpose_decoder": dict(args=dict(use_upsample=False,
                                        max_grad_norm=0.05)),
}


def _step_record(state, step, batch, mix_weight) -> dict:
    """One ``step`` of ``state`` on ``batch``: its metrics, the
    optimizer's gradient, θ before and after, the running statistics."""
    seen = {}
    tx = state.tx
    apply = tx.apply

    def recording(params, grads, opt_state, scalars):
        seen.update({k: g.detach().clone() for k, g in grads.items()})
        return apply(params, grads, opt_state, scalars)

    tx.apply = recording
    try:
        before = {k: p.detach().clone() for k, p in state.params().items()}
        stats0 = {k: v.clone() for k, v in state.model.named_buffers()}
        state, metrics = step(state, batch, mix_weight)
    finally:
        tx.apply = apply
    out = {f"metric/{k}": np.float64(v) for k, v in metrics.items()}
    for k, p in state.params().items():
        out[f"theta0/{k}"] = before[k].numpy()
        out[f"theta1/{k}"] = p.detach().numpy()
        out[f"grad/{k}"] = seen[k].numpy()
    for k, v in state.model.named_buffers():
        out[f"buffer0/{k}"] = stats0[k].numpy()
        out[f"buffer/{k}"] = v.numpy()
    return out


def run_case(name: str, out_dir: str) -> None:
    from superresolution_aniso_mri_tpu_torch.parallel import (
        create_mesh_2d, gather_state_2d, make_sharded_train_step_2d,
        process_count, process_index, shard_state_2d, state_sharding_2d)
    from superresolution_aniso_mri_tpu_torch.train import Trainer
    from superresolution_aniso_mri_tpu_torch.train.checkpoint import (
        save_checkpoint)

    args = {**BASE, **CASES[name]["args"], "num_devices": 1}
    rank = process_index()
    mesh = create_mesh_2d(["cpu"] * process_count(), dp=DP, mp=MP)
    tr = Trainer(args, device="cpu")
    batch = tr.draw_noise(global_batch(len(name)))
    rule = state_sharding_2d(mesh, tr.state)
    state = shard_state_2d(mesh, tr.state)
    step = make_sharded_train_step_2d(tr.loss_config, tr.lpips_params, mesh)
    res = {f"mesh/{k}": v for k, v in _step_record(
        state, step, batch, tr._mix_weight()).items()}
    res.update({f"rule/{k}": np.int64(-1 if d is None else d)
                for k, d in rule.items()})
    try:   # a placed state is not placed again (its shards would mix)
        shard_state_2d(mesh, state)
    except ValueError:
        res["placed_twice_refused"] = np.int64(1)
    full = gather_state_2d(mesh, state)
    res.update({f"full/{k}": p.detach().numpy()
                for k, p in full.params().items()})
    opt = full.opt_state
    for adam in (opt.values() if isinstance(opt, dict) else [opt]):
        res.update({f"full_mu/{k}": v.numpy() for k, v in adam.mu.items()})
        res.update({f"full_nu/{k}": v.numpy() for k, v in adam.nu.items()})
    if rank == 0:
        save_checkpoint(os.path.join(out_dir, f"{name}.models"), full, 1)
        single = Trainer(args, device="cpu")
        res.update({f"single/{k}": v for k, v in _step_record(
            single.state, single.train_step, batch,
            single._mix_weight()).items()})
    np.savez(os.path.join(out_dir, f"{name}.r{rank}.npz"), **res)


def run_disagreeing_backwards(out_dir: str) -> None:
    """The ``acai_combined`` case's step with the backwards of the two
    model ranks made to disagree: model rank 1 hands the optimizer the
    negated gradient of every replicated parameter (on the card the
    ranks' backwards differ by their rounding; here by their sign).
    Every rank writes θ1 to ``disagree.r<rank>.npz``."""
    from superresolution_aniso_mri_tpu_torch.parallel import (
        create_mesh_2d, make_sharded_train_step_2d, process_count,
        process_index, shard_state_2d, state_sharding_2d)
    from superresolution_aniso_mri_tpu_torch.train import Trainer

    args = {**BASE, **CASES["acai_combined"]["args"], "num_devices": 1}
    rank = process_index()
    mesh = create_mesh_2d(["cpu"] * process_count(), dp=DP, mp=MP)
    tr = Trainer(args, device="cpu")
    batch = tr.draw_noise(global_batch(len("acai_combined")))
    replicated = [k for k, d in state_sharding_2d(mesh, tr.state).items()
                  if d is None]
    state = shard_state_2d(mesh, tr.state)
    step = make_sharded_train_step_2d(tr.loss_config, tr.lpips_params, mesh)
    apply = state.tx.apply

    def disagreeing(params, grads, opt_state, scalars):
        if rank % MP == 1:
            grads = {k: -g if k in replicated else g
                     for k, g in grads.items()}
        return apply(params, grads, opt_state, scalars)

    state.tx.apply = disagreeing
    try:
        state, _ = step(state, batch, tr._mix_weight())
    finally:
        state.tx.apply = apply
    np.savez(os.path.join(out_dir, f"disagree.r{rank}.npz"),
             **{f"theta1/{k}": state.params()[k].detach().numpy()
                for k in replicated})


def run_all(out_dir: str) -> None:
    torch.set_num_threads(1)
    for name in CASES:
        run_case(name, out_dir)
    run_disagreeing_backwards(out_dir)
