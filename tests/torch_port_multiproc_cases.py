"""The cases of ``tests/test_torch_port_multiproc.py``, run on every rank
of a gloo cluster of spawned processes on the CPU. Imports torch and the
port only (no JAX): the ranks are fresh interpreters.

Each case builds a data-parallel ``Trainer`` (``num_devices`` = the
world size) and takes one step on a numpy-seeded global batch; rank 0
also builds the single-process ``Trainer`` of the same seed and steps it
on the same global batch, outside the group. Both record the loss
metrics, the gradient that reaches the optimizer (after the all-reduce,
before the clip and Adam), θ before and after, and the BatchNorm
running statistics. Every rank writes ``<case>.r<rank>.npz``.
"""
from __future__ import annotations

import os

import numpy as np
import torch

W = 16           # slices of W × W
B = 4            # global pairs

BASE = dict(model="ae_combined", dataset="OASIS", width=W, latent_width=4,
            depth=4, latent=4, use_batchnorm=True, use_sigmoid=True,
            lr=1e-3, image_mix_loss_func="mse", ex_loss_weight1=0.3,
            epoch_threshold=-1, batch_size=B, seed=3)

CASES = {
    "ae_combined_bn": dict(args={}, batch={}),
    "lanczos3": dict(args=dict(train_latent_interp="lanczos3"),
                     batch=dict(taps=6)),
    "inbetween_laploss": dict(args=dict(use_laploss=True),
                              batch=dict(inbetween=True)),
    "labeled_masks": dict(args=dict(dataset="ACDCLBL", get_masks=True,
                                    colors=2, nclasses=4),
                          batch=dict(labels=True, mask=True)),
    "acai_combined": dict(args=dict(model="acai_combined",
                                    max_grad_norm=0.05), batch={}),
    "vae_combined": dict(args=dict(model="vae_combined", vae_beta=0.1),
                         batch={}),
    "alpha_end_to_end": dict(args=dict(model="alpha_end_to_end",
                                       dataset="ACDC", get_masks=True,
                                       alpha_class="AlphaProbe16v1",
                                       alpha_loss_func="mse"),
                             batch=dict(mask=True, features=True)),
}


def global_batch(seed: int, taps: int = 2, inbetween: bool = False,
                 labels: bool = False, mask: bool = False,
                 features: bool = False) -> dict:
    """The global NCHW batch of a case (numpy-seeded, the same on every
    rank)."""
    rng = np.random.RandomState(seed)

    def img(n):
        x = rng.rand(n, 1, W, W).astype(np.float32)
        if labels:   # (image, class id) planes
            ids = rng.randint(0, 4, (n, 1, W, W)).astype(np.float32)
            x = np.concatenate([x, ids], axis=1)
        return x

    a_to = rng.uniform(0.1, 0.9, B).astype(np.float32)
    batch = {"image": img(2 * B), "slice_between": img(B),
             "alpha_from": 1.0 - a_to, "alpha_to": a_to}
    if taps >= 4:
        batch["outer"] = img(2 * B)
    if taps == 6:
        batch["outer2"] = img(2 * B)
    if inbetween:
        batch["is_inbetween"] = np.array([1, 0, 1, 1], np.float32)
    if mask:
        batch["loss_mask"] = (rng.rand(B, 1, W, W) > 0.3).astype(np.float32)
    if features:
        batch["alpha_features"] = rng.rand(B, 5).astype(np.float32)
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in batch.items()}


def _record(trainer, batch) -> dict:
    """One ``trainer.train`` step on ``batch``: its metrics, the
    optimizer's gradient, θ before and after, the running statistics."""
    seen = {}
    tx = trainer.state.tx
    apply = tx.apply

    def recording(params, grads, state, scalars):
        seen.update({k: g.detach().clone() for k, g in grads.items()})
        return apply(params, grads, state, scalars)

    tx.apply = recording
    try:
        before = {k: p.detach().clone()
                  for k, p in trainer.state.params().items()}
        stats0 = {k: v.clone() for k, v in trainer.model.named_buffers()}
        metrics = trainer.train(batch)
    finally:
        tx.apply = apply
    out = {f"metric/{k}": np.float64(v) for k, v in metrics.items()}
    for k, p in trainer.state.params().items():
        out[f"theta0/{k}"] = before[k].numpy()
        out[f"theta1/{k}"] = p.detach().numpy()
        out[f"grad/{k}"] = seen[k].numpy()
    for k, v in trainer.model.named_buffers():
        out[f"buffer0/{k}"] = stats0[k].numpy()
        out[f"buffer/{k}"] = v.numpy()
    return out


def run_case(name: str, out_dir: str) -> None:
    from superresolution_aniso_mri_tpu_torch.parallel import (
        process_count, process_index)
    from superresolution_aniso_mri_tpu_torch.train import Trainer

    spec = CASES[name]
    args = {**BASE, **spec["args"]}
    batch = global_batch(len(name), **spec["batch"])
    world, rank = process_count(), process_index()
    dp = Trainer({**args, "num_devices": world}, device="cpu")
    res = {f"dp/{k}": v for k, v in _record(dp, batch).items()}
    if rank == 0:
        single = Trainer({**args, "num_devices": 1}, device="cpu")
        res.update({f"single/{k}": v
                    for k, v in _record(single, batch).items()})
    np.savez(os.path.join(out_dir, f"{name}.r{rank}.npz"), **res)


CLI_ARGV = ["-d", "MNIST3D", "--use_synthetic_data", "-m", "ae_combined",
            "--image_mix_loss_func", "mse", "--downsample_steps", "2",
            "--epoch_threshold", "-1", "--width", "16", "--latent_width",
            "4", "--depth", "4", "--latent", "4", "--limited_load", "-b",
            "4", "-bt", "4", "--num_val_batches", "1", "--lr", "1e-3",
            "-e", "1", "--volume_preview_interval", "0",
            "--num_devices", "2", "--device", "cpu"]


def run_cli(out_dir: str) -> None:
    """``train-brain`` as a rank of the running group, each rank into its
    own directory: only rank 0's may exist afterwards."""
    from superresolution_aniso_mri_tpu_torch.cli import entry
    from superresolution_aniso_mri_tpu_torch.parallel import process_index

    root = os.path.join(out_dir, f"cli_r{process_index()}")
    entry.train_brain(CLI_ARGV + ["-o", root, "-id", "x"])


def run_all(out_dir: str) -> None:
    torch.set_num_threads(1)
    for name in CASES:
        run_case(name, out_dir)
    run_cli(out_dir)
