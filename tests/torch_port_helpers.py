"""Shared fixtures of the PyTorch-port parity tests: a small JAX
VanillaACAI with a numpy-seeded parameter tree, a stand-in for the JAX
trainer's serving surface, the matching port ``ServingModel``, seeded
train batches and train states of both packages."""
import jax
import jax.numpy as jnp
import numpy as np

from superresolution_aniso_mri_tpu.models import AEConfig as JaxConfig
from superresolution_aniso_mri_tpu.models import VanillaACAI as JaxACAI

SMALL = dict(width=32, latent_width=8, depth=4, latent=6)


def jax_model(seed=0, **kw):
    """(JAX VanillaACAI, params, batch_stats): the tree's structure from
    ``jax.eval_shape(model.init)`` (no compile), its values from a numpy
    seed, BN running stats away from the identity (which would hide a
    wrong mapping)."""
    model = JaxACAI(JaxConfig(**{**SMALL, **kw}))
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 32, 32, model.config.colors)))
    rng = np.random.RandomState(seed)

    def fill(path, leaf):
        name = str(getattr(path[-1], "key", path[-1]))
        if name == "var":
            return 0.5 + rng.rand(*leaf.shape).astype(np.float32)
        if name == "scale":
            return 1.0 + 0.2 * rng.randn(*leaf.shape).astype(np.float32)
        fan_in = np.prod(leaf.shape[:-1]) if name == "kernel" else 25.0
        return (rng.randn(*leaf.shape) / np.sqrt(fan_in)).astype(np.float32)

    tree = jax.tree_util.tree_map_with_path(fill, shapes)
    return model, tree["params"], tree.get("batch_stats", {})


class JaxServingStub:
    """The part of the JAX Trainer that create_super_volume(s) reads."""

    params_sr = None

    def __init__(self, model, params, batch_stats):
        self.model_config = model.config
        self._model = model
        self._params = (params, batch_stats)

    def _ae_model(self):
        return self._model

    def _ae_params(self):
        return self._params


def serving_pair(seed=0, **kw):
    """(JAX stand-in trainer, port ServingModel on the CPU) with the same
    weights."""
    from superresolution_aniso_mri_tpu_torch.infer import ServingModel
    from superresolution_aniso_mri_tpu_torch.models import AEConfig

    model, params, stats = jax_model(seed, **kw)
    port = ServingModel.from_flax(AEConfig(**{**SMALL, **kw}), params,
                                  stats, device="cpu")
    return JaxServingStub(model, params, stats), port


def np_batch(seed=0, b=2, hw=32, taps=2, inbetween=True, mask=False):
    """A numpy-seeded NHWC train batch of the (2B ∥ B) contract, with
    ``outer``/``outer2`` for 4/6 latent taps."""
    rng = np.random.RandomState(seed)

    def img(n):
        return rng.rand(n, hw, hw, 1).astype(np.float32)

    a_to = rng.uniform(0.1, 0.9, b).astype(np.float32)
    batch = {"image": img(2 * b), "slice_between": img(b),
             "alpha_from": (1.0 - a_to).astype(np.float32),
             "alpha_to": a_to}
    if taps >= 4:
        batch["outer"] = img(2 * b)
    if taps == 6:
        batch["outer2"] = img(2 * b)
    if inbetween:
        batch["is_inbetween"] = (np.arange(b) % 2 == 0).astype(np.float32)
    if mask:
        batch["loss_mask"] = (rng.rand(b, hw, hw, 1) > 0.3).astype(np.float32)
    return batch


def torch_batch(batch, device="cpu"):
    """The port's NCHW tensors of an ``np_batch``."""
    import torch

    return {k: torch.from_numpy(np.ascontiguousarray(
        v.transpose(0, 3, 1, 2) if v.ndim == 4 else v)).to(device)
        for k, v in batch.items()}


def jax_train_state(model, params, stats, **opt):
    """A JAX SRTrainState without an eager ``model.init``."""
    from superresolution_aniso_mri_tpu.train.state import (SRTrainState,
                                                           make_optimizer)

    return SRTrainState.create(apply_fn=model.apply, params=params,
                               tx=make_optimizer(**opt), batch_stats=stats)


def port_train_state(params, stats, model_kw=None, device="cpu", **opt):
    """The port's TrainState with the weights of a flax tree."""
    from superresolution_aniso_mri_tpu_torch.models import (AEConfig,
                                                            VanillaACAI,
                                                            flax_to_torch)
    from superresolution_aniso_mri_tpu_torch.train import create_train_state

    cfg = AEConfig(**{**SMALL, **(model_kw or {})})
    model = VanillaACAI(cfg)
    model.load_state_dict(flax_to_torch(params, stats, cfg))
    return create_train_state(model.to(device), **opt)


def adam_moments(opt_state):
    """(count, mu, nu) of the ScaleByAdamState inside a make_optimizer
    chain state."""
    leaves = jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda x: hasattr(x, "mu") and hasattr(x, "nu"))
    adam = next(x for x in leaves if hasattr(x, "mu"))
    return int(adam.count), adam.mu, adam.nu
