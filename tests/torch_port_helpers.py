"""Shared fixtures of the PyTorch-port parity tests: a small JAX
VanillaACAI with a numpy-seeded parameter tree, a stand-in for the JAX
trainer's serving surface, and the matching port ``ServingModel``."""
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
