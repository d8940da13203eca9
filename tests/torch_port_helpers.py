"""Shared fixtures of the PyTorch-port parity tests: a small JAX
VanillaACAI with a numpy-seeded parameter tree, a stand-in for the JAX
trainer's serving surface, the matching port ``ServingModel``, seeded
train batches and train states of both packages."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from superresolution_aniso_mri_tpu.models import AEConfig as JaxConfig
from superresolution_aniso_mri_tpu.models import VanillaACAI as JaxACAI

SMALL = dict(width=32, latent_width=8, depth=4, latent=6)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch CPU thread while the tests of a module that imports
    this fixture run: the tier-1 run has 6 workers on the machine's
    cores, and each worker's torch would start a thread per core.
    Restored after the module."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_model(seed=0, **kw):
    """(JAX VanillaACAI, params, batch_stats): the tree's structure from
    ``jax.eval_shape(model.init)`` (no compile), its values from a numpy
    seed, BN running stats away from the identity (which would hide a
    wrong mapping)."""
    model = JaxACAI(JaxConfig(**{**SMALL, **kw}))
    params, stats = numpy_variables(model, seed)
    return model, params, stats


def jax_family_model(ae_class, seed=0, **kw):
    """``jax_model`` for any class of the JAX registry, or
    ``"Discriminator"``."""
    from superresolution_aniso_mri_tpu.models import (Discriminator,
                                                      build_model)

    cfg = JaxConfig(**{**SMALL, **kw})
    model = (Discriminator(cfg) if ae_class == "Discriminator"
             else build_model(ae_class, cfg))
    params, stats = numpy_variables(model, seed)
    return model, params, stats


def numpy_variables(model, seed):
    """(params, batch_stats) of a flax model at ``SMALL``'s width from a
    numpy seed (see ``jax_model``)."""
    return numpy_tree(model, seed, jnp.zeros((1, model.config.width,
                                              model.config.width,
                                              model.config.colors)))


def numpy_tree(model, seed, *inputs):
    """(params, batch_stats) of a flax model called on ``inputs``: the
    structure from ``jax.eval_shape(model.init)``, the values from a
    numpy seed (see ``jax_model``)."""
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), *inputs)
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
    return tree["params"], tree.get("batch_stats", {})


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


def jax_trainer(model, params, stats, args, **opt):
    """A JAX ``Trainer`` over a numpy-seeded tree, built without its
    ``__init__`` (whose eager flax init takes ~27 s on the CPU): the
    attributes that its train, train_many, EMA, TensorBoard, loss-flush
    and encode/decode methods read. ``args`` are its settings (``lr``,
    ``ema_decay``, ``ex_loss_weight1``, ...); ``opt`` go to the
    optimizer."""
    import collections

    from superresolution_aniso_mri_tpu.train import Trainer
    from superresolution_aniso_mri_tpu.train.steps import (
        LossConfig, make_train_step)
    from superresolution_aniso_mri_tpu.train.trainer import (
        weight_annealing_schedule)

    t = object.__new__(Trainer)
    t.args = dict(args)
    t.model, t.model_config = model, model.config
    t.loss_config = LossConfig(model=args.get("model", "ae_combined"),
                               image_mix_loss_func=args.get(
                                   "image_mix_loss_func", "mse"))
    t.family = t.loss_config.family
    t.lpips_params = t.mesh = t.params_sr = t.tb_writer = None
    t._multi_step = t._ema_apply = t._jit_encode = t._jit_decode = None
    t.state = jax_train_state(model, params, stats, **opt)
    t.train_step = make_train_step(model, t.loss_config, donate=False)
    t._rng = jax.random.PRNGKey(0)
    t._iters, t.epoch = 1, 0
    t.loss_weights = weight_annealing_schedule(
        int(args.get("epochs", 1)), float(args.get("ex_loss_weight1", 0.001)))
    t.ema_decay = float(args.get("ema_decay") or 0.0)
    t.ema_params = (jax.tree_util.tree_map(jnp.copy, params)
                    if t.ema_decay > 0 else None)
    for name in ("losses", "losses_test", "mean_losses", "mean_losses_test"):
        setattr(t, name, collections.defaultdict(list))
    t.loss_iters = []
    return t


def jax_eval_trainer(model, params, stats, family="ae"):
    """A JAX ``Trainer`` without ``__init__`` holding what its eval-mode
    methods read (``_ae_params``, ``encode`` / ``decode`` / ``predict``,
    ``load_caisr``, the serving surface)."""
    from superresolution_aniso_mri_tpu.train import Trainer

    t = object.__new__(Trainer)
    t.model, t.model_config, t.family = model, model.config, family
    t.state = jax_train_state(model, params, stats, lr=1e-4)
    t.mesh = t.params_sr = t.lpips_params = None
    t._jit_encode = t._jit_decode = None
    t.args = {"model": "ae_combined"}
    return t


def port_trainer(params, stats, args, model_kw=None):
    """The port's CPU ``Trainer`` of ``args`` with the weights of a flax
    tree."""
    from superresolution_aniso_mri_tpu_torch.models import flax_to_torch
    from superresolution_aniso_mri_tpu_torch.train import Trainer

    t = Trainer({**args, **SMALL, **(model_kw or {})}, device="cpu")
    t.model.load_state_dict(flax_to_torch(params, stats, t.model_config))
    return t


class RecordingWriter:
    """Stand-in for ``tensorboardX.SummaryWriter`` that keeps its calls:
    ``(method, tag, value, step)``."""

    def __init__(self, logdir=None):
        self.logdir = logdir
        self.calls = []
        self.closed = False

    def add_scalar(self, tag, value, step):
        self.calls.append(("scalar", tag, float(value), int(step)))

    def add_image(self, tag, img, step):
        self.calls.append(("image", tag, np.asarray(img), int(step)))

    def add_histogram(self, tag, values, step):
        self.calls.append(("histogram", tag, np.asarray(values), int(step)))

    def close(self):
        self.closed = True
