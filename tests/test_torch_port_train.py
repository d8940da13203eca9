"""PyTorch port, training: train-mode BatchNorm, the losses, the
optimizer and the train / eval steps of the ae families, held against
the JAX package on the CPU.

Weights come from ``torch_port_helpers.jax_model`` (numpy-seeded), the
batches from numpy seeds; JAX runs at ``default_matmul_precision
("highest")``. Tolerances:

- train-mode BatchNorm against flax: atol 1e-5 (float32), 1e-2
  (bfloat16 activations);
- ``lap_loss``, ``mse`` and the multi-tap latent mixes: atol 1e-6;
- the optimizer against the optax chain on the same gradients: rtol
  1e-5; schedules rtol 1e-5 (optax evaluates them in float32);
- 5 train steps: every metric at every step rtol 1e-4 (bfloat16 2e-2);
  parameters within 2·lr·steps, the most that Adam's near-sign updates
  can drift apart; BatchNorm statistics rtol 1e-4; the Adam moments
  within 1e-3 of their largest entry after the first step and within
  0.1 of it after the fifth (the parameters, and so the gradients,
  have drifted apart by then: near-zero gradient entries flip sign and
  Adam turns each flip into a step of 2·lr). In bfloat16 the two
  frameworks' gradients agree only to a correlation of ~0.95 from the
  same weights (rounding of near-cancelling sums such as conv-bias
  gradients), so there the moments are held to a correlation above 0.9
  after the first step and not compared after the fifth.
"""
import flax.linen as flax_nn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from superresolution_aniso_mri_tpu.ops.lap_pyramid import lap_loss as jax_lap
from superresolution_aniso_mri_tpu.ops.losses import (
    latent_mix_cubic as jax_cubic, latent_mix_lanczos3 as jax_lanczos3,
    mse as jax_mse)
from superresolution_aniso_mri_tpu.train.state import (
    make_optimizer as jax_make_optimizer)
from superresolution_aniso_mri_tpu.train.steps import (
    LossConfig as JaxLossConfig, make_eval_step as jax_make_eval_step,
    make_train_step as jax_make_train_step)
from superresolution_aniso_mri_tpu_torch.models import AEConfig, VanillaACAI
from superresolution_aniso_mri_tpu_torch.models.acai import BatchNorm
from superresolution_aniso_mri_tpu_torch.models.convert import (
    flax_moments_to_torch, torch_to_flax)
from superresolution_aniso_mri_tpu_torch.ops import (lap_loss, mse,
                                                     latent_mix_cubic,
                                                     latent_mix_lanczos3)
from superresolution_aniso_mri_tpu_torch.train import (LossConfig,
                                                       make_eval_step,
                                                       make_optimizer,
                                                       make_train_step)
from superresolution_aniso_mri_tpu_torch.train.state import Schedule
from torch_port_helpers import (SMALL, adam_moments, jax_model,
                                jax_train_state, np_batch,
                                port_train_state, torch_batch)

LR, STEPS, MIX = 1e-4, 5, 0.3
LOSS = dict(model="ae_combined", image_mix_loss_func="mse")


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _jax_batch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


# ---------------------------------------------------------------------------
# train-mode BatchNorm
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype, atol", [("float32", 1e-5),
                                         ("bfloat16", 1e-2)])
def test_train_mode_batchnorm_matches_flax(dtype, atol):
    """Output, updated running statistics and gradients (input, scale,
    bias) against flax's BatchNorm(momentum 0.9, eps 1e-5) in train
    mode; ``update_stats=False`` gives the same output and moves
    nothing."""
    rng = np.random.RandomState(0)
    c = 5
    x = (rng.randn(4, 6, 7, c) * 1.7 + 0.6).astype(np.float32)
    r = rng.randn(4, 6, 7, c).astype(np.float32)
    scale = (1 + 0.3 * rng.randn(c)).astype(np.float32)
    bias = (0.2 * rng.randn(c)).astype(np.float32)
    mean0 = rng.randn(c).astype(np.float32)
    var0 = (0.5 + rng.rand(c)).astype(np.float32)
    jdt = jnp.dtype(dtype)
    tdt = getattr(torch, dtype)

    bn = flax_nn.BatchNorm(use_running_average=False, momentum=0.9,
                           epsilon=1e-5, dtype=jdt, param_dtype=jnp.float32)
    stats = {"mean": mean0, "var": var0}

    def jax_out(xx, sc, bi):
        y, mut = bn.apply({"params": {"scale": sc, "bias": bi},
                           "batch_stats": stats}, xx.astype(jdt),
                          mutable=["batch_stats"])
        return y.astype(jnp.float32), mut["batch_stats"]

    y_j, new_j = jax_out(x, scale, bias)
    grads_j = jax.grad(lambda *a: jnp.sum(jax_out(*a)[0] * r),
                       argnums=(0, 1, 2))(x, scale, bias)

    port = BatchNorm(c)
    with torch.no_grad():
        port.weight.copy_(torch.from_numpy(scale))
        port.bias.copy_(torch.from_numpy(bias))
        port.running_mean.copy_(torch.from_numpy(mean0))
        port.running_var.copy_(torch.from_numpy(var0))
    xt = _nchw(x).requires_grad_(True)
    y_p = port(xt.to(tdt), train=True)
    assert y_p.dtype == tdt
    (y_p.float() * _nchw(r)).sum().backward()
    np.testing.assert_allclose(y_p.detach().float().numpy().transpose(
        0, 2, 3, 1), np.asarray(y_j), atol=atol)
    np.testing.assert_allclose(port.running_mean.numpy(),
                               np.asarray(new_j["mean"]), atol=1e-6)
    np.testing.assert_allclose(port.running_var.numpy(),
                               np.asarray(new_j["var"]), atol=1e-6)
    for got, want in ((xt.grad.numpy().transpose(0, 2, 3, 1), grads_j[0]),
                      (port.weight.grad.numpy(), grads_j[1]),
                      (port.bias.grad.numpy(), grads_j[2])):
        scale_ = float(np.abs(np.asarray(want)).max())
        np.testing.assert_allclose(got, np.asarray(want),
                                   atol=atol * max(1.0, scale_))

    before = (port.running_mean.clone(), port.running_var.clone())
    with torch.no_grad():
        y_frozen = port(xt.to(tdt), train=True, update_stats=False)
    assert torch.equal(port.running_mean, before[0])
    assert torch.equal(port.running_var, before[1])
    np.testing.assert_allclose(y_frozen.float().numpy(),
                               y_p.detach().float().numpy(), atol=atol)


def test_main_forward_advances_running_stats_once():
    """A train step moves every BatchNorm's statistics exactly as one
    train-mode encode → decode of the batch's images does."""
    model, params, stats = jax_model(0)
    state = port_train_state(params, stats, lr=LR)
    twin = port_train_state(params, stats, lr=LR).model
    batch = torch_batch(np_batch(0, taps=6))
    make_train_step(LossConfig(**LOSS, train_latent_interp="lanczos3",
                               use_extra_latent_loss=True))(state, batch, MIX)
    with torch.no_grad():
        twin.decode(twin.encode(batch["image"], train=True), train=True)
    for (name, got), want in zip(state.model.named_buffers(),
                                 twin.buffers()):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6,
                                   atol=1e-7, err_msg=name)


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------

def test_losses_match_jax():
    """lap_loss (odd and even sizes), mse with a mask, and the cubic and
    lanczos3 latent mixes: atol 1e-6."""
    rng = np.random.RandomState(1)
    for shape in ((3, 32, 30, 1), (2, 17, 23, 2)):
        a, b = (rng.rand(*shape).astype(np.float32) for _ in range(2))
        with jax.default_matmul_precision("highest"):
            want = float(jax_lap(a, b))
        assert abs(float(lap_loss(_nchw(a), _nchw(b))) - want) < 1e-6
        m = (rng.rand(*shape) > 0.5).astype(np.float32)
        assert abs(float(mse(_nchw(a), _nchw(b), _nchw(m)))
                   - float(jax_mse(a, b, m))) < 1e-6
    b_, z, z1, z2 = 3, *(rng.randn(6, 4, 4, 5).astype(np.float32)
                         for _ in range(3))
    t = rng.rand(b_).astype(np.float32)
    tz, tz1, tz2 = _nchw(z), _nchw(z1), _nchw(z2)
    np.testing.assert_allclose(
        latent_mix_cubic(tz, tz1, torch.from_numpy(t)).numpy().transpose(
            0, 2, 3, 1), np.asarray(jax_cubic(z, z1, t)), atol=1e-6)
    np.testing.assert_allclose(
        latent_mix_lanczos3(tz, tz1, tz2, torch.from_numpy(t)).numpy()
        .transpose(0, 2, 3, 1), np.asarray(jax_lanczos3(z, z1, z2, t)),
        atol=1e-6)


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------

OPTIMIZERS = {
    "constant": dict(),
    "cosine": dict(cosine_steps=6),
    "warmup": dict(warmup_steps=3),
    "warmup_cosine": dict(warmup_steps=2, cosine_steps=7),
    "clip_decay": dict(max_grad_norm=1.0, weight_decay=0.1, momentum=0.5),
}


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_optimizer_matches_optax(name):
    """8 updates of the same parameters with the same gradients (norms
    around the clip threshold, so some steps clip and some do not):
    parameters and the optimizer state's flax state dict against optax
    (rtol 1e-5)."""
    from flax import serialization

    opt = dict(lr=1e-2, **OPTIMIZERS[name])
    _, params, _ = jax_model(2)
    cfg = AEConfig(**SMALL)
    tx = jax_make_optimizer(**opt)
    jstate = tx.init(params)
    jparams = params
    update = jax.jit(tx.update)
    port = make_optimizer(**opt)
    pparams = flax_moments_to_torch(params, cfg)
    pstate = port.init(pparams)
    rng = np.random.RandomState(3)
    for i in range(8):
        grads = jax.tree_util.tree_map(
            lambda p: rng.randn(*p.shape).astype(np.float32), params)
        norm = np.sqrt(sum(float((g ** 2).sum())
                           for g in jax.tree_util.tree_leaves(grads)))
        grads = jax.tree_util.tree_map(
            lambda g: g * np.float32((0.6 + 0.15 * i) / norm), grads)
        upd, jstate = update(grads, jstate, jparams)
        jparams = optax.apply_updates(jparams, upd)
        port.step(pparams, flax_moments_to_torch(grads, cfg), pstate)
    got_p = torch_to_flax(pparams)[0]
    jax.tree_util.tree_map(
        lambda a, b: np.testing.assert_allclose(b, np.asarray(a), rtol=1e-5,
                                                atol=1e-7),
        jparams, got_p)
    want = serialization.to_state_dict(jstate)
    got = port.opt_state_tree(pstate)
    assert jax.tree_util.tree_structure(want) == \
        jax.tree_util.tree_structure(got)
    jax.tree_util.tree_map(
        lambda a, b: np.testing.assert_allclose(b, np.asarray(a), rtol=1e-5,
                                                atol=1e-8), want, got)
    for a, b in zip(jax.tree_util.tree_leaves(want),
                    jax.tree_util.tree_leaves(got)):
        assert np.asarray(a).dtype == b.dtype


@pytest.mark.parametrize("kw, optax_schedule", [
    (dict(cosine_steps=9), lambda lr: optax.cosine_decay_schedule(lr, 9)),
    (dict(warmup_steps=4), lambda lr: optax.linear_schedule(0.0, lr, 4)),
    (dict(warmup_steps=3, cosine_steps=11),
     lambda lr: optax.warmup_cosine_decay_schedule(0.0, lr, 3, 11, 0.0)),
    (dict(), lambda lr: optax.constant_schedule(lr)),
])
def test_schedules_match_optax(kw, optax_schedule):
    lr = 3e-4
    ours, theirs = Schedule(lr, **kw), optax_schedule(lr)
    for count in range(16):
        np.testing.assert_allclose(ours(count), float(theirs(count)),
                                   rtol=1e-5, atol=1e-12,
                                   err_msg=f"count {count}")
    assert ours(0) == (0.0 if kw.get("warmup_steps") else lr)


# ---------------------------------------------------------------------------
# train and eval steps
# ---------------------------------------------------------------------------

CASES = {
    "bn_linear": dict(),
    "no_bn": dict(model=dict(use_batchnorm=False)),
    "ae_family": dict(loss=dict(model="ae")),
    "laploss_weighted": dict(loss=dict(use_laploss=True)),
    "laploss_unweighted": dict(loss=dict(use_laploss=True),
                               batch=dict(inbetween=False)),
    "loss_mask": dict(loss=dict(use_masks=True), batch=dict(mask=True)),
    "extra_latent": dict(loss=dict(use_extra_latent_loss=True)),
    "cubic": dict(loss=dict(train_latent_interp="cubic"),
                  batch=dict(taps=4)),
    "lanczos3": dict(loss=dict(train_latent_interp="lanczos3"),
                     batch=dict(taps=6)),
    "grad_clip": dict(opt=dict(max_grad_norm=1e-3)),
    "weight_decay": dict(opt=dict(weight_decay=1e-2)),
    "warmup_cosine": dict(opt=dict(warmup_steps=2, cosine_steps=10)),
    "bf16": dict(model=dict(compute_dtype="bfloat16"), rtol=2e-2),
}


def _moments(jax_tree, port_dict):
    """The two moment trees as flat float64 vectors, in one order."""
    got = jax.tree_util.tree_leaves(torch_to_flax(port_dict)[0])
    want = jax.tree_util.tree_leaves(jax_tree)
    return (np.concatenate([np.ravel(x) for x in want]).astype(np.float64),
            np.concatenate([np.ravel(x) for x in got]).astype(np.float64))


def _moment_gap(jax_tree, port_dict):
    """max |Δ| of a moment tree over its largest entry."""
    a, b = _moments(jax_tree, port_dict)
    return float(np.abs(a - b).max() / np.abs(a).max())


@pytest.mark.parametrize("case", sorted(CASES))
def test_train_steps_match_jax(case):
    spec = CASES[case]
    model_kw = spec.get("model", {})
    loss_kw = {**LOSS, **spec.get("loss", {})}
    opt = dict(lr=LR, **spec.get("opt", {}))
    rtol = spec.get("rtol", 1e-4)
    model, params, stats = jax_model(0, **model_kw)
    jstate = jax_train_state(model, params, stats, **opt)
    pstate = port_train_state(params, stats, model_kw, **opt)
    jstep = jax_make_train_step(model, JaxLossConfig(**loss_kw),
                                donate=False)
    pstep = make_train_step(LossConfig(**loss_kw))
    with jax.default_matmul_precision("highest"):
        for i in range(STEPS):
            nb = np_batch(i, **spec.get("batch", {}))
            jstate, jm = jstep(jstate, _jax_batch(nb), jax.random.PRNGKey(i),
                               jnp.float32(MIX))
            pstate, pm = pstep(pstate, torch_batch(nb), MIX)
            assert sorted(pm) == sorted(jm)
            for k in jm:
                assert pm[k].shape == () and not pm[k].requires_grad
                np.testing.assert_allclose(float(pm[k]), float(jm[k]),
                                           rtol=rtol, err_msg=f"step {i} {k}")
            if i == 0:
                _, mu, nu = adam_moments(jstate.opt_state)
                for want, got in ((mu, pstate.opt_state.mu),
                                  (nu, pstate.opt_state.nu)):
                    if rtol <= 1e-4:
                        assert _moment_gap(want, got) < 1e-3
                    else:
                        assert np.corrcoef(*_moments(want, got))[0, 1] > 0.9
    assert pstate.step == int(jstate.step) == STEPS
    got_params, got_stats = torch_to_flax(pstate.model.state_dict())
    drift = jax.tree_util.tree_map(
        lambda a, b: float(np.abs(np.asarray(a) - b).max()), jstate.params,
        got_params)
    assert max(jax.tree_util.tree_leaves(drift)) <= 2 * LR * STEPS
    stat_rtol, stat_atol = (rtol, 1e-6) if rtol <= 1e-4 else (rtol, 1e-3)
    jax.tree_util.tree_map(
        lambda a, b: np.testing.assert_allclose(b, np.asarray(a),
                                                rtol=stat_rtol,
                                                atol=stat_atol),
        jstate.batch_stats, got_stats)
    count, mu, nu = adam_moments(jstate.opt_state)
    assert pstate.opt_state.count == count
    if rtol <= 1e-4:
        assert _moment_gap(mu, pstate.opt_state.mu) < 0.1
        assert _moment_gap(nu, pstate.opt_state.nu) < 0.1


@pytest.mark.parametrize("case", ["bn_linear", "lanczos3", "loss_mask",
                                  "ae_family"])
def test_eval_step_matches_jax(case):
    """Eval-mode losses (rtol 1e-4) and the reconstruction and the
    synthesized slices (atol 1e-5), weighted by mix_weight."""
    spec = CASES[case]
    loss_kw = {**LOSS, **spec.get("loss", {}), "use_laploss": True}
    model, params, stats = jax_model(1)
    pmodel = port_train_state(params, stats, lr=LR).model
    nb = np_batch(7, **spec.get("batch", {}))
    with jax.default_matmul_precision("highest"):
        jm, jaux = jax_make_eval_step(model, JaxLossConfig(**loss_kw))(
            params, stats, _jax_batch(nb), jnp.float32(MIX))
    pm, paux = make_eval_step(LossConfig(**loss_kw))(pmodel, torch_batch(nb),
                                                     MIX)
    assert sorted(pm) == sorted(jm)
    for k in jm:
        np.testing.assert_allclose(float(pm[k]), float(jm[k]), rtol=1e-4,
                                   err_msg=k)
    for k in ("reconstruction", "slice_inbetween_mix"):
        np.testing.assert_allclose(paux[k].numpy().transpose(0, 2, 3, 1),
                                   np.asarray(jaux[k]), atol=1e-5,
                                   err_msg=k)


@pytest.mark.parametrize("loss_kw, item", [
    (dict(model="multichannel"), None),
    (dict(model="alpha_combined"), None),
])
def test_unported_losses_raise(loss_kw, item):
    """Every family builds both steps now: the multichannel and alpha
    families' parity is in ``test_torch_port_labeled_train.py`` and
    ``test_torch_port_alpha.py``; a case with an ``item`` would expect
    NotImplementedError naming it."""
    cfg = LossConfig(**{**LOSS, **loss_kw})
    for build in (make_train_step, make_eval_step):
        if item is None:
            assert callable(build(cfg))
            continue
        with pytest.raises(NotImplementedError, match=item):
            build(cfg)


@pytest.fixture(scope="module")
def perceptual_weights():
    """{'vgg': the VGG LPIPS weights, 'enc': the encoder artifact}, on
    the CPU."""
    import warnings

    from superresolution_aniso_mri_tpu_torch.ops import (
        get_enc_perceptual_params, get_lpips_params)

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return {"vgg": get_lpips_params(device="cpu"),
                "enc": get_enc_perceptual_params(device="cpu")}


@pytest.mark.parametrize("loss_kw", [
    dict(recon_loss="perceptual"),
    dict(image_mix_loss_func="perceptual"),
    dict(image_mix_loss_func="perceptual_enc"),
    dict(use_ssim_loss=True),
], ids=["recon_perceptual", "mix_perceptual", "mix_perceptual_enc",
        "ssim"])
def test_perceptual_and_ssim_losses_build_and_train(loss_kw,
                                                    perceptual_weights):
    """The losses refused before the LPIPS port: both steps build, a
    train step gives finite metrics and moves the weights, and the eval
    step's loss terms are the distance they name on its own outputs
    (rtol 1e-5). Parity with JAX is in test_torch_port_perceptual_train."""
    from superresolution_aniso_mri_tpu_torch.ops import (
        enc_lpips_distance, lpips_distance, ssim_volume)

    cfg = LossConfig(**{**LOSS, **loss_kw})
    lp = perceptual_weights["enc" if "perceptual_enc" in loss_kw.values()
                            else "vgg"]
    _, params, stats = jax_model(0)
    state = port_train_state(params, stats, lr=LR)
    before = [p.detach().clone() for p in state.model.parameters()]
    nb = torch_batch(np_batch(0, inbetween=False))
    _, tm = make_train_step(cfg, lp)(state, nb, MIX)
    assert all(np.isfinite(float(v)) for v in tm.values())
    assert any(not torch.equal(p, q)
               for p, q in zip(before, state.model.parameters()))
    em, aux = make_eval_step(cfg, lp)(state.model, nb, MIX)
    recon, x = aux["reconstruction"], nb["image"]
    if cfg.recon_loss == "perceptual":
        want_dist = lpips_distance(lp, recon, x).mean()
    elif cfg.use_ssim_loss:
        want_dist = (mse(recon, x) + 0.135 * (
            1.0 - ssim_volume(recon[:, 0], x[:, 0], 1.0, 11).mean()))
    else:
        want_dist = mse(recon, x)
    np.testing.assert_allclose(float(em["loss_ae_dist"]), float(want_dist),
                               rtol=1e-5)
    dist_fn = {"perceptual": lpips_distance,
               "perceptual_enc": enc_lpips_distance}.get(
                   cfg.image_mix_loss_func)
    if dist_fn is not None:
        want_mix = dist_fn(lp, nb["slice_between"],
                           aux["slice_inbetween_mix"]).mean()
        np.testing.assert_allclose(float(em["loss_ae_dist_extra"]),
                                   MIX * float(want_mix), rtol=1e-5)


def test_train_step_keeps_metrics_on_the_device():
    """Metrics are detached 0-d tensors on the model's device, and the
    step needs no host copy of any of them."""
    _, params, stats = jax_model(0)
    state = port_train_state(params, stats, lr=LR)
    _, metrics = make_train_step(LossConfig(**LOSS))(
        state, torch_batch(np_batch(0)), torch.tensor(MIX))
    for v in metrics.values():
        assert isinstance(v, torch.Tensor) and v.device.type == "cpu"
        assert v.grad_fn is None
    assert isinstance(state.model, VanillaACAI)
