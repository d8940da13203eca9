"""PyTorch port, the alpha-probe families (``alpha``,
``alpha_end_to_end``, ``alpha_only``, ``alpha_combined``): the probes,
``SELayer`` and ``AlphaDecoder``, ``alpha_mix``, the train and eval
steps, the trainer's routing and checkpoints, held against the JAX
package on the CPU.

Weights are numpy-seeded trees on ``jax.eval_shape``
(``torch_port_helpers.numpy_tree``), batches numpy-seeded; JAX runs at
``default_matmul_precision("highest")``; the models are small (width
16, latent_width 4, depth 4, latent 4, so every mixing scheme has its
own coefficient count). Tolerances:

- forwards (probes in eval and train mode, their BatchNorm statistics,
  SELayer, AlphaDecoder): atol 1e-5;
- ``alpha_mix``: atol 1e-6;
- one step's gradient of each variant, leaf by leaf: within 1e-3 of
  the leaf's largest entry of JAX's float64 gradient, and exactly zero
  where JAX's is (``alpha_only``'s autoencoder, whose loss is cut off
  by its gradient stops). This is the check of each variant's gradient
  stops. JAX's own float32 gradient is no oracle here: the train-mode
  BatchNorms amplify its rounding to 6.1e-3 of a leaf's largest entry
  (``alpha_end_to_end``, the probe's BatchNorm scale), where the
  port's float32 gradient stays within 3.3e-4 of the float64 one;
- 3 train steps of each variant at the cardiac recipe's lr 1e-5: every
  metric at every step rtol 1e-4 (atol 1e-6 for values near 0, such as
  a mean coefficient), the BatchNorm statistics rtol 1e-4 (atol 1e-5),
  the Adam counts equal; the parameters' movement θ3 − θ0 within 0.1 of
  its largest entry (3·lr) for 99.5 % of the entries. Adam's first
  steps are near-sign steps of size lr whatever the gradient's size, so
  a parameter gap cannot tell two update rules apart, but an entry
  whose update changed sign moves 2·lr·steps the other way. Entries
  whose gradient lies within the float32 rounding of JAX's do that too:
  99.87 % of ``alpha``'s agree, 99.96 % to 100 % of the others';
  ``alpha_only``'s autoencoder bitwise unchanged;
- eval steps: losses rtol 1e-4 (atol 1e-6), the predicted coefficients,
  reconstruction and synthesized slices atol 1e-5;
- checkpoints: the port's file of a JAX state is byte-equal to JAX's and
  each package restores the other's exactly; serving: the port's alpha
  experiment serves exactly as its ``ae`` and within atol 1e-5 of JAX's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from superresolution_aniso_mri_tpu.models import AEConfig as JaxConfig
from superresolution_aniso_mri_tpu.models import AlphaDecoder as JaxAlphaDecoder
from superresolution_aniso_mri_tpu.models import SELayer as JaxSELayer
from superresolution_aniso_mri_tpu.models import VanillaACAI as JaxACAI
from superresolution_aniso_mri_tpu.models import (
    make_alpha_probe as jax_make_alpha_probe)
from superresolution_aniso_mri_tpu.train.state import (
    SRTrainState, make_optimizer as jax_make_optimizer)
from superresolution_aniso_mri_tpu.train.steps import (
    LossConfig as JaxLossConfig, alpha_mix as jax_alpha_mix,
    make_eval_step as jax_make_eval_step,
    make_train_step as jax_make_train_step)
from superresolution_aniso_mri_tpu_torch.models import (
    AEConfig, AlphaDecoder, SELayer, VanillaACAI, flax_to_torch,
    make_alpha_probe, torch_to_flax)
from superresolution_aniso_mri_tpu_torch.train import (LossConfig,
                                                       create_train_state,
                                                       make_eval_step,
                                                       make_train_step)
from superresolution_aniso_mri_tpu_torch.train.steps import alpha_mix
from torch_port_helpers import (np_batch, numpy_tree,
                                one_torch_thread,  # autouse
                                torch_batch)

CFG = dict(width=16, latent_width=4, depth=4, latent=4, use_batchnorm=True,
           use_sigmoid=True)
LW, LAT = CFG["latent_width"], CFG["latent"]
CLASSES = ("AlphaProbe", "AlphaProbev2", "AlphaProbe16v1", "AlphaProbe16v2",
           "AlphaProbe16Convex", "AlphaProbe16ExBN", "AlphaProbe256v1")
SCHEME = {"AlphaProbe": "pair", "AlphaProbev2": "pair",
          "AlphaProbe16v1": "halves", "AlphaProbe16v2": "halves",
          "AlphaProbe16ExBN": "halves", "AlphaProbe16Convex": "convex",
          "AlphaProbe256v1": "spatial"}
LR, STEPS, MIX, B = 1e-5, 3, 0.3, 2


def _highest():
    return jax.default_matmul_precision("highest")


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().numpy().transpose(0, 2, 3, 1)


def _jax_probe(name, bn, seed=0):
    probe = jax_make_alpha_probe(name, JaxConfig(**CFG), additional_dims=5,
                                 use_batchnorm=bn)
    params, stats = numpy_tree(probe, seed, jnp.zeros((1, LW, LW, 2 * LAT)),
                               jnp.zeros((1, 5)))
    return probe, params, stats


def _port(module, params, stats):
    module.load_state_dict(flax_to_torch(params, stats, None, module))
    return module


def _probe_inputs(seed, b=3):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, LW, LW, 2 * LAT).astype(np.float32),
            rng.rand(b, 5).astype(np.float32))


def _variables(params, stats):
    return {"params": params, **({"batch_stats": stats} if stats else {})}


@pytest.mark.parametrize("bn", [False, True])
@pytest.mark.parametrize("name", CLASSES)
def test_probe_forward_matches_jax(name, bn):
    """Every probe class with and without its BatchNorm: the eval-mode
    output, and in train mode the output and the moved statistics
    (atol 1e-5); the flax names map one to one (``flax_to_torch``
    raises on a missing or extra layer)."""
    probe, params, stats = _jax_probe(name, bn, seed=3)
    port = _port(make_alpha_probe(name, AEConfig(**CFG), additional_dims=5,
                                  use_batchnorm=bn), params, stats)
    z, f = _probe_inputs(4)
    with _highest():
        want = probe.apply(_variables(params, stats), z, f)
        if bn:
            want_tr, moved = probe.apply(_variables(params, stats), z, f,
                                         train=True, mutable=["batch_stats"])
    with torch.no_grad():
        got = port(_nchw(z), torch.from_numpy(f))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
        assert got.shape[1] == {"pair": 2, "halves": 2 * LAT,
                                "convex": LAT,
                                "spatial": LW * LW}[SCHEME[name]]
        if bn:
            got_tr = port(_nchw(z), torch.from_numpy(f), train=True)
            np.testing.assert_allclose(got_tr.numpy(), np.asarray(want_tr),
                                       atol=1e-5)
            _, got_stats = torch_to_flax(port.state_dict())
            jax.tree_util.tree_map(
                lambda a, b: np.testing.assert_allclose(b, np.asarray(a),
                                                        atol=1e-5),
                moved["batch_stats"], got_stats)


def test_probe_layouts_are_flax_names():
    """AlphaProbe256v1 at latent_width 16, latent 128 (the cardiac
    recipe): the NHWC flatten of 8 channels × 256 + 5 features into
    bias-free Dense layers [2053, 64], [64, 2053], [2053, 256], and
    AlphaProbe16v1's [261, 512] → [512, 256] with its biases as flax
    has them."""
    cfg = AEConfig(width=64, latent_width=16, latent=128)
    shapes = {}
    for name in ("AlphaProbe256v1", "AlphaProbe16v1"):
        params, _ = torch_to_flax(make_alpha_probe(
            name, cfg, additional_dims=5).state_dict())
        shapes[name] = {k: {leaf: v.shape for leaf, v in sub.items()}
                        for k, sub in params.items() if k.startswith("Dense")}
        assert set(params["_CompressZ_0"]) == {"Conv_0"}
    assert shapes["AlphaProbe256v1"] == {
        "Dense_0": {"kernel": (2053, 64)}, "Dense_1": {"kernel": (64, 2053)},
        "Dense_2": {"kernel": (2053, 256)}}
    assert shapes["AlphaProbe16v1"] == {
        "Dense_0": {"kernel": (261, 512), "bias": (512,)},
        "Dense_1": {"kernel": (512, 256)}}


def test_se_layer_and_alpha_decoder_match_jax():
    """SELayer (reduction 4 on 8 channels) and AlphaDecoder, whose flax
    ``Decoder_0`` is the port's ``decoder`` (atol 1e-5)."""
    rng = np.random.RandomState(5)
    x = rng.randn(2, 5, 5, 8).astype(np.float32)
    se = JaxSELayer(reduction=4)
    params, _ = numpy_tree(se, 1, jnp.zeros((1, 5, 5, 8)))
    port = _port(SELayer(8, reduction=4), params, {})
    with _highest():
        want = se.apply({"params": params}, x)
    with torch.no_grad():
        np.testing.assert_allclose(_nhwc(port(_nchw(x))), np.asarray(want),
                                   atol=1e-5)
    dm = JaxAlphaDecoder(JaxConfig(**CFG))
    params, stats = numpy_tree(dm, 2, jnp.zeros((1, LW, LW, LAT)))
    assert list(params) == ["Decoder_0"]
    port = _port(AlphaDecoder(AEConfig(**CFG)), params, stats).eval()
    z = rng.randn(3, LW, LW, LAT).astype(np.float32)
    with _highest():
        want = dm.apply({"params": params, "batch_stats": stats}, z)
    with torch.no_grad():
        np.testing.assert_allclose(_nhwc(port(_nchw(z))), np.asarray(want),
                                   atol=1e-5)


@pytest.mark.parametrize("scheme, n", [
    ("pair", 2), ("convex", LAT), ("halves", 2 * LAT), ("spatial", LW * LW),
    ("", 2), ("", LAT), ("", 2 * LAT), ("", LW * LW)])
def test_alpha_mix_matches_jax(scheme, n):
    """The four schemes, named and chosen from the count (atol 1e-6);
    ``pair`` also on a dense [B, d] latent."""
    rng = np.random.RandomState(n)
    a = rng.rand(3, n).astype(np.float32)
    z1, z3 = (rng.randn(3, LW, LW, LAT).astype(np.float32) for _ in range(2))
    want = jax_alpha_mix(a, z1, z3, n, LAT, scheme)
    got = alpha_mix(torch.from_numpy(a), _nchw(z1), _nchw(z3), n, LAT, scheme)
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), atol=1e-6)
    if n == 2:
        d1, d3 = rng.randn(3, 7).astype(np.float32), rng.randn(3, 7).astype(
            np.float32)
        np.testing.assert_allclose(
            alpha_mix(torch.from_numpy(a), torch.from_numpy(d1),
                      torch.from_numpy(d3), 2, LAT, scheme).numpy(),
            np.asarray(jax_alpha_mix(a, d1, d3, 2, LAT, scheme)), atol=1e-6)


@pytest.mark.parametrize("scheme", ["convex", "halves", "spatial"])
def test_alpha_mix_raises_on_dense_latents(scheme):
    """Only ``pair`` takes a dense latent; the others raise ValueError
    in both packages."""
    a, z = np.ones((2, 4), np.float32), np.ones((2, 4), np.float32)
    with pytest.raises(ValueError, match="conv latents"):
        jax_alpha_mix(a, z, z, 4, 4, scheme)
    with pytest.raises(ValueError, match="conv latents"):
        alpha_mix(torch.from_numpy(a), torch.from_numpy(z),
                  torch.from_numpy(z), 4, 4, scheme)


# ---------------------------------------------------------------------------
# train and eval steps
# ---------------------------------------------------------------------------

# each variant with a probe of another scheme; masks and the probe's
# BatchNorm where JAX reaches them. AlphaProbe256v1's bottleneck is one
# unit wide at this size (37 // 32): its probe is drawn from a seed whose
# ReLU stays open on every batch here, so that the probe carries a
# gradient (test_gradient_matches_jax_float64 counts the zero leaves)
CASES = {
    "alpha": dict(probe="AlphaProbe", bn=False, masks=True),
    "alpha_end_to_end": dict(probe="AlphaProbe16v1", bn=True, masks=False),
    "alpha_only": dict(probe="AlphaProbe16Convex", bn=True, masks=False),
    "alpha_combined": dict(probe="AlphaProbe256v1", bn=False, masks=True,
                           probe_seed=100),
}


def _alpha_models(variant, seed=0):
    """(JAX models, params, stats, port ModuleDict) of a variant."""
    spec = CASES[variant]
    jcfg = JaxConfig(**CFG)
    ae = JaxACAI(jcfg)
    probe = jax_make_alpha_probe(spec["probe"], jcfg, additional_dims=5,
                                 use_batchnorm=spec["bn"])
    w = CFG["width"]
    trees = {"ae": numpy_tree(ae, seed, jnp.zeros((1, w, w, 1))),
             "probe": numpy_tree(probe, spec.get("probe_seed", seed + 1),
                                 jnp.zeros((1, LW, LW, 2 * LAT)),
                                 jnp.zeros((1, 5)))}
    models = {"ae": ae, "probe": probe}
    cfg = AEConfig(**CFG)
    port = torch.nn.ModuleDict({
        "ae": VanillaACAI(cfg),
        "probe": make_alpha_probe(spec["probe"], cfg, additional_dims=5,
                                  use_batchnorm=spec["bn"])})
    if variant == "alpha_combined":
        models["decoder_mix"] = JaxAlphaDecoder(jcfg)
        trees["decoder_mix"] = numpy_tree(models["decoder_mix"], seed + 2,
                                          jnp.zeros((1, LW, LW, LAT)))
        port["decoder_mix"] = AlphaDecoder(cfg)
    params = {k: v[0] for k, v in trees.items()}
    stats = {k: v[1] for k, v in trees.items()}
    return models, params, stats, _port(port, params, stats)


def _loss_kw(variant):
    spec = CASES[variant]
    n = {"pair": 2, "halves": 2 * LAT, "convex": LAT,
         "spatial": LW * LW}[SCHEME[spec["probe"]]]
    return dict(model=variant, image_mix_loss_func="mse",
                use_masks=spec["masks"], num_alphas=n,
                alpha_scheme=SCHEME[spec["probe"]], latent=LAT)


def _alpha_batch(seed, masks):
    nb = np_batch(seed, b=B, hw=CFG["width"], mask=masks)
    nb["alpha_features"] = np.random.RandomState(seed + 50).rand(
        B, 5).astype(np.float32)
    return nb


def _states(variant):
    models, params, stats, port = _alpha_models(variant)
    jstate = SRTrainState.create(apply_fn=models["ae"].apply, params=params,
                                 tx=jax_make_optimizer(lr=LR),
                                 batch_stats=stats)
    return models, jstate, create_train_state(port, LR)


def _close(got, want, what):
    np.testing.assert_allclose(float(got), float(want), rtol=1e-4, atol=1e-6,
                               err_msg=what)


@pytest.mark.parametrize("variant", sorted(CASES))
def test_train_steps_match_jax(variant):
    models, jstate, pstate, = _states(variant)
    theta0 = [np.asarray(a) for a in jax.tree_util.tree_leaves(
        jstate.params)]
    loss_kw = _loss_kw(variant)
    jstep = jax_make_train_step(models, JaxLossConfig(**loss_kw),
                                donate=False)
    pstep = make_train_step(LossConfig(**loss_kw))
    ae_before = {k: v.clone() for k, v in
                 pstate.model["ae"].state_dict().items()}
    with _highest():
        for i in range(STEPS):
            nb = _alpha_batch(i, CASES[variant]["masks"])
            jstate, jm = jstep(jstate, {k: jnp.asarray(v)
                                        for k, v in nb.items()},
                               jax.random.PRNGKey(i), jnp.float32(MIX))
            pstate, pm = pstep(pstate, torch_batch(nb), MIX)
            assert sorted(pm) == sorted(jm)
            for k in jm:
                _close(pm[k], jm[k], f"step {i} {k}")
    got_params, got_stats = torch_to_flax(pstate.model.state_dict())
    want, got = ([np.asarray(a) - b for a, b in zip(
        jax.tree_util.tree_leaves(t), theta0)]
        for t in (jstate.params, got_params))
    top = max(float(np.abs(a).max()) for a in want)
    gap = np.concatenate([np.ravel(np.abs(a - b)) for a, b in zip(want,
                                                                  got)])
    assert np.mean(gap <= 0.1 * top) >= 0.995, (np.mean(gap <= 0.1 * top),
                                                top)
    jax.tree_util.tree_map(
        lambda a, b: np.testing.assert_allclose(b, np.asarray(a), rtol=1e-4,
                                                atol=1e-5),
        jstate.batch_stats, {k: got_stats.get(k, {})
                             for k in jstate.batch_stats})
    assert pstate.opt_state.count == pstate.step == int(jstate.step) == STEPS
    if variant == "alpha_only":
        after = pstate.model["ae"].state_dict()
        assert all(torch.equal(v, after[k]) for k, v in ae_before.items())


def _jax_float64_gradient(variant, params, stats, nb):
    """JAX's gradient of ``variant``'s loss (its ``_alpha_losses``) in
    float64, as numpy leaves in ``tree_leaves`` order."""
    from superresolution_aniso_mri_tpu.models import config as jax_config
    from superresolution_aniso_mri_tpu.train.steps import (
        _alpha_losses as jax_alpha_losses)

    spec = CASES[variant]
    with jax.enable_x64(True):
        dtypes = dict(jax_config._DTYPES)
        jax_config._DTYPES["float64"] = jnp.float64
        try:
            jcfg = JaxConfig(**{**CFG, "compute_dtype": "float64"})
            models = {"ae": JaxACAI(jcfg), "probe": jax_make_alpha_probe(
                spec["probe"], jcfg, additional_dims=5,
                use_batchnorm=spec["bn"])}
            if variant == "alpha_combined":
                models["decoder_mix"] = JaxAlphaDecoder(jcfg)
            f64 = jax.tree_util.tree_map(
                lambda a: jnp.asarray(a, jnp.float64), (params, stats, nb))
            grads = jax.jit(jax.grad(lambda p, s, b: jax_alpha_losses(
                models, JaxLossConfig(**_loss_kw(variant)), None, p, s, b,
                jnp.float64(MIX))[0]))(*f64)
            return [np.asarray(g) for g in jax.tree_util.tree_leaves(grads)]
        finally:
            jax_config._DTYPES.clear()
            jax_config._DTYPES.update(dtypes)


@pytest.mark.parametrize("variant", sorted(CASES))
def test_gradient_matches_jax_float64(variant):
    """One step's gradient of every parameter leaf against JAX's float64
    gradient of the same loss (see the module docstring): within 1e-3 of
    the leaf's largest entry, exactly zero where JAX's is."""
    from superresolution_aniso_mri_tpu_torch.train.steps import (
        _alpha_losses)

    _, params, stats, port = _alpha_models(variant)
    nb = _alpha_batch(3, CASES[variant]["masks"])
    want = _jax_float64_gradient(variant, params, stats, nb)
    loss, _ = _alpha_losses(port, LossConfig(**_loss_kw(variant)), None,
                            torch_batch(nb), MIX)
    named = dict(port.named_parameters())
    grads = torch.autograd.grad(loss, list(named.values()),
                                allow_unused=True)
    got, _ = torch_to_flax({k: torch.zeros_like(p) if g is None else g
                            for (k, p), g in zip(named.items(), grads)})
    got = jax.tree_util.tree_leaves(got)
    assert len(got) == len(want)
    zeros = 0
    for i, (g, w) in enumerate(zip(got, want)):
        top = np.abs(w).max()
        zeros += top == 0
        assert np.abs(g - w).max() <= 1e-3 * top, (i, top)
    assert zeros == (len(want) - sum(
        1 for k in named if not k.startswith("ae."))
        if variant == "alpha_only" else 0)


@pytest.mark.parametrize("variant", sorted(CASES))
def test_eval_steps_match_jax(variant):
    """Eval mode with the probe's coefficients: every loss, the
    coefficients (``pred_alphas``), the reconstruction and the
    synthesized slices (decoder_mix's for alpha_combined)."""
    models, params, stats, port = _alpha_models(variant, seed=4)
    loss_kw = {**_loss_kw(variant), "use_laploss": True}
    nb = _alpha_batch(9, CASES[variant]["masks"])
    with _highest():
        jm, jaux = jax_make_eval_step(models, JaxLossConfig(**loss_kw))(
            params, stats, {k: jnp.asarray(v) for k, v in nb.items()},
            jnp.float32(MIX))
    pm, paux = make_eval_step(LossConfig(**loss_kw))(port, torch_batch(nb),
                                                     MIX)
    assert sorted(pm) == sorted(jm)
    for k in jm:
        _close(pm[k], jm[k], k)
    np.testing.assert_allclose(paux["pred_alphas"].numpy(),
                               np.asarray(jaux["pred_alphas"]), atol=1e-5)
    for k in ("reconstruction", "slice_inbetween_mix"):
        np.testing.assert_allclose(_nhwc(paux[k]), np.asarray(jaux[k]),
                                   atol=1e-5, err_msg=k)


@pytest.mark.parametrize("build", ["train", "eval"])
def test_batch_without_alpha_features_raises(build):
    """Both packages raise KeyError for a batch without
    ``alpha_features``, in the train and in the eval step."""
    models, jstate, pstate = _states("alpha_end_to_end")
    loss_kw = _loss_kw("alpha_end_to_end")
    nb = np_batch(0, b=B, hw=CFG["width"])
    jb = {k: jnp.asarray(v) for k, v in nb.items()}
    with pytest.raises(KeyError, match="alpha_features"):
        if build == "train":
            jax_make_train_step(models, JaxLossConfig(**loss_kw),
                                donate=False)(jstate, jb,
                                              jax.random.PRNGKey(0),
                                              jnp.float32(MIX))
        else:
            jax_make_eval_step(models, JaxLossConfig(**loss_kw))(
                jstate.params, jstate.batch_stats, jb)
    with pytest.raises(KeyError, match="alpha_features"):
        if build == "train":
            make_train_step(LossConfig(**loss_kw))(pstate, torch_batch(nb),
                                                   MIX)
        else:
            make_eval_step(LossConfig(**loss_kw))(pstate.model,
                                                  torch_batch(nb))


# ---------------------------------------------------------------------------
# checkpoints, trainer, serving
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("variant", ["alpha_end_to_end", "alpha_combined"])
def test_checkpoints_are_byte_equal_and_load_both_ways(variant, tmp_path):
    """A JAX state after 2 steps (``probe`` with its BatchNorm, or
    ``decoder_mix``), saved by JAX, loads in the port (weights,
    statistics, every Adam moment and count); the port saves it back
    byte for byte, and JAX restores the port's file exactly."""
    from superresolution_aniso_mri_tpu.train.checkpoint import (
        load_checkpoint as jax_load, save_checkpoint as jax_save)
    from superresolution_aniso_mri_tpu_torch.train.checkpoint import (
        load_checkpoint, save_checkpoint)

    models, jstate, pstate = _states(variant)
    fresh = jstate
    jstep = jax_make_train_step(models, JaxLossConfig(**_loss_kw(variant)),
                                donate=False)
    with _highest():
        for i in range(2):
            jstate, _ = jstep(jstate, {k: jnp.asarray(v) for k, v in
                                       _alpha_batch(i, False).items()},
                              jax.random.PRNGKey(i), jnp.float32(MIX))
    jax_file, port_file = tmp_path / "jax.models", tmp_path / "port.models"
    jax_save(str(jax_file), jstate, 3)
    pstate, epoch = load_checkpoint(str(jax_file), pstate)
    assert epoch == 3 and pstate.opt_state.count == 2
    save_checkpoint(str(port_file), pstate, 3)
    assert port_file.read_bytes() == jax_file.read_bytes()
    back, epoch = jax_load(str(port_file), fresh)
    assert epoch == 3
    for a, b in ((back.params, jstate.params),
                 (back.batch_stats, jstate.batch_stats),
                 (back.opt_state, jstate.opt_state)):
        jax.tree_util.tree_map(
            lambda x, y: np.testing.assert_array_equal(np.asarray(x),
                                                       np.asarray(y)), a, b)


TRAINER_ARGS = dict(dataset="ACDC", lr=LR, ex_loss_weight1=0.05, seed=3,
                    epoch_threshold=-1, **CFG)


@pytest.mark.parametrize("args", [
    dict(model="alpha"),
    dict(model="alpha_end_to_end", alpha_class="AlphaProbe256v1",
         use_percept_loss=False, alpha_loss_func="mse", get_masks=True),
    dict(model="alpha_only", alpha_class="AlphaProbe16Convex"),
    dict(model="alpha_combined", alpha_class="AlphaProbe16ExBN",
         weight_decay=0.1, momentum=0.5),
    dict(model="alpha", alpha_class="AlphaProbev2", dataset="ACDCLBL",
         use_laploss=True, latent=6),
])
def test_loss_config_matches_jax(args):
    """``loss_config_from_args`` of both packages agree field by field
    (the count and scheme of the probe class, ``alpha_loss_func`` with
    its fallback, ACDCLBL keeping the alpha flag)."""
    import dataclasses

    from superresolution_aniso_mri_tpu.train.trainer import (
        loss_config_from_args as jax_loss_config)
    from superresolution_aniso_mri_tpu_torch.train import (
        loss_config_from_args)

    full = {**TRAINER_ARGS, **args}
    want = dataclasses.asdict(jax_loss_config(full))
    got = dataclasses.asdict(loss_config_from_args(full))
    assert got == {k: v for k, v in want.items() if k in got}
    assert sorted(got) == sorted(want)


@pytest.mark.parametrize("variant", sorted(CASES))
def test_trainer_trains_checkpoints_and_reloads(variant, tmp_path):
    """``Trainer(-m <variant>, device="cpu")`` builds the ``{"ae",
    "probe"[, "decoder_mix"]}`` model with the probe class's 5-feature
    probe under ONE Adam without weight decay, takes two steps on
    batches with ``alpha_features``, validates (``pred_alphas`` in its
    predictions), writes its checkpoints (``caisr.models`` on
    ``loss_ae_dist_extra``) and reloads them exactly."""
    from superresolution_aniso_mri_tpu_torch.train import Trainer, get_trainer
    from superresolution_aniso_mri_tpu_torch.train.state import Optimizer

    spec = CASES[variant]
    args = dict(TRAINER_ARGS, model=variant, alpha_class=spec["probe"],
                use_batchnorm_probe=spec["bn"], weight_decay=0.5,
                output_dir=str(tmp_path))
    t = Trainer(args, device="cpu")
    want_keys = {"ae", "probe"} | ({"decoder_mix"}
                                   if variant == "alpha_combined" else set())
    assert set(t.model.keys()) == want_keys
    assert isinstance(t.state.tx, Optimizer) and t.state.tx.weight_decay == 0
    assert t.num_alphas == _loss_kw(variant)["num_alphas"]
    assert t._caisr_selection_key() == "loss_ae_dist_extra"
    t.prepare_run()
    for i in range(2):
        t.train(torch_batch(_alpha_batch(i, False)))
    t.validate(torch_batch(_alpha_batch(5, False)))
    assert t.test_predictions["pred_alphas"].shape == (B, t.num_alphas)
    t.show_loss_on_tensorboard("train")
    t.show_loss_on_tensorboard("test")
    t.end_epoch_processing()
    for name in ("0", "ae", "caisr", "last"):
        back = get_trainer(str(tmp_path), name, eval_mode=False, device="cpu")
        want_sd = t.model.state_dict()
        for k, v in back.model.state_dict().items():
            assert torch.equal(v, want_sd[k]), (name, k)
        assert back.state.opt_state.count == 2
        for k, v in back.state.opt_state.mu.items():
            assert torch.equal(v, t.state.opt_state.mu[k])


def test_serving_an_alpha_experiment_serves_its_ae(tmp_path):
    """An alpha experiment's checkpoint serves through its ``ae``: the
    port's ``get_trainer`` gives the volume of a ``ServingModel`` of the
    ``ae`` state exactly (and ``ServingModel.from_flax`` of the whole
    tree selects the ``ae``), and JAX serving the same file's ``ae``
    gives it within atol 1e-5."""
    from superresolution_aniso_mri_tpu.infer import (
        create_super_volume as jax_csv)
    from superresolution_aniso_mri_tpu.train.checkpoint import (
        load_checkpoint_raw as jax_raw)
    from superresolution_aniso_mri_tpu_torch.infer import (ServingModel,
                                                           create_super_volume)
    from superresolution_aniso_mri_tpu_torch.train import Trainer, get_trainer
    from torch_port_helpers import JaxServingStub

    args = dict(TRAINER_ARGS, model="alpha_combined", output_dir=str(tmp_path))
    t = Trainer(args, device="cpu")
    t.prepare_run()
    t.train(torch_batch(_alpha_batch(0, False)))
    t.end_epoch_processing()
    served = get_trainer(str(tmp_path), "last", device="cpu")
    vol = np.random.RandomState(2).rand(7, 16, 16).astype(np.float32)
    kw = dict(downsample_steps=3, alpha_range=[1 / 3, 2 / 3],
              generate_inbetween_slices=True)
    got = create_super_volume(served, vol, **kw)["upsampled_image"]
    cfg = served.model_config
    ae_sd = served.model["ae"].state_dict()
    np.testing.assert_array_equal(
        got, create_super_volume(ServingModel(cfg, ae_sd, device="cpu"), vol,
                                 **kw)["upsampled_image"])
    raw = jax_raw(str(tmp_path / "models" / "last.models"))
    assert sorted(raw["model_dict_ae"]) == ["ae", "decoder_mix", "probe"]
    whole = ServingModel.from_flax(cfg, raw["model_dict_ae"],
                                   raw["batch_stats"], device="cpu")
    np.testing.assert_array_equal(
        got, create_super_volume(whole, vol, **kw)["upsampled_image"])
    stub = JaxServingStub(JaxACAI(JaxConfig(**CFG)), raw["model_dict_ae"]["ae"],
                          raw["batch_stats"]["ae"])
    with _highest():
        want = jax_csv(stub, vol, **kw)["upsampled_image"]
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-5)


def test_device_batch_uploads_alpha_features():
    """``device_batch`` carries the sampler's ``alpha_features`` [B, 5]
    exactly, and no such key when the sampler gives none."""
    from superresolution_aniso_mri_tpu_torch.data import (AugmentConfig,
                                                          device_batch)

    rng = np.random.RandomState(0)
    raw = {"triplet": rng.rand(2, 16, 16, 3).astype(np.float32),
           "alpha_from": np.full(2, 0.5, np.float32),
           "alpha_to": np.full(2, 0.5, np.float32),
           "alpha_features": rng.rand(2, 5).astype(np.float32)}
    cfg = AugmentConfig(patch_size=16, random_crop=False, rot90=False,
                        intensity=False)
    np.testing.assert_array_equal(
        device_batch(raw, cfg, "cpu")["alpha_features"].numpy(),
        raw["alpha_features"])
    del raw["alpha_features"]
    assert "alpha_features" not in device_batch(raw, cfg, "cpu")
