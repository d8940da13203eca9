"""PyTorch port, training data and the Trainer: the triplet sampler, the
deterministic augmentation and batch split, and a 2-epoch Trainer run,
held against the JAX package on the CPU.

The sampler and the deterministic batch shaping are exact (bitwise
equal batches); the Trainer run writes the JAX Trainer's file names and
npz keys, and its checkpoints reload to the same tensors.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from superresolution_aniso_mri_tpu.cli.train_loop import (
    _device_batch as jax_device_batch)
from superresolution_aniso_mri_tpu.data import (
    AugmentConfig as JaxAugmentConfig, TripletSampler as JaxSampler,
    Volume as JaxVolume, augment_batch as jax_augment_batch)
from superresolution_aniso_mri_tpu.data.transforms import (
    prepare_batch_pairs as jax_pairs, prepare_batch_quintets as jax_quintets,
    prepare_batch_septets as jax_septets)
from superresolution_aniso_mri_tpu_torch.data import (
    AugmentConfig, TripletSampler, Volume, augment_batch, device_batch,
    prepare_batch_pairs, prepare_batch_quintets, prepare_batch_septets)
from torch_port_helpers import SMALL, jax_model

SHAPES = ((12, 20, 24), (9, 24, 18), (15, 22, 22))


def _volumes(cls, seed=0, labels=False):
    rng = np.random.RandomState(seed)
    vols = []
    for i, shape in enumerate(SHAPES):
        lbl = rng.randint(0, 4, shape).astype(np.int32) if labels else None
        vols.append(cls(image=rng.rand(*shape).astype(np.float32),
                        spacing=np.array([2.0 + i, 1.0, 1.0]),
                        patient_id=f"p{i}", labels=lbl))
    return vols


def _assert_batches_equal(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert np.array_equal(got[k], want[k]), k


@pytest.mark.parametrize("taps", [2, 4, 6])
@pytest.mark.parametrize("selection", ["adjacent", "adjacent_plus", "mix"])
def test_triplet_sampler_batches_are_bitwise_jax(taps, selection):
    kw = dict(downsample_steps=3, slice_selection=selection, pad_size=26,
              seed=11, latent_taps=taps)
    port = TripletSampler(_volumes(Volume), **kw)
    ref = JaxSampler(_volumes(JaxVolume), **kw)
    assert len(port) == len(ref) and port.pad_size == ref.pad_size
    for _ in range(3):
        _assert_batches_equal(port.sample_batch(5), ref.sample_batch(5))
    for got, want in zip(port.epoch_batches(4), ref.epoch_batches(4)):
        _assert_batches_equal(got, want)
    _assert_batches_equal(port.sample_item(7), ref.sample_item(7))


def test_triplet_sampler_label_channels_are_bitwise_jax():
    kw = dict(downsample_steps=2, seed=3)
    port = TripletSampler(_volumes(Volume, labels=True), **kw)
    ref = JaxSampler(_volumes(JaxVolume, labels=True), **kw)
    _assert_batches_equal(port.sample_batch(4), ref.sample_batch(4))


def test_triplet_sampler_masks_raise():
    with pytest.raises(NotImplementedError, match="item 6"):
        TripletSampler(_volumes(Volume, labels=True), 2, use_masks=True)


AUG_CASES = {
    "pad_then_crop": ((26, 26), dict(patch_size=16, aug_patch_size=24)),
    "mixed_sizes": ((20, 30), dict(patch_size=24)),
    "as_is": ((16, 16), dict(patch_size=16)),
    "aug_pad_only": ((14, 18), dict(patch_size=16, aug_patch_size=22)),
}


def _det(**kw):
    return dict(random_crop=False, rot90=False, intensity=False, **kw)


@pytest.mark.parametrize("case", sorted(AUG_CASES))
def test_deterministic_augment_matches_jax(case):
    (h, w), kw = AUG_CASES[case]
    x = np.random.RandomState(2).rand(3, h, w, 5).astype(np.float32)
    want = np.asarray(jax_augment_batch(jax.random.PRNGKey(0), jnp.asarray(x),
                                        JaxAugmentConfig(**_det(**kw))))
    got = augment_batch(torch.from_numpy(x).permute(0, 3, 1, 2),
                        AugmentConfig(**_det(**kw)))
    assert np.array_equal(got.permute(0, 2, 3, 1).numpy(), want)


@pytest.mark.parametrize("flag", [
    "rot90", "intensity", "rotate_any", "noise", "blur", "mirror", "elastic",
    "perspective", "random_crop", "crop_next_to_center"])
def test_random_augment_raises(flag):
    cfg = AugmentConfig(**{**_det(patch_size=16), flag: True})
    x = torch.zeros(2, 3, 20, 20)
    with pytest.raises(NotImplementedError, match="item 6"):
        augment_batch(x, cfg)


def test_random_crop_is_not_drawn_when_no_crop_is_needed():
    """As in JAX, a crop switch does nothing on a batch already at the
    patch size."""
    x = torch.rand(2, 3, 16, 16)
    cfg = AugmentConfig(patch_size=16, rot90=False, intensity=False)
    assert torch.equal(augment_batch(x, cfg), x)


@pytest.mark.parametrize("c", [1, 2])
def test_batch_splits_match_jax(c):
    rng = np.random.RandomState(c)
    for slots, jfn, pfn in ((3, jax_pairs, prepare_batch_pairs),
                            (5, jax_quintets, prepare_batch_quintets),
                            (7, jax_septets, prepare_batch_septets)):
        x = rng.rand(2, 8, 9, slots * c).astype(np.float32)
        want = jfn(jnp.asarray(x))
        got = pfn(torch.from_numpy(x).permute(0, 3, 1, 2))
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert np.array_equal(g.permute(0, 2, 3, 1).numpy(),
                                  np.asarray(w))
    with pytest.raises(ValueError, match="channels"):
        prepare_batch_pairs(torch.zeros(2, 4, 8, 8))


@pytest.mark.parametrize("taps", [2, 4, 6])
def test_device_batch_matches_jax(taps):
    """Sampler → upload → augment → split, against the JAX train loop's
    ``_device_batch`` on the same sampler batch."""
    sampler = TripletSampler(_volumes(Volume), 3, pad_size=26, seed=4,
                             latent_taps=taps)
    raw = sampler.sample_batch(3)
    cfg = _det(patch_size=16, aug_patch_size=24)
    want = jax_device_batch(raw, JaxAugmentConfig(**cfg),
                            jax.random.PRNGKey(0), latent_taps=taps)
    got = device_batch(raw, AugmentConfig(**cfg), "cpu", latent_taps=taps)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        g = got[k].numpy()
        if g.ndim == 4:
            assert got[k].is_contiguous()
            g = g.transpose(0, 2, 3, 1)
        assert np.array_equal(g, np.asarray(v)), k


# ---------------------------------------------------------------------------
# Trainer
# ---------------------------------------------------------------------------

ARGS = dict(model="ae_combined", dataset="OASIS", **SMALL,
            use_batchnorm=True, use_sigmoid=True, lr=1e-4, epochs=2,
            image_mix_loss_func="mse", ex_loss_weight1=0.3,
            epoch_threshold=0, batch_size=4, downsample_steps=3, seed=0)


def _run_two_epochs(trainer, to_batch):
    sampler = TripletSampler(_volumes(Volume), 3, pad_size=32, seed=1)
    val = TripletSampler(_volumes(Volume), 3, pad_size=32, seed=2)
    trainer.prepare_run()
    for _ in range(2):
        for _ in range(2):
            trainer.train(to_batch(sampler.sample_batch(4)))
        trainer.validate(to_batch(val.sample_batch(4)))
        trainer.show_loss_on_tensorboard("train")
        trainer.show_loss_on_tensorboard("test")
        trainer.reset_losses()
        trainer.end_epoch_processing()


def _fast_jax_train_state(model, rng, sample, lr, *opt):
    """create_train_state without the eager flax init: the tree from
    ``jax.eval_shape``, values from a numpy seed."""
    from superresolution_aniso_mri_tpu.train.state import (SRTrainState,
                                                           make_optimizer)
    _, params, stats = jax_model(0, use_batchnorm=True, use_sigmoid=True)
    return SRTrainState.create(apply_fn=model.apply, params=params,
                               tx=make_optimizer(lr, *opt),
                               batch_stats=stats)


def test_trainer_writes_the_jax_experiment_files(tmp_path, monkeypatch):
    """Two epochs (epoch_threshold 0) write models/1.models, ae.models,
    caisr.models, last.models and the three npz archives, with the JAX
    Trainer's names and keys; last.models reloads to the same tensors
    and the resumed trainer gets its history back."""
    from superresolution_aniso_mri_tpu.train import trainer as jax_trainer
    from superresolution_aniso_mri_tpu_torch.train import Trainer

    monkeypatch.setattr(jax_trainer, "create_train_state",
                        _fast_jax_train_state)
    jax_dir, port_dir = tmp_path / "jax", tmp_path / "port"
    cfg = AugmentConfig(**_det(patch_size=32))
    jcfg = JaxAugmentConfig(**_det(patch_size=32))
    jt = jax_trainer.Trainer(dict(ARGS, output_dir=str(jax_dir)))
    _run_two_epochs(jt, lambda raw: jax_device_batch(
        raw, jcfg, jax.random.PRNGKey(0)))
    pt = Trainer(dict(ARGS, output_dir=str(port_dir)), device="cpu")
    _run_two_epochs(pt, lambda raw: device_batch(raw, cfg, "cpu"))

    names = sorted(os.listdir(port_dir / "models"))
    assert names == sorted(os.listdir(jax_dir / "models"))
    assert names == ["1.models", "ae.models", "caisr.models", "last.models"]
    for npz in ("loss_iters.npz", "losses_train.npz", "losses_test.npz"):
        got, want = np.load(port_dir / npz), np.load(jax_dir / npz)
        assert sorted(got.files) == sorted(want.files), npz
        for k in want.files:
            assert got[k].shape == want[k].shape, (npz, k)
    assert list(np.load(port_dir / "loss_iters.npz")["loss_iters"]) == [3, 5]
    assert not [n for n in os.listdir(port_dir / "models")
                if n.endswith(".tmp")]

    again = Trainer(dict(ARGS, output_dir=str(port_dir)), device="cpu",
                    seed=9)
    again.load(str(port_dir / "models" / "last.models"))
    assert again.epoch == 2 and again.iters == 5
    for k, v in pt.model.state_dict().items():
        assert torch.equal(again.model.state_dict()[k], v), k
    for k, v in pt.state.opt_state.mu.items():
        assert torch.equal(again.state.opt_state.mu[k], v), k
    assert again.mean_losses == pt.mean_losses
    serving = pt.serving_model(device="cpu")
    for k, v in pt.model.state_dict().items():
        assert torch.equal(serving._ae_model().state_dict()[k], v), k


@pytest.mark.parametrize("extra, item", [
    (dict(ema_decay=0.999), "item 7"),
    (dict(steps_per_dispatch=4), "item 7"),
    (dict(log_tensorboard=True), "item 7"),
    (dict(num_devices=2), "item 11"),
    (dict(ae_class="VAE"), "item 9"),
    (dict(model="alpha"), "item 9"),
    (dict(dataset="ACDCLBL"), "item 9"),
    (dict(image_mix_loss_func="perceptual"), "item 8"),
    (dict(use_percept_loss=True), "item 8"),
])
def test_trainer_raises_for_what_is_not_ported(extra, item):
    from superresolution_aniso_mri_tpu_torch.train import Trainer

    with pytest.raises(NotImplementedError, match=item):
        Trainer(dict(ARGS, **extra), device="cpu")


def test_trainer_defaults_to_cuda(monkeypatch):
    from superresolution_aniso_mri_tpu_torch.train import Trainer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(dict(ARGS))
