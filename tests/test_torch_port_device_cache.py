"""PyTorch port, the device slice cache and the training loop's batches
on the CPU: ``DeviceCachedSampler`` batches are bitwise the host
sampler's (and so the JAX package's), ``maybe_device_cache`` gates as
JAX's does, a two-epoch training run gives the same losses with the
cache and without, and the loop trains on the sampler's epoch batches in
order, augmented from the epoch's generator.
"""
import os
import sys

import numpy as np
import pytest
import torch

from superresolution_aniso_mri_tpu.data import TripletSampler as JaxSampler
from superresolution_aniso_mri_tpu.data import Volume as JaxVolume
from superresolution_aniso_mri_tpu.data import device_cache as jcache
from superresolution_aniso_mri_tpu_torch.data import (
    DeviceCachedSampler, TripletSampler, Volume, maybe_device_cache)
from superresolution_aniso_mri_tpu_torch.data.device_cache import (
    cache_nbytes)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = ((12, 20, 24), (9, 24, 18), (15, 22, 22))


def _volumes(cls, seed=0, labels=False):
    rng = np.random.RandomState(seed)
    return [cls(image=rng.rand(*s).astype(np.float32),
                spacing=np.array([2.0 + i, 1.0, 1.0]), patient_id=f"p{i}",
                labels=(rng.randint(0, 4, s).astype(np.int32) if labels
                        else None))
            for i, s in enumerate(SHAPES)]


def _same(got, want):
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        g = got[k].numpy() if isinstance(got[k], torch.Tensor) else got[k]
        assert g.dtype == np.asarray(v).dtype, k
        assert np.array_equal(g, np.asarray(v)), k


@pytest.mark.parametrize("taps", [2, 4, 6])
def test_cached_batches_are_bitwise_the_host_samplers(taps):
    kw = dict(downsample_steps=3, slice_selection="mix", pad_size=26,
              seed=5, latent_taps=taps)
    cached = DeviceCachedSampler(TripletSampler(_volumes(Volume), **kw),
                                 "cpu")
    host = TripletSampler(_volumes(Volume), **kw)
    ref = JaxSampler(_volumes(JaxVolume), **kw)
    assert len(cached) == len(host)
    for _ in range(3):
        want = host.sample_batch(5)
        _same(cached.sample_batch(5), want)
        _same(ref.sample_batch(5), want)
    for got, want in zip(cached.epoch_batches(4), host.epoch_batches(4)):
        _same(got, want)
    assert cached.flat_img.shape == (sum(s[0] for s in SHAPES), 26, 26)


@pytest.mark.parametrize("masks", [False, True])
def test_cached_labels_raise_with_roadmap_item(masks):
    """Labeled samplers (ACDCLBL) cache their label stacks, and with
    ``use_masks`` their loss-mask stacks: the gathered batches are
    bitwise the host sampler's and JAX's, and the budget counts the
    stacks as JAX's ``cache_nbytes`` does."""
    kw = dict(downsample_steps=2, seed=4, use_masks=masks)
    cached = DeviceCachedSampler(
        TripletSampler(_volumes(Volume, labels=True), **kw), "cpu")
    host = TripletSampler(_volumes(Volume, labels=True), **kw)
    ref = JaxSampler(_volumes(JaxVolume, labels=True), **kw)
    for _ in range(2):
        want = host.sample_batch(5)
        _same(cached.sample_batch(5), want)
        _same(ref.sample_batch(5), want)
    for got, want in zip(cached.epoch_batches(4), host.epoch_batches(4)):
        _same(got, want)
    assert cache_nbytes(host) == jcache.cache_nbytes(ref)


@pytest.mark.parametrize("mode, budget_mb, want", [
    ("auto", None, True),
    ("auto", "0.001", False),
    ("1", "0.001", True),
    ("0", None, False),
    ("off", None, False),
    (None, None, True),
])
def test_gating_matches_jax(monkeypatch, mode, budget_mb, want):
    if budget_mb is None:
        monkeypatch.delenv("SR_DEVICE_CACHE_MB", raising=False)
    else:
        monkeypatch.setenv("SR_DEVICE_CACHE_MB", budget_mb)
    port = maybe_device_cache(TripletSampler(_volumes(Volume), 2), mode,
                              "cpu")
    ref = jcache.maybe_device_cache(JaxSampler(_volumes(JaxVolume), 2), mode)
    assert isinstance(port, DeviceCachedSampler) == want
    assert isinstance(ref, jcache.DeviceCachedSampler) == want
    assert cache_nbytes(TripletSampler(_volumes(Volume), 2)) == \
        jcache.cache_nbytes(JaxSampler(_volumes(JaxVolume), 2))
    other = object()
    assert maybe_device_cache(other, "1", "cpu") is other


@pytest.mark.parametrize("env_mb, free, want, oasis_cached", [
    (None, 80 * 2 ** 30, 20 * 2 ** 30, True),   # a quarter of the free
    (None, 4 * 2 ** 30, 2 ** 30, False),
    ("512", 80 * 2 ** 30, 512 * 2 ** 20, False),  # the variable wins
])
def test_auto_budget_on_a_card_follows_its_free_memory(
        monkeypatch, env_mb, free, want, oasis_cached):
    """On a CUDA device ``auto`` budgets a quarter of the free memory, so
    the README's OASIS recipe (200 training patients, 6.8 GB of padded
    slices) is cached on an 80 GB card; ``SR_DEVICE_CACHE_MB`` overrides
    it. No card is needed: ``mem_get_info`` is stubbed."""
    from superresolution_aniso_mri_tpu_torch.data import device_cache

    if env_mb is None:
        monkeypatch.delenv("SR_DEVICE_CACHE_MB", raising=False)
    else:
        monkeypatch.setenv("SR_DEVICE_CACHE_MB", env_mb)
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda device=None: (free, 80 * 2 ** 30))
    budget = device_cache.auto_budget_bytes(torch.device("cuda", 0))
    assert budget == want
    oasis = 200 * 176 * 220 * 220 * 4
    assert (oasis <= budget) == oasis_cached
    monkeypatch.delenv("SR_DEVICE_CACHE_MB", raising=False)
    assert device_cache.auto_budget_bytes("cpu") == 512 * 2 ** 20


def _tiny_oasis_argv(tmp_path, exper_id, mode):
    return ["-d", "OASIS", "-m", "ae_combined", "--image_mix_loss_func",
            "mse", "--downsample_steps", "3", "--width", "16",
            "--latent_width", "8", "--depth", "8", "--latent", "8",
            "-b", "4", "-bt", "4", "--num_val_batches", "2", "--lr", "1e-3",
            "-e", "2", "--aug_patch_size", "24", "--volume_preview_interval",
            "0", "--device", "cpu", "--device_data_cache", mode,
            "-o", str(tmp_path), "-id", exper_id]


def test_training_with_the_cache_equals_training_without(tmp_path,
                                                         monkeypatch):
    """Two epochs of train-brain on a fabricated OASIS tree, random
    recipe on: the same losses with ``--device_data_cache 1`` and 0."""
    sys.path.insert(0, os.path.join(REPO, "tools"))
    import dress_rehearsal

    from superresolution_aniso_mri_tpu_torch.cli import entry

    root = tmp_path / "data"
    dress_rehearsal.make_oasis_tree(str(root), ds=3, n_patients=5)
    monkeypatch.setenv("SR_DATA_ROOT", str(root))
    losses = {}
    for mode in ("1", "0"):
        entry.train_brain(_tiny_oasis_argv(tmp_path, f"cache{mode}", mode))
        with np.load(tmp_path / f"cache{mode}" / "losses_train.npz") as f:
            losses[mode] = {k: f[k] for k in f.files}
    assert sorted(losses["1"]) == sorted(losses["0"])
    for k in losses["0"]:
        assert np.array_equal(losses["1"][k], losses["0"][k]), k


@pytest.mark.parametrize("mode", ["1", "0"])
def test_training_loop_trains_on_the_samplers_epoch_batches(
        tmp_path, monkeypatch, mode):
    """``run_training`` makes each batch on the training thread: the
    sampler's ``epoch_batches`` in order, through ``device_batch`` with
    the epoch's generator from ``(seed, epoch)``, with the cache or
    without."""
    sys.path.insert(0, os.path.join(REPO, "tools"))
    import dress_rehearsal

    from superresolution_aniso_mri_tpu_torch.cli import entry
    from superresolution_aniso_mri_tpu_torch.cli.train_loop import (
        build_augment_config, epoch_generator)
    from superresolution_aniso_mri_tpu_torch.data import device_batch
    from superresolution_aniso_mri_tpu_torch.data.datasets import (
        get_datasets)
    from superresolution_aniso_mri_tpu_torch.train import trainer as tmod

    root = tmp_path / "data"
    dress_rehearsal.make_oasis_tree(str(root), ds=3, n_patients=5)
    monkeypatch.setenv("SR_DATA_ROOT", str(root))
    seen, train = [], tmod.Trainer.train

    def recorded(self, batch):
        seen.append((self.epoch, {k: v.clone() for k, v in batch.items()}))
        return train(self, batch)

    monkeypatch.setattr(tmod.Trainer, "train", recorded)
    trainer = entry.train_brain(_tiny_oasis_argv(tmp_path, "loop", mode))
    args = trainer.args
    sampler = TripletSampler(get_datasets(args)[0], 3,
                             args["slice_selection"], pad_size=24,
                             seed=int(args["seed"]))
    aug = build_augment_config(args)
    want = []
    for epoch in range(2):
        gen = epoch_generator(int(args["seed"]), epoch)
        want += [(epoch, device_batch(raw, aug, "cpu", 2, generator=gen))
                 for raw in sampler.epoch_batches(4)]
    assert len(seen) == len(want) > 2
    for (e_got, got), (e_want, batch) in zip(seen, want):
        assert e_got == e_want and sorted(got) == sorted(batch)
        for k in batch:
            assert torch.equal(got[k], batch[k]), k
