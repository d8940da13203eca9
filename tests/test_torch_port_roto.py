"""PyTorch port, MNISTRoto (item 15): ``data.synthetic.RotoTripletSampler``
bitwise against the JAX package's (phantoms, and digits from a small
idx3-ubyte file written here, train and val pools), and
``train-brain -d MNISTRoto`` through the port's CLI on the CPU (the
sampler's batches with their ``alpha_features``, an alpha family
included). ``tests/test_torch_port_cli.py`` holds the refusal of a
multi-tap ``--train_latent_interp``."""
import gzip
import os
import struct

import numpy as np
import pytest

from superresolution_aniso_mri_tpu.data.synthetic import (
    RotoTripletSampler as JaxRoto)
from superresolution_aniso_mri_tpu_torch.cli import entry, train_loop
from superresolution_aniso_mri_tpu_torch.data.synthetic import (
    RotoTripletSampler)
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)

TINY = ["-d", "MNISTRoto", "--width", "16", "--latent_width", "4",
        "--latent", "4", "--depth", "4", "-b", "32", "-e", "1",
        "--downsample_steps", "2", "--image_mix_loss_func", "mse",
        "--device", "cpu"]


def _write_idx(path, n=12, seed=0):
    rng = np.random.RandomState(seed)
    imgs = (rng.rand(n, 28, 28) * 255).astype(np.uint8)
    with gzip.open(path, "wb") as f:
        f.write(struct.pack(">IIII", 0x803, n, 28, 28) + imgs.tobytes())


def _assert_same_items(a, b):
    assert sorted(a) == sorted(b)
    for k in b:
        got, want = np.asarray(a[k]), np.asarray(b[k])
        assert got.dtype == want.dtype and got.shape == want.shape, k
        np.testing.assert_array_equal(got, want, err_msg=k)


@pytest.mark.parametrize("source", ["phantoms", "mnist_train", "mnist_val"])
@pytest.mark.parametrize("ds", [2, 3])
def test_roto_sampler_is_bitwise_jax(source, ds, tmp_path, monkeypatch):
    """Base images, items by index and at random, and batches: the same
    seed gives the same arrays, ``alpha_features`` included."""
    monkeypatch.delenv("SR_MNIST_PATH", raising=False)
    kw = dict(num_images=5, size=24, downsample_steps=ds, seed=4)
    if source != "phantoms":
        path = str(tmp_path / "train-images-idx3-ubyte.gz")
        _write_idx(path)
        kw.update(mnist_path=path, mnist_split=source.split("_")[1])
    got, want = RotoTripletSampler(**kw), JaxRoto(**kw)
    assert len(got) == len(want) == 5 * 36
    for a, b in zip(got.images, want.images):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    for idx in (0, 3, None, None, 7):
        _assert_same_items(got.sample_item(idx), want.sample_item(idx))
    _assert_same_items(got.sample_batch(6), want.sample_batch(6))
    assert got.sample_item(1)["alpha_features"][3] == 5.0


def test_roto_sampler_reads_sr_mnist_path(tmp_path, monkeypatch):
    """Without ``mnist_path`` the sampler takes ``$SR_MNIST_PATH``, as
    JAX's; a file of one image cannot make two pools."""
    path = str(tmp_path / "digits-idx3-ubyte.gz")
    _write_idx(path)
    monkeypatch.setenv("SR_MNIST_PATH", path)
    got, want = RotoTripletSampler(size=28), JaxRoto(size=28)
    np.testing.assert_array_equal(np.stack(got.images),
                                  np.stack(want.images))
    _write_idx(path, n=1)
    with pytest.raises(ValueError, match="at least 2"):
        RotoTripletSampler()


@pytest.mark.parametrize("model", ["ae_combined", "alpha_end_to_end"])
def test_train_brain_mnistroto_trains_on_rotation_triplets(model, tmp_path,
                                                           monkeypatch):
    """One epoch of ``train-brain -d MNISTRoto``: the loop samples from
    ``RotoTripletSampler`` (train seed, val seed + 1), the first batch is
    JAX's sampler's first batch, the losses are finite and the
    experiment files are written."""
    monkeypatch.delenv("SR_MNIST_PATH", raising=False)
    made = []

    class Recording(RotoTripletSampler):
        def __init__(self, **kw):
            super().__init__(**kw)
            self.batches = []
            made.append((kw, self))

        def sample_batch(self, batch_size):
            batch = super().sample_batch(batch_size)
            self.batches.append(batch)
            return batch

    monkeypatch.setattr(train_loop, "RotoTripletSampler", Recording)
    tr = entry.train_brain(TINY + ["-m", model, "-o", str(tmp_path),
                                   "-id", "roto"])
    (train_kw, train_s), (val_kw, _) = made
    seed = int(tr.args["seed"])
    assert (train_kw["seed"], val_kw["seed"]) == (seed, seed + 1)
    assert (train_kw["mnist_split"], val_kw["mnist_split"]) == ("train",
                                                                "val")
    assert len(train_s.batches) == len(train_s) // 32 == tr.iters - 1
    want = JaxRoto(size=16, downsample_steps=2, seed=seed).sample_batch(32)
    _assert_same_items(train_s.batches[0], want)
    loss = np.load(tmp_path / "roto" / "losses_train.npz")["loss_ae"]
    assert np.isfinite(loss).all()
    assert "last.models" in os.listdir(tmp_path / "roto" / "models")
