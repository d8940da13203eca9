"""PyTorch port, the training loop's options against the JAX package on
the CPU: ``Trainer.train_many`` (``--steps_per_dispatch``), the EMA
weights (``--ema_decay``), TensorBoard logging (``--log_tensorboard``)
and the profiler trace (``--profile_dir``).

The JAX side is its ``Trainer`` built without the eager flax init
(``torch_port_helpers.jax_trainer``), at ``default_matmul_precision
("highest")``. Tolerances:

- ``train_many(N)`` against JAX's ``Trainer.train_many`` (one
  ``lax.scan``): every step's metrics rtol 1e-4 and the parameters
  within 2·lr·N, as ``test_torch_port_train.py``; against N port
  ``train`` calls: bitwise (the same eager steps on the CPU);
- the EMA against the numpy recurrence: rtol 2e-5 (``test_ema.py``'s);
  against JAX's ``Trainer._ema_step`` on the same trees: rtol 1e-6,
  atol 1e-7 (XLA may contract ``d * a + (1 - d) * b`` into one fused
  multiply-add: a few float32 ulps);
- TensorBoard: JAX's tags in JAX's order, scalars rtol 1e-6 (float64
  means of the same float32 losses), histograms and images bitwise.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from superresolution_aniso_mri_tpu.train import Trainer as JaxTrainer
from superresolution_aniso_mri_tpu_torch.cli import entry
from superresolution_aniso_mri_tpu_torch.models.convert import torch_to_flax
from superresolution_aniso_mri_tpu_torch.train import get_trainer
from superresolution_aniso_mri_tpu_torch.utils.profiling import trace
from torch_port_helpers import (RecordingWriter, jax_model, jax_trainer,
                                np_batch, port_trainer, torch_batch)

LR, N = 1e-4, 3
ARGS = dict(model="ae_combined", dataset="OASIS", use_batchnorm=True,
            use_sigmoid=True, lr=LR, epochs=2, image_mix_loss_func="mse",
            ex_loss_weight1=0.3, epoch_threshold=-1, batch_size=2,
            downsample_steps=3, seed=0)
TINY = ["-d", "MNIST3D", "--use_synthetic_data", "-m", "ae_combined",
        "--image_mix_loss_func", "mse", "--downsample_steps", "2",
        "--epoch_threshold", "-1", "--width", "32", "--latent_width", "16",
        "--depth", "8", "--latent", "8", "--limited_load", "-b", "8",
        "-bt", "4", "--num_val_batches", "2", "--lr", "1e-4", "-e", "2"]


def _flat(params):
    """A port parameter dict as a list of float64 numpy arrays."""
    return [v.detach().numpy().astype(np.float64) for v in params.values()]


def _stacked(batches):
    return {k: jnp.stack([jnp.asarray(b[k]) for b in batches])
            for k in batches[0]}


@pytest.fixture(scope="module")
def weights():
    return jax_model(3)


def test_train_many_matches_jax_and_single_steps(weights):
    model, params, stats = weights
    batches = [np_batch(20 + i) for i in range(N)]
    jt = jax_trainer(model, params, stats, ARGS, lr=LR)
    with jax.default_matmul_precision("highest"):
        jm = jt.train_many(_stacked(batches))
    many = port_trainer(params, stats, ARGS)
    pm = many.train_many([torch_batch(b) for b in batches])
    single = port_trainer(params, stats, ARGS)
    for b in batches:
        single.train(torch_batch(b))
    assert sorted(pm) == sorted(jm)
    for k in jm:
        assert pm[k].shape == (N,)
        np.testing.assert_allclose(pm[k].numpy(), np.asarray(jm[k]),
                                   rtol=1e-4, err_msg=k)
        assert torch.equal(torch.stack(single.losses[k]), pm[k]), k
        assert len(many.losses[k]) == N
    assert many.iters == single.iters == jt.iters == N + 1
    assert many.state.step == many.state.opt_state.count == N
    for k, v in many.model.state_dict().items():
        assert torch.equal(v, single.model.state_dict()[k]), k
    got = torch_to_flax(many.state.params())[0]
    drift = jax.tree_util.tree_map(
        lambda a, b: float(np.abs(np.asarray(a) - b).max()),
        jt.state.params, got)
    assert max(jax.tree_util.tree_leaves(drift)) <= 2 * LR * N


def test_ema_recurrence_and_train_many_compounding(weights):
    """EMA after each ``train`` is ``d * ema + (1 - d) * params``; one
    ``train_many`` of N steps folds the final parameters in with
    ``d ** N``; both are what JAX's ``_ema_step`` computes on the same
    trees; the EMA is a copy, never the parameters themselves."""
    model, params, stats = weights
    d = 0.9
    t = port_trainer(params, stats, dict(ARGS, ema_decay=d))
    live = t.state.params()
    assert all(e.data_ptr() != live[k].data_ptr()
               for k, e in t.ema_params.items())
    manual = _flat(t.ema_params)
    for i in range(N):
        t.train(torch_batch(np_batch(30 + i)))
        manual = [d * m + (1 - d) * c
                  for m, c in zip(manual, _flat(t.state.params()))]
    for m, g in zip(manual, _flat(t.ema_params)):
        np.testing.assert_allclose(g, m, rtol=2e-5, atol=1e-7)
    assert any(not np.allclose(g, c) for g, c in
               zip(_flat(t.ema_params), _flat(t.state.params())))

    # copies: torch_to_flax's arrays share the CPU tensors' memory
    before = _flat(t.ema_params)
    before_tree = jax.tree_util.tree_map(np.copy,
                                         torch_to_flax(t.ema_params)[0])
    t.train_many([torch_batch(np_batch(40 + i)) for i in range(N)])
    want = [d ** N * e + (1 - d ** N) * c
            for e, c in zip(before, _flat(t.state.params()))]
    for w, g in zip(want, _flat(t.ema_params)):
        np.testing.assert_allclose(g, w, rtol=2e-5, atol=1e-7)

    # JAX's _ema_step on the same trees
    jt = jax_trainer(model, params, stats, dict(ARGS, ema_decay=d), lr=LR)
    jt.ema_params = before_tree
    jt.state = jt.state.replace(params=torch_to_flax(t.state.params())[0])
    jt._ema_step(N)
    jax.tree_util.tree_map(
        lambda a, b: np.testing.assert_allclose(b, np.asarray(a), rtol=1e-6,
                                                atol=1e-7),
        jt.ema_params, torch_to_flax(t.ema_params)[0])


def _epoch(t, seed):
    t.train(torch_batch(np_batch(seed)))
    t.validate(torch_batch(np_batch(seed + 1)))
    t.show_loss_on_tensorboard("train")
    t.show_loss_on_tensorboard("test")
    t.reset_losses()
    t.end_epoch_processing()


def test_ema_checkpoint_written_loaded_and_resumed(weights, tmp_path):
    """``models/ema.models`` holds the averaged weights (buffers from the
    live model): ``get_trainer(model_nbr='ema')`` serves them, and
    ``load`` resumes the track from it (else from the loaded weights)."""
    _, params, stats = weights
    args = dict(ARGS, ema_decay=0.9, output_dir=str(tmp_path))
    t = port_trainer(params, stats, args)
    t.prepare_run()
    _epoch(t, 50)
    ema_file = tmp_path / "models" / "ema.models"
    assert ema_file.is_file()
    te = get_trainer(str(tmp_path), model_nbr="ema", device="cpu")
    for k, v in te.model.state_dict().items():
        want = t.ema_params.get(k, t.model.state_dict()[k])
        assert torch.equal(v, want), k
    x = torch.rand(2, 1, 32, 32, generator=torch.Generator().manual_seed(0))
    assert te.model(x).shape == (2, 1, 32, 32)

    t2 = port_trainer(params, stats, args)
    t2.load(str(tmp_path / "models" / "last.models"))
    for k, v in t.ema_params.items():
        assert torch.equal(t2.ema_params[k], v), k
    ema_file.unlink()
    t3 = port_trainer(params, stats, args)
    t3.load(str(tmp_path / "models" / "last.models"))
    for k, v in t3.state.params().items():
        assert torch.equal(t3.ema_params[k], v), k
        assert t3.ema_params[k].data_ptr() != v.data_ptr()


def test_tensorboard_calls_match_jax(weights, tmp_path, monkeypatch):
    """A stand-in ``tensorboardX.SummaryWriter`` records the calls of
    ``prepare_run`` (its logdir), the loss flush, ``log_tb_image`` and
    ``log_tb_histograms``; JAX's methods on the same losses, grid and
    parameters record the same tags in the same order."""
    import types

    writers = []

    def make_writer(logdir=None):
        writers.append(RecordingWriter(logdir))
        return writers[-1]

    monkeypatch.setitem(__import__("sys").modules, "tensorboardX",
                        types.SimpleNamespace(SummaryWriter=make_writer))
    model, params, stats = weights
    t = port_trainer(params, stats, dict(ARGS, log_tensorboard=True,
                                         output_dir=str(tmp_path)))
    t.prepare_run()
    assert writers[0].logdir == str(tmp_path / "tb")
    jt = jax_trainer(model, params, stats, ARGS, lr=LR)
    jt.tb_writer = RecordingWriter()
    for i in range(2):
        t.train(torch_batch(np_batch(60 + i)))
    t.validate(torch_batch(np_batch(62)))
    for src, dst in ((t.losses, jt.losses), (t.losses_test, jt.losses_test)):
        for k, v in src.items():
            dst[k] = [jnp.asarray(x.numpy()) for x in v]
    jt._iters = t.iters
    jt.state = jt.state.replace(params=torch_to_flax(t.state.params())[0])
    grid = np.random.RandomState(0).rand(40, 24).astype(np.float32) * 1.5
    for tr in (t, jt):
        tr.show_loss_on_tensorboard("train")
        tr.show_loss_on_tensorboard("test")
        tr.log_tb_image("val/reconstructions", grid)
        tr.log_tb_histograms()
    got, want = writers[0].calls, jt.tb_writer.calls
    assert [c[:2] for c in got] == [c[:2] for c in want]
    assert {c[0] for c in got} == {"scalar", "image", "histogram"}
    for g, w in zip(got, want):
        assert g[3] == w[3] == t.iters
        if g[0] == "scalar":
            np.testing.assert_allclose(g[2], w[2], rtol=1e-6, err_msg=g[1])
        else:
            np.testing.assert_array_equal(g[2], w[2], err_msg=g[1])


def test_tensorboard_without_tensorboardx_logs_nothing(weights, tmp_path,
                                                        monkeypatch):
    monkeypatch.setitem(__import__("sys").modules, "tensorboardX", None)
    _, params, stats = weights
    t = port_trainer(params, stats, dict(ARGS, log_tensorboard=True,
                                         output_dir=str(tmp_path)))
    t.prepare_run()
    assert t.tb_writer is None
    t.train(torch_batch(np_batch(70)))
    t.show_loss_on_tensorboard("train")
    t.log_tb_histograms()
    assert not (tmp_path / "tb").exists()


def test_profile_trace_on_the_cpu(weights, tmp_path):
    """``utils.profiling.trace`` writes a Chrome trace of the block."""
    _, params, stats = weights
    t = port_trainer(params, stats, ARGS)
    with trace(str(tmp_path / "prof"), "cpu"):
        t.train(torch_batch(np_batch(80)))
    (path,) = (tmp_path / "prof").iterdir()
    events = json.loads(path.read_text())["traceEvents"]
    assert any("conv" in str(e.get("name", "")).lower() for e in events)


def test_train_brain_with_the_options_end_to_end(tmp_path, monkeypatch):
    """``train-brain --steps_per_dispatch 3 --ema_decay 0.9
    --profile_dir --log_tensorboard --device cpu``: two epochs of 8
    steps (two dispatches of 3 and a remainder of 2 each), the EMA
    checkpoint, a trace of the first epoch, the TensorBoard calls and a
    closed writer."""
    import types

    from superresolution_aniso_mri_tpu_torch.train import Trainer

    writers, dispatched = [], []
    monkeypatch.setitem(__import__("sys").modules, "tensorboardX",
                        types.SimpleNamespace(
                            SummaryWriter=lambda logdir=None: writers.append(
                                RecordingWriter(logdir)) or writers[-1]))
    train_many = Trainer.train_many

    def counted(self, batches):
        dispatched.append(len(batches))
        return train_many(self, batches)

    monkeypatch.setattr(Trainer, "train_many", counted)
    prof = tmp_path / "prof"
    tr = entry.train_brain(TINY + ["-o", str(tmp_path), "-id", "x",
                                   "--device", "cpu", "--steps_per_dispatch",
                                   "3", "--ema_decay", "0.9", "--profile_dir",
                                   str(prof), "--log_tensorboard"])
    assert dispatched == [3, 3, 3, 3]
    assert tr.iters == 1 + 2 * 8 and tr.state.opt_state.count == 16
    models = sorted(os.listdir(tmp_path / "x" / "models"))
    assert models == ["0.models", "1.models", "ae.models", "caisr.models",
                      "ema.models", "last.models"]
    assert len(os.listdir(prof)) == 1
    loss = np.load(tmp_path / "x" / "losses_train.npz")["loss_ae"]
    assert loss.shape == (2,) and np.isfinite(loss).all()
    (w,) = writers
    tags = [c[1] for c in w.calls]
    assert "loss_ae/train" in tags and "val/reconstructions" in tags
    assert "enc/stem/kernel" in tags and w.closed
