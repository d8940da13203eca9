"""PyTorch port of the measurement entry points (``bench``,
``infer-roofline``, ``train-bench``, ``pipeline-bench``,
``loader-bench``) against the repo's root ``bench.py`` and its
``tools/`` scripts, on the CPU at small sizes.

FLOP counts: the port counts with ``torch.utils.flop_counter``
(``tools/roofline.py``), the JAX tools with XLA's ``cost_analysis()``.
They differ by design in two ways: XLA counts a convolution's window
only where it touches the unpadded input (a 3x3 "SAME" conv on 32²
reads 94²/96² of the full window count), where the torch counter counts
the whole window; and XLA counts element-wise ops (activations,
BatchNorm, losses, Adam) at about one FLOP an element, where the torch
counter counts them as 0. The first gap outweighs the second at these
widths: the port reads 1.85 % (a served volume) and 3.65 % (a train
step) above XLA. ``FLOP_RTOL`` (5 %) holds both counts to that
explanation; a wrong count (a missed decode, a doubled backward) moves
them by tens of percent.

The JAX oracles are built from ``jax.eval_shape`` trees with numpy
values (``torch_port_helpers``), never by an eager flax init.
"""
import argparse
import ast
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from superresolution_aniso_mri_tpu.infer.super_volume import (
    make_volume_synthesizer as jax_volume_synthesizer)
from superresolution_aniso_mri_tpu.train.steps import \
    make_train_step as jax_make_train_step
from superresolution_aniso_mri_tpu.train.trainer import \
    loss_config_from_args as jax_loss_config
from superresolution_aniso_mri_tpu_torch.infer import ServingModel
from superresolution_aniso_mri_tpu_torch.models import AEConfig
from superresolution_aniso_mri_tpu_torch.tools import (bench, infer_roofline,
                                                       loader_bench,
                                                       pipeline_bench,
                                                       real_pipeline_quality,
                                                       roofline, train_bench)
from torch_port_helpers import (SMALL, jax_model, jax_train_state,
                                one_torch_thread, port_trainer)  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLOP_RTOL = 0.05
VOLUME_ATOL = 1e-5
K, HW, DS = 5, 32, 3
PAIRS = 2


def _xla_flops(fn, *args) -> float:
    ca = jax.jit(fn).lower(*args).compile().cost_analysis()
    ca = ca[0] if isinstance(ca, (list, tuple)) else ca
    return float(ca["flops"])


def _alphas():
    return np.linspace(0, 1, DS + 1)[1:-1].astype(np.float32)


@pytest.fixture(scope="module")
def weights():
    return jax_model(0)


@pytest.fixture(scope="module")
def f32_run(weights):
    """(JAX's volume, the port's bench line and volumes) of one float32
    model, the port's carried across with ``ServingModel.from_flax``."""
    model, params, stats = weights
    volume = np.random.RandomState(0).rand(K, HW, HW, 1).astype(np.float32)
    synth = jax_volume_synthesizer(model)
    with jax.default_matmul_precision("highest"):
        want = np.asarray(synth(params, stats, jnp.asarray(volume),
                                jnp.asarray(_alphas()), use_original=False,
                                interleave=True)["volume"])
    port = ServingModel.from_flax(AEConfig(**SMALL), params, stats,
                                  device="cpu")
    line, vols = bench.run_bench(num_lr_slices=K, hw=HW, ds=DS, model=port)
    return want, line, vols


def test_volume_flops_match_xla(weights):
    model, params, stats = weights
    synth = jax_volume_synthesizer(model)
    volume = np.random.RandomState(0).rand(K, HW, HW, 1).astype(np.float32)
    want = _xla_flops(lambda p, s, v, a: synth(
        p, s, v, a, use_original=False, interleave=True)["volume"],
        params, stats, volume, _alphas())
    port = ServingModel.from_flax(AEConfig(**SMALL), params, stats,
                                  device="cpu")
    kept = torch.from_numpy(volume.transpose(0, 3, 1, 2).copy())
    got = infer_roofline.volume_flops(port._ae_model(), kept,
                                      torch.from_numpy(_alphas()))
    assert abs(got / want - 1.0) <= FLOP_RTOL, (got, want)
    # the count comes from shapes: the meta device (no values) gives the
    # same number, in float32 and in bfloat16
    for dtype in ("float32", "bfloat16"):
        net, mkept, malphas = infer_roofline.volume_case(
            AEConfig(**SMALL, compute_dtype=dtype), K, HW, DS,
            torch.device("meta"))
        assert infer_roofline.volume_flops(net, mkept, malphas) == got


def test_train_step_flops_match_xla(weights):
    model, params, stats = weights
    args = train_bench.trainer_args(**{k: SMALL[k] for k in (
        "width", "latent_width", "depth", "latent")},
        batch_pairs=PAIRS, compute_dtype="float32")
    rng = np.random.RandomState(0)
    batch = {"image": rng.rand(2 * PAIRS, HW, HW, 1).astype(np.float32),
             "slice_between": rng.rand(PAIRS, HW, HW, 1).astype(np.float32),
             "alpha_from": np.full((PAIRS,), 0.5, np.float32),
             "alpha_to": np.full((PAIRS,), 0.5, np.float32)}
    step = jax_make_train_step(model, jax_loss_config(args), donate=False)
    state = jax_train_state(model, params, stats, lr=args["lr"])
    want = _xla_flops(step, state, batch, jax.random.PRNGKey(0),
                      jnp.float32(train_bench.MIX_WEIGHT))
    trainer = port_trainer(params, stats, args)
    tbatch = train_bench.step_batch(HW, PAIRS, torch.device("cpu"))
    got = roofline.count_flops(trainer.train, tbatch)
    assert abs(got / want - 1.0) <= FLOP_RTOL, (got, want)
    assert train_bench.meta_step_flops(args, HW, PAIRS) == got
    # least bytes: the batch once, parameters + statistics + both Adam
    # moments read and written
    n_param = sum(p.numel() for p in trainer.model.parameters())
    n_buf = sum(b.numel() for b in trainer.model.buffers())
    want_bytes = 4 * (3 * PAIRS * HW * HW + 2 * PAIRS
                      + 2 * (3 * n_param + n_buf))
    assert train_bench.step_bytes(trainer.state, tbatch) == want_bytes


def test_bench_volume_matches_jax(f32_run):
    want, line, vols = f32_run
    got = vols["volume"]
    assert got.shape == ((K - 1) * DS + 1, 1, HW, HW)
    np.testing.assert_allclose(got[:, 0], want[..., 0], atol=VOLUME_ATOL)
    # the same weights in float32 on both legs of bf16_ssim_delta
    np.testing.assert_array_equal(vols["volume_f32"], got)
    assert line["bf16_ssim_delta"] == 0.0
    assert line["ssim_kernel_path"] == "plain"
    assert line["ssim_selfcheck"] == 1.0


def _jax_bench_keys():
    """The keys of the dict that ``bench.py`` passes to ``json.dumps``."""
    with open(os.path.join(REPO, "bench.py")) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call)
                and getattr(node.func, "attr", None) == "dumps"
                and node.args and isinstance(node.args[0], ast.Dict)):
            return {k.value for k in node.args[0].keys}
    raise AssertionError("bench.py prints no json.dumps dict")


def test_bench_line_has_every_jax_key(f32_run):
    keys = _jax_bench_keys()
    assert len(keys) == 20
    line = bench.run_bench(AEConfig(**SMALL, compute_dtype="bfloat16"),
                           num_lr_slices=K, hw=HW, ds=DS, device="cpu")[0]
    for got in (line, f32_run[1]):
        assert set(got) == keys | {"device_name", "power_limit_w"}
        assert got["device_name"] == "cpu" and got["power_limit_w"] is None
        assert got["ssim_kernel_path"] == "plain"
        assert got["metric"] == "oasis_6mm_to_1mm_volume_sr_latency"
    assert 0.0 < line["bf16_ssim_delta"] < 0.1


def _returned_dict_keys(path, func):
    """The keys of the dict literal that ``func`` in ``path`` returns."""
    with open(os.path.join(REPO, path)) as f:
        tree = ast.parse(f.read())
    fn = next(n for n in ast.walk(tree)
              if isinstance(n, ast.FunctionDef) and n.name == func)
    ret = next(n for n in ast.walk(fn)
               if isinstance(n, ast.Return) and isinstance(n.value, ast.Dict))
    return {k.value for k in ret.value.keys}


def test_train_bench_row_keeps_jax_keys():
    cpu = torch.device("cpu")
    row = train_bench.bench_config("tiny", 32, 8, 4, 6, PAIRS, "bfloat16",
                                   cpu, roofline.card(cpu), steps=2)
    want = _returned_dict_keys("tools/train_bench.py", "bench_config")
    assert set(row) == (want - {"bytes_accessed"}) | {
        "least_bytes", "peak_tflops_used", "card"}
    assert row["peak_tflops_used"] == 989.0
    assert row["flops"] == train_bench.meta_step_flops(
        train_bench.trainer_args(32, 8, 4, 6, PAIRS, "bfloat16"), 32, PAIRS)
    floor_s = max(row["floor_compute_s"], row["floor_bandwidth_s"])
    assert row["gap_to_floor"] == pytest.approx(row["pipelined_s"] / floor_s)
    assert row["mfu_vs_bf16_peak"] == pytest.approx(
        row["flops"] / row["pipelined_s"] / 989e12)


def test_infer_roofline_split_and_packed():
    out = infer_roofline.run(
        batches=[1, 2], reps=1, split=True, packed=True, device="cpu",
        cfg=AEConfig(**SMALL), num_lr_slices=K, hw=HW, ds=DS)
    assert sorted(out["batched"]) == ["B=2", "B=2 packed"]
    net, kept, alphas = infer_roofline.volume_case(
        AEConfig(**SMALL), K, HW, DS, torch.device("meta"))
    assert out["flops_per_volume"] == infer_roofline.volume_flops(
        net, kept, alphas)
    # the decode is most of the volume's work, and not all of it
    split = out["split"]
    assert 0.5 < (split["decode_flops_per_volume"]
                  / out["flops_per_volume"]) < 1.0
    assert {"encode_s_per_volume", "mix_s_per_volume",
            "decode_s_per_volume", "interleave_s_per_volume"} <= set(split)
    # kept slices, weights and the float32 volume, each once
    n_weights = sum(t.numel() for t in net.state_dict().values())
    assert out["least_bytes_per_volume"] == 4 * (
        K * HW * HW + n_weights + ((K - 1) * DS + 1) * HW * HW)


def _fake_child(calls, stdout):
    """A stand-in for ``subprocess.run`` of a training child: records
    the command, writes the run's iteration archive under its ``-o``."""
    def run(cmd, **kw):
        calls.append(list(cmd))
        out = cmd[cmd.index("-o") + 1]
        os.makedirs(os.path.join(out, "pb"), exist_ok=True)
        np.savez(os.path.join(out, "pb", "loss_iters.npz"),
                 loss_iters=np.array([0, 6, 12, 18]))
        return subprocess.CompletedProcess(cmd, 0, stdout, "")
    return run


def test_pipeline_bench_child_matches_jax(monkeypatch, tmp_path):
    import tools.pipeline_bench as jpb

    stdout = "".join(f"epoch {e:4d}  loss_ae=0.1 val=0.2  ({s}s)\n"
                     for e, s in ((0, "3.5"), (1, "0.4"), (2, "0.6")))
    args = argparse.Namespace(inplane=32, latent=8, depth=4, batch_size=4,
                              epochs=3, device="cpu")
    calls = {"jax": [], "port": []}
    monkeypatch.setattr(jpb.subprocess, "run",
                        _fake_child(calls["jax"], stdout))
    want = jpb.run_variant(str(tmp_path), "1", args)
    monkeypatch.setattr(pipeline_bench.subprocess, "run",
                        _fake_child(calls["port"], stdout))
    got = pipeline_bench.run_variant(str(tmp_path), "1", args)
    assert got == want == (3.5, 0.5, 6)
    (jcmd,), (pcmd,) = calls["jax"], calls["port"]
    for cmd in (jcmd, pcmd):
        cmd[cmd.index("-o") + 1] = "OUT"
    entry = real_pipeline_quality.cli_command("train-brain", "cpu")
    assert jcmd[:2] == [sys.executable, "train_brain_aesr.py"]
    assert pcmd[:len(entry)] == entry
    assert pcmd[len(entry):] == jcmd[2:]

    # without --device the children go to the card
    seen = []
    monkeypatch.setattr(pipeline_bench, "card_of_children",
                        lambda device: seen.append(device) or "card")
    monkeypatch.setattr(pipeline_bench, "make_textured_oasis_tree",
                        lambda *a: None)
    monkeypatch.setattr(pipeline_bench, "run_variant",
                        lambda root, cache, a: seen.append(a.device)
                        or (1.0, 1.0, 1))
    pipeline_bench.main(["--variants", "1"])
    assert seen == ["cuda", "cuda"]


def test_pipeline_bench_reads_the_port_train_loop():
    """One variant end to end on the CPU: the real child's epoch lines
    parse with ``EPOCH_RE`` and its iteration archive gives the steps."""
    res = pipeline_bench.main(
        ["--inplane", "32", "--num_slices", "13", "--n_patients", "7",
         "--batch_size", "4", "--depth", "4", "--latent", "8",
         "--epochs", "3", "--variants", "1", "--device", "cpu"])
    row = res["1"]
    assert row["steps_per_epoch"] > 0
    assert row["first_epoch_s"] >= 0 and row["steady_epoch_s"] >= 0
    assert row["card"].startswith("cpu")


def test_loader_bench_native_equals_numpy():
    ingest = loader_bench.bench_ingest(n_files=2, shape=(3, 16, 12), reps=1)
    gather = loader_bench.bench_gather(b=4, hw=(16, 12), c=3, reps=1)
    assert ingest["python_s"] > 0 and ingest["native_s"] > 0
    assert gather["python_ms"] > 0 and gather["native_ms"] > 0
    assert ingest["host"].endswith(f"{os.cpu_count()} cores")
    rng = np.random.RandomState(2)
    items = [[rng.rand(16, 12).astype(np.float32) for _ in range(3)]
             for _ in range(4)]
    np.testing.assert_array_equal(
        loader_bench.nl.gather_triplets(items),
        np.stack([np.stack(ch, axis=-1) for ch in items]))


@pytest.mark.parametrize("command", [bench, infer_roofline, train_bench],
                         ids=["bench", "infer-roofline", "train-bench"])
def test_card_commands_need_cuda_or_device_cpu(monkeypatch, command):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        command.main([])
