"""The benchmark's β-VAE cell (``oasis-vae-train-spd8``) on the CPU at a
small size: the plain reference (``port_bench/reference/vae.py``)
against the port's ``vae_combined`` step, the cell's driver set up,
compared and judged with its faults, its frozen counts, and its two
per-layer readers.

The small size is the one ``port_bench/tests/small.py`` gives the cell
(width 16, latent width 4, depth 4, latent 8: heads of 128 x 128; 4
pairs), with 24^2 slices cropped to 16^2 as the autoencoder cells'
training runs take them. No JAX here.
"""
import time

import numpy as np
import pytest
import torch

from port_bench import harness
from port_bench.counts import vae as counts
from port_bench.drivers import train_vae
from port_bench.reference.model import Arch
from port_bench.reference.vae import follow
from port_bench.tests.small import small_cell

CELL = "oasis-vae-train-spd8"
SEED = 3_000_000_007
ARCH = Arch(width=16, latent_width=4, depth=4, latent=8)
PAIRS = 4


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _cell():
    cell = small_cell(CELL)
    # small.py gives the 24^2 slices of a cropped recipe to kind "train"
    cell.config["dataset"]["inplane"] = 24
    return cell


def _batches(rng, n):
    out = []
    for _ in range(n):
        a_to = rng.uniform(0.1, 0.9, PAIRS)
        batch = {"image": rng.rand(2 * PAIRS, 1, 16, 16),
                 "slice_between": rng.rand(PAIRS, 1, 16, 16),
                 "alpha_from": 1 - a_to, "alpha_to": a_to,
                 "is_inbetween": np.array([1.0, 0.0, 1.0, 1.0])}
        out.append({k: torch.from_numpy(np.asarray(v, np.float32))
                    for k, v in batch.items()})
    return out


def test_reference_follows_the_port_step():
    """Three ``vae_combined`` steps of the port (``make_train_step``, the
    step ``Trainer`` runs) and of the reference from the same seeded
    weights, batches and noise, at the recipe's β 200, λ 1 and lr 1e-5."""
    from superresolution_aniso_mri_tpu_torch.train import (Trainer,
                                                           make_train_step)

    tr = Trainer(dict(model="vae_combined", lr=1e-5, vae_beta=200.0,
                      lamb=1.0, image_mix_loss_func="mse", width=16,
                      latent_width=4, depth=4, latent=8, use_batchnorm=True,
                      use_sigmoid=True, seed=0), device="cpu")
    init = train_vae.weight_set(ARCH, 11, "cpu")
    tr.model.load_state_dict(init)
    rng = np.random.RandomState(0)
    batches = _batches(rng, 3)
    noise = [torch.from_numpy(rng.randn(2 * PAIRS, 128).astype(np.float32))
             for _ in batches]
    step, state, losses = make_train_step(tr.loss_config), tr.state, []
    for i, (b, eps) in enumerate(zip(batches, noise)):
        losses.append(float(step(state, {**b, "noise_eps": eps}, 1e-3)[1]
                            ["loss_ae"]))
        if i == 0:
            grad1 = {k: v / (1.0 - state.tx.b1)
                     for k, v in state.opt_state.mu.items()}
    got = {k: p.detach() for k, p in state.params().items()}
    seen = {}

    def visit(i, grads, params):
        if i == 1:
            seen["grad1"] = grads
        seen["params"] = params

    ref = follow(ARCH, init, batches, noise, 1e-5, 0.9, 1e-3, 200.0, 1.0,
                 visit=visit)
    # the same float32 operations on the same values: the losses (~200)
    # read bit for bit equal here; 1e-6 leaves room for a sum reduced
    # in another order
    np.testing.assert_allclose(losses, ref["loss"], rtol=1e-6)
    assert sorted(grad1) == sorted(seen["grad1"])
    for k, g in seen["grad1"].items():
        # the backward passes sum in other orders (autograd's of the
        # port's modules against the reference's functions): 2.5e-6 of
        # the leaf's largest entry read, 2e-5 allowed
        scale = float(g.abs().max())
        assert float((grad1[k] - g).abs().max()) <= 2e-5 * scale, k
    for k, p in seen["params"].items():
        # three Adam steps of lr 1e-5 move an entry by at most 3e-5;
        # Adam's normalisation turns the gradient's rounding, where an
        # entry's gradient is near zero, into a visible share of its
        # step: 5e-4 of the leaf's largest change read, 5e-3 allowed
        change = float((p - init[k]).abs().max())
        assert float((got[k] - p).abs().max()) <= 5e-3 * change, k


@pytest.fixture
def run(monkeypatch):
    """``harness.execute`` on the CPU. The suite's ``conftest.py`` loads
    JAX for the parity tests, so the run's look for JAX's modules is
    left out here (``port_bench/tests/test_port_bench_run.py`` holds
    it)."""
    monkeypatch.setattr(harness, "_check_banned", lambda: None)
    return _run


def _run(cell):
    return harness.execute(cell, SEED, 0.5, False, torch.device("cpu"),
                           time.perf_counter())


def test_the_cell_runs_and_reads_correct(run):
    """Set-up, a short window and the comparison, as a run makes them:
    every number within the cell's limits (set on the card at full
    size)."""
    result = run(_cell())
    assert set(result["checks"]) == {"batch_gap", "loss_gap", "grad1_gap",
                                     "delta3_gap", "delta6_gap",
                                     "noise_gap"}
    assert result["correct"] is True, result["checks"]
    assert result["attempted"] > 0


def test_a_step_on_other_noise_than_drawn_is_not_correct(run,
                                                        monkeypatch):
    """The timed path broken underneath: the step trains on the mean
    (its noise zeroed), so the draws the driver records are not what
    the program used."""
    from superresolution_aniso_mri_tpu_torch.train import steps

    orig = steps._vae_losses

    def on_the_mean(model, cfg, lp, batch, w):
        batch = {**batch, "noise_eps": torch.zeros_like(batch["noise_eps"])}
        return orig(model, cfg, lp, batch, w)

    monkeypatch.setattr(steps, "_vae_losses", on_the_mean)
    assert run(_cell())["correct"] is False


@pytest.fixture(scope="module")
def job_and_reference():
    cell = _cell()
    torch.set_num_threads(2)
    job = train_vae.Job(cell, SEED + 4, torch.device("cpu"))
    return cell, job, job.reference_outputs("float32")


def _judged(cell, job, side, ref):
    numbers, answers = job.compare(job.as_program(side), ref)
    return harness.verdict(cell, numbers, answers)[0], numbers


@pytest.mark.parametrize("fault", train_vae.FAULTS)
def test_each_fault_is_not_correct(job_and_reference, fault):
    cell, job, ref = job_and_reference
    ok, numbers = _judged(cell, job,
                          job.reference_outputs("float32", fault), ref)
    assert not ok, numbers
    if fault == "zero_noise":
        assert numbers["noise_gap"] == 1.0


def test_the_control_is_not_correct(job_and_reference):
    """The reference in TF32 (its operands rounded, on the CPU) in the
    program's place."""
    cell, job, ref = job_and_reference
    assert not _judged(cell, job, job.reference_outputs("tf32"), ref)[0]


def _port_vae(arch, device):
    from superresolution_aniso_mri_tpu_torch.models import AEConfig
    from superresolution_aniso_mri_tpu_torch.models.vae import VAE

    cfg = AEConfig(width=arch.width, latent_width=arch.latent_width,
                   depth=arch.depth, latent=arch.latent)
    with torch.device(device):
        return VAE(cfg)


def test_frozen_flops_equal_the_port_step():
    """``counts.vae.train_step_flops`` against ``torch.utils.flop_counter``
    over the port's own ``vae_combined`` step (``make_train_step`` on the
    port's ``VAE``) on the meta device."""
    from superresolution_aniso_mri_tpu_torch.tools import roofline
    from superresolution_aniso_mri_tpu_torch.train import make_train_step
    from superresolution_aniso_mri_tpu_torch.train.state import \
        create_train_state
    from superresolution_aniso_mri_tpu_torch.train.trainer import \
        loss_config_from_args

    meta = torch.device("meta")
    for arch, pairs, size in ((ARCH, PAIRS, 16),
                              (Arch(32, 8, 4, 6), 3, 32)):
        state = create_train_state(_port_vae(arch, meta), 1e-5)
        step = make_train_step(loss_config_from_args(dict(
            model="vae_combined", vae_beta=200.0, lamb=1.0,
            image_mix_loss_func="mse", use_laploss=False)))
        flat = arch.latent * arch.latent_width ** 2
        batch = {"image": torch.empty(2 * pairs, 1, size, size, device=meta),
                 "slice_between": torch.empty(pairs, 1, size, size,
                                              device=meta),
                 "noise_eps": torch.empty(2 * pairs, flat, device=meta),
                 **{k: torch.empty(pairs, device=meta)
                    for k in ("alpha_from", "alpha_to", "is_inbetween")}}
        want = roofline.count_flops(step, state, batch, 1e-3)
        assert counts.train_step_flops(arch, pairs, size) == want


def test_optimizer_bytes_are_28_a_trained_parameter():
    """28 bytes a parameter of the port's ``VAE``; 2.15 G parameters at
    the recipe's widths."""
    for arch in (ARCH, Arch(64, 16, 32, 128)):
        n = sum(p.numel() for p in _port_vae(arch, "meta").parameters())
        assert counts.trained_params(arch) == n
        assert counts.optimizer_least_bytes(arch) == 28 * n
    assert 2.14e9 < counts.trained_params(Arch(64, 16, 32, 128)) < 2.16e9


class _Trace:
    device = {"multi_tensor_apply_kernel<Adam>": 0.006,
              "FusedAdamKernel": 0.002,
              "sm90_xmma_gemm_f32f32_f32f32": 0.5}

    def device_time(self, match):
        return sum(v for k, v in self.device.items() if match(k))


def test_optimizer_roofline_share_reads_the_optimizer_kernels():
    read = harness.reader("optimizer.roofline_share")
    record = harness.Record("train", 1.0, {
        "steps": 8, "optimizer_least_bytes_per_step": 1e9}, {}, _Trace())
    assert read(record) == pytest.approx(100.0 * 8e9 / 3.35e12 / 0.008)
    record.counters["optimizer_least_bytes_per_step"] = 0
    assert read(record) is None


def test_noise_reader_reads_the_spans_per_step(monkeypatch):
    from superresolution_aniso_mri_tpu_torch.utils import profiling
    from superresolution_aniso_mri_tpu_torch.utils.profiling import Span

    store = [Span("train.dispatch", 0, 40_000_000, None, 0, {"steps": 8},
                  0)]
    store += [Span("train.noise", 10 * i, 10 * i + 250_000, 0, 0,
                   {"values": 1 << 20}, i + 1) for i in range(8)]
    monkeypatch.setattr(profiling, "_STORE", store)
    read = harness.reader("train.noise_host_ms_per_step")
    assert read(harness.Record("train", 1.0, {}, {}, None)) == \
        pytest.approx(0.25)


@pytest.mark.parametrize("metric", ["optimizer.roofline_share",
                                    "train.noise_host_ms_per_step"])
@pytest.mark.parametrize("kind", ["score", "serve", "no such kind"])
def test_new_readers_are_silent_on_other_kinds(metric, kind):
    read = harness.reader(metric)
    record = harness.Record(kind, 1.0, {
        "steps": 8, "optimizer_least_bytes_per_step": 1e9}, {}, _Trace())
    assert read(record) is None
