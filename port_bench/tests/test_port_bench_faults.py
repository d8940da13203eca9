"""The comparison that decides ``correct`` fails what it must: the TF32
control at a small size (emulated on the CPU, real on the card), and a
run with the timed path broken underneath, once for each fault a cell
can have. Runs go through ``harness.execute`` on the CPU, past the
look for a card."""
from __future__ import annotations

import time

import numpy as np
import pytest
import torch

from port_bench import harness
from port_bench.tests.small import small_cell

CELLS = ["dhcp-train-spd8", "oasis-train-spd8", "dhcp-findbest-score",
         "oasis-serve-b2"]


def run(cell, device="cpu"):
    return harness.execute(cell, 3_000_000_007, 0.5, False,
                           torch.device(device), time.perf_counter())


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _control(name, device, widths=False):
    cell = small_cell(name, widths)
    mod = harness.driver(cell.traffic["kind"])
    job = mod.Job(cell, 3_000_000_011, torch.device(device))
    if job.kind != "train":
        job.window(0.2)
    ref = job.reference_outputs("float32")
    numbers, answers = job.compare(
        job.as_program(job.reference_outputs("tf32")), ref)
    return harness.verdict(cell, numbers, answers)[0]


@pytest.mark.parametrize("name", CELLS)
def test_the_control_is_not_correct(name):
    assert not _control(name, "cpu")


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_the_control_is_not_correct_on_the_card(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control's TF32 runs there")
    assert not _control(name, "cuda", widths=True)


def _train_unchanged(mp):
    from superresolution_aniso_mri_tpu_torch.train import state
    mp.setattr(state.Optimizer, "apply", lambda self, *a, **k: None)


def _train_half_batch(mp):
    from superresolution_aniso_mri_tpu_torch.train import steps
    orig = steps._ae_losses

    def half(model, cfg, lp, batch, w):
        b = batch["slice_between"].shape[0]
        h = b // 2
        cut = {k: v[:h] for k, v in batch.items()}
        cut["image"] = torch.cat([batch["image"][:h],
                                  batch["image"][b:b + h]])
        return orig(model, cfg, lp, cut, w)
    mp.setattr(steps, "_ae_losses", half)


def _train_altered(mp):
    from superresolution_aniso_mri_tpu_torch.data import transforms
    orig = transforms.apply_augment

    def altered(x, params, cfg):
        out = orig(x, params, cfg).clone()
        out[0] = 1.0 - out[0]
        return out
    mp.setattr(transforms, "apply_augment", altered)


def _score_half_batch(mp):
    from superresolution_aniso_mri_tpu_torch.evaluate import sweep
    orig = sweep._finite_mean
    mp.setattr(sweep, "_finite_mean", lambda v: orig(v[:len(v) // 2]))


def _score_altered(mp):
    from superresolution_aniso_mri_tpu_torch.evaluate import sweep
    orig = sweep.psnr_volume
    mp.setattr(sweep, "psnr_volume", lambda r, u, d: orig(r, u, d) + 0.1)


def _serve_half_batch(mp):
    from superresolution_aniso_mri_tpu_torch.infer import super_volume
    orig = super_volume._readback

    def half(vol, dtype):
        out = orig(vol, dtype)
        h = out.shape[0] // 2
        out[h:2 * h] = out[:h]
        return out
    mp.setattr(super_volume, "_readback", half)


def _serve_altered(mp):
    from superresolution_aniso_mri_tpu_torch.infer import super_volume
    orig = super_volume._readback

    def altered(vol, dtype):
        out = orig(vol, dtype)
        out[:, 1] = np.clip(out[:, 1] + 0.01, 0.0, 1.0)
        return out
    mp.setattr(super_volume, "_readback", altered)


FAULTS = [("dhcp-train-spd8", _train_unchanged),
          ("dhcp-train-spd8", _train_half_batch),
          ("dhcp-train-spd8", _train_altered),
          ("oasis-train-spd8", _train_unchanged),
          ("oasis-train-spd8", _train_half_batch),
          ("oasis-train-spd8", _train_altered),
          ("dhcp-findbest-score", _score_half_batch),
          ("dhcp-findbest-score", _score_altered),
          ("oasis-serve-b2", _serve_half_batch),
          ("oasis-serve-b2", _serve_altered)]


@pytest.mark.parametrize("name,fault", FAULTS,
                         ids=[f"{n}-{f.__name__[1:]}" for n, f in FAULTS])
def test_a_broken_path_is_not_correct(name, fault, monkeypatch):
    fault(monkeypatch)
    result = run(small_cell(name))
    assert result["correct"] is False


@pytest.mark.parametrize("name", CELLS)
def test_the_unbroken_path_is_correct(name):
    """The same small runs with nothing broken pass, so the broken runs
    above fail by their fault."""
    assert run(small_cell(name))["correct"] is True
