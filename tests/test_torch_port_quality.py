"""PyTorch port of the quality harnesses against the JAX package's
``tools/real_pipeline_quality.py``, ``tools/quality_check.py`` and
``tools/_subproc.py``, on the CPU at small sizes (7 patients of
13 × 32²).

Exact: the fabricated trees (decoded arrays, spacings, split-file
bytes), the extra held-out volumes, the helpers over tables of inputs,
the child command lines after each package's entry point, the guards,
``run_child``'s clamp and budget. The scoring leg: both tools score one
kept work directory (trained by the port) with ``--reuse --checkpoint
caisr``; the rows have the same keys and values, the metrics within
``ROW_RTOL`` relative (the model's synthesis runs in each package's
float32 convolutions, and each row rounds to 5 decimals; the largest
gap read was 3.8e-7, one rounding step of a PSNR).
"""
import argparse
import json
import os
import sys
import time

import numpy as np
import pytest

import tools._subproc as jsub
import tools.quality_check as jqc
import tools.real_pipeline_quality as jrpq
from superresolution_aniso_mri_tpu.utils.nifti import read_nifti as jread
from superresolution_aniso_mri_tpu_torch.tools import _subproc as psub
from superresolution_aniso_mri_tpu_torch.tools import quality_check as pqc
from superresolution_aniso_mri_tpu_torch.tools import \
    real_pipeline_quality as prpq
from superresolution_aniso_mri_tpu_torch.utils.nifti import read_nifti as pread
from torch_port_helpers import one_torch_thread  # noqa: F401

N, SLICES, HW = 7, 13, 32
ROW_RTOL = 1e-4
METRIC_KEYS = ("model", "model_all_slices", "best_conventional",
               "model_extra", "best_conventional_extra")


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


# ---------------------------------------------------------------------------
# fabrication
# ---------------------------------------------------------------------------

TREES = [
    ("OASIS", dict(ds=3, n_patients=N, inplane=HW, num_slices=SLICES,
                   noise_sigma=0.03)),
    ("OASIS", dict(ds=3, n_patients=N, inplane=HW, num_slices=SLICES,
                   anatomy="anatomy3d")),
    ("dHCP", dict(ds=4, n_patients=N, inplane=HW, num_slices=SLICES,
                  noise_sigma=0.03)),
    ("ACDC", dict(n_patients=N, inplane=24, num_slices=7, num_frames=2,
                  noise_sigma=0.03)),
]


@pytest.mark.parametrize("shape,kw", TREES,
                         ids=["oasis", "oasis_anatomy3d", "dhcp", "acdc"])
def test_trees_match_jax_bit_for_bit(tmp_path, shape, kw):
    name = {"OASIS": "make_textured_oasis_tree",
            "dHCP": "make_textured_dhcp_tree",
            "ACDC": "make_textured_acdc_tree"}[shape]
    jroot, proot = str(tmp_path / "jax"), str(tmp_path / "port")
    getattr(jrpq, name)(jroot, **kw)
    getattr(prpq, name)(proot, **kw)
    files = _files(jroot)
    assert files == _files(proot) and files
    for rel in files:
        if rel.endswith(".yaml"):
            with open(os.path.join(jroot, rel), "rb") as a, \
                    open(os.path.join(proot, rel), "rb") as b:
                assert a.read() == b.read(), rel
            continue
        ja, jsp, _ = jread(os.path.join(jroot, rel))
        pa, psp, _ = pread(os.path.join(proot, rel))
        assert ja.dtype == pa.dtype, rel
        np.testing.assert_array_equal(ja, pa, err_msg=rel)
        np.testing.assert_array_equal(jsp, psp, err_msg=rel)


@pytest.mark.parametrize("cardiac,kw", [
    (False, dict(ds=3, n=2, inplane=HW, num_slices=SLICES,
                 noise_sigma=0.03)),
    (False, dict(ds=3, n=2, inplane=HW, num_slices=SLICES,
                 anatomy="anatomy3d")),
    (True, dict(n=2, inplane=24, num_slices=7, num_frames=3,
                noise_sigma=0.03)),
], ids=["oasis", "anatomy3d", "acdc"])
def test_extra_test_volumes_match_jax(cardiac, kw):
    name = ("make_extra_test_volumes_acdc" if cardiac
            else "make_extra_test_volumes")
    jv, pv = getattr(jrpq, name)(**kw), getattr(prpq, name)(**kw)
    assert len(jv) == len(pv) > 0
    for a, b in zip(jv, pv):
        for field in ("image", "image_hr", "spacing"):
            x, y = getattr(a, field), getattr(b, field)
            assert (x is None) == (y is None), field
            if x is not None:
                assert np.asarray(x).dtype == np.asarray(y).dtype
                np.testing.assert_array_equal(x, y, err_msg=field)
        assert (a.patient_id, a.frame_id, a.num_frames) == \
            (b.patient_id, b.frame_id, b.num_frames)


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def _ns(**kw):
    base = dict(dataset_shape="OASIS", downsample_steps=3, inplane=64,
                latent_width=0, ex_loss_weight=0.001, lr_schedule=False,
                lr_warmup_steps=0, depth=24, latent=64, batch_size=16,
                ema_decay=0.0, train_latent_interp="linear",
                compute_dtype="float32", aug_noise=False, aug_blur=False,
                max_grad_norm=0.0, model="ae_combined", loss_mode="mse",
                use_batchnorm=None, train_timeout_s=0)
    base.update(kw)
    return argparse.Namespace(**base)


@pytest.mark.parametrize("mode", list(jrpq.LOSS_MODES) + ["bogus"])
def test_loss_mode_flags_match_jax(mode):
    if mode == "bogus":
        for mod in (jrpq, prpq):
            with pytest.raises(ValueError, match="unknown loss_mode"):
                mod.loss_mode_flags(mode)
        return
    assert prpq.LOSS_MODES == jrpq.LOSS_MODES
    assert prpq.loss_mode_flags(mode) == jrpq.loss_mode_flags(mode)


@pytest.mark.parametrize("mode", list(jqc.LOSS_MODES) + ["bogus"])
def test_quality_check_loss_mode_args_match_jax(mode):
    if mode == "bogus":
        for mod in (jqc, pqc):
            with pytest.raises(ValueError, match="unknown loss_mode"):
                mod.loss_mode_args(mode)
        return
    assert pqc.LOSS_MODES == jqc.LOSS_MODES
    assert pqc.loss_mode_args(mode) == jqc.loss_mode_args(mode)


@pytest.mark.parametrize("kw,steps", [
    (dict(train_timeout_s=72 * 3600, inplane=256), 10_000),
    (dict(), 10), (dict(), 3600), (dict(), 10 ** 6),
    (dict(inplane=256), 100_000), (dict(inplane=128, depth=48), 900),
    (dict(latent=128, depth=12), 2000), (dict(train_timeout_s=60.5), 1),
])
def test_compute_train_budget_matches_jax(kw, steps):
    assert (prpq.compute_train_budget(_ns(**kw), steps)
            == jrpq.compute_train_budget(_ns(**kw), steps))


@pytest.mark.parametrize("kept,kw", [
    ({}, {}),
    ({"width": None}, {}),
    ({"downsample_steps": 4, "width": 32, "ex_loss_weight1": 0.01,
      "use_lr_scheduler": True, "model": "ae", "depth": 32,
      "latent": 128, "batch_size": 8}, {}),
    ({"dataset": "ACDC", "latent_width": 16, "lr_warmup_steps": 100,
      "ema_decay": 0.999, "train_latent_interp": "lanczos3",
      "compute_dtype": "bfloat16", "aug_noise": True, "aug_blur": 1,
      "max_grad_norm": 1}, {}),
    ({"image_mix_loss_func": "perceptual", "use_batchnorm": True},
     dict(loss_mode="mse")),
    ({"image_mix_loss_func": "mse", "use_ssim_loss": True,
      "use_batchnorm": False}, dict(loss_mode="perceptual",
                                    use_batchnorm=1)),
    ({"image_mix_loss_func": "perceptual_enc"}, {}),
    ({"downsample_steps": 3, "width": 64, "image_mix_loss_func": "mse",
      "use_batchnorm": 0}, dict(use_batchnorm=0)),
])
def test_apply_reuse_overrides_matches_jax(kept, kw):
    jns, pns = _ns(**kw), _ns(**kw)
    assert (prpq.apply_reuse_overrides(dict(kept), pns)
            == jrpq.apply_reuse_overrides(dict(kept), jns))
    assert vars(pns) == vars(jns)


@pytest.mark.parametrize("case", [
    ("auto", 0.999, True, 120), ("auto", 0.999, False, 120),
    ("auto", 0.0, True, 120), ("auto", 0.0, False, "caisr"),
    ("sweep", 0.999, True, 117), ("ema", 0.999, True, 117),
    ("ema", 0.0, False, 117)])
def test_select_score_checkpoint_matches_jax(case):
    if case[0] == "ema" and not case[2]:
        for mod in (jrpq, prpq):
            with pytest.raises(SystemExit, match="--score ema"):
                mod.select_score_checkpoint(*case)
        return
    assert (prpq.select_score_checkpoint(*case)
            == jrpq.select_score_checkpoint(*case))


def test_parsers_match_jax():
    """Every flag of JAX's tools, with its default and choices; the
    port adds ``--device`` (cuda unless asked)."""
    for jmod_parser, pparser in (
            (jrpq.build_parser(), prpq.build_parser()),
            (_jax_qc_parser(), pqc.build_parser())):
        jact = {a.dest: a for a in jmod_parser._actions}
        pact = {a.dest: a for a in pparser._actions}
        assert set(pact) - set(jact) == {"device"}
        assert set(jact) <= set(pact)
        for dest, a in jact.items():
            b = pact[dest]
            assert (a.default, a.choices, a.type, a.option_strings,
                    a.nargs, a.const) == (b.default, b.choices, b.type,
                                          b.option_strings, b.nargs,
                                          b.const), dest
        assert pact["device"].default == "cuda"


def _jax_qc_parser():
    """JAX's quality_check builds its parser inside main: capture it."""
    captured = {}

    class Stop(Exception):
        pass

    orig = argparse.ArgumentParser.parse_args

    def grab(self, *a, **k):
        captured["p"] = self
        raise Stop

    argparse.ArgumentParser.parse_args = grab
    try:
        jqc.main()
    except Stop:
        pass
    finally:
        argparse.ArgumentParser.parse_args = orig
    return captured["p"]


# ---------------------------------------------------------------------------
# child command lines and guards
# ---------------------------------------------------------------------------

class _Stop(Exception):
    pass


def _capture(monkeypatch, mod, call):
    """The child commands ``mod.main`` runs up to the find-best sweep
    (``what`` → argv), each tool's ``run_child`` recording instead of
    running; the sweep stops the run."""
    seen = {}

    def fake(cmd, data_root, what, **kw):
        seen[what] = (list(cmd), data_root, kw)
        if what == "find_best":
            raise _Stop

    monkeypatch.setattr(mod, "_run", fake)
    with pytest.raises(_Stop):
        call()
    return seen


CHILD_ARGV = [
    ["--dataset_shape", "OASIS", "--loss_mode", "mse", "--phantom_noise",
     "0.03", "--latent_width", "32", "--use_batchnorm", "0",
     "--lr_schedule", "--latent_interp", "lanczos3", "--epochs", "450"],
    ["--dataset_shape", "ACDC", "--loss_mode", "mse", "--compute_dtype",
     "bfloat16", "--train_latent_interp", "lanczos3", "--latent_interp",
     "lanczos3", "--num_frames", "2", "--lr_schedule"],
    ["--dataset_shape", "dHCP", "--aug_noise", "--aug_blur",
     "--max_grad_norm", "1.0", "--ema_decay", "0.999", "--n_res_block",
     "2", "--lr_warmup_steps", "50", "--step_timeout_s", "0",
     "--latent_interp", "fitted", "--loss_mode", "perceptual_enc"],
    ["--model", "acai_combined", "--loss_mode", "mse+ssim", "--use_batchnorm",
     "1", "--latent_interp", "cubic", "--sweep_last", "5", "--epochs", "9",
     "--train_latent_interp", "cubic"],
]


@pytest.mark.parametrize("argv", CHILD_ARGV,
                         ids=["oasis_recipe", "acdc_bf16", "dhcp_fitted",
                              "acai"])
def test_child_commands_match_jax_after_the_entry_point(monkeypatch, argv):
    small = ["--n_patients", str(N), "--num_slices", str(SLICES),
             "--inplane", str(HW)]
    monkeypatch.setattr(sys, "argv", ["real_pipeline_quality.py", *small,
                                      *argv])
    monkeypatch.setenv("SR_DATA_ROOT", "unset")
    jseen = _capture(monkeypatch, jrpq, jrpq.main)
    pseen = _capture(monkeypatch, prpq,
                     lambda: prpq.main([*small, *argv, "--device", "cpu"]))
    assert sorted(jseen) == sorted(pseen)
    entry = {"train": 2, "fit_taps": 2, "find_best": 2}
    command = {"train": ("train-cardiac" if "ACDC" in argv
                         else "train-brain"),
               "fit_taps": "fit-latent-taps",
               "find_best": "find-best-model"}
    for what, (jcmd, jroot, jkw) in jseen.items():
        pcmd, proot, pkw = pseen[what]
        jwork, pwork = os.path.dirname(jroot), os.path.dirname(proot)
        assert pcmd[:6] == prpq.cli_command(command[what], "cpu")
        assert pcmd[:6] == [sys.executable, "-m",
                            "superresolution_aniso_mri_tpu_torch.cli",
                            command[what], "--device", "cpu"]
        norm = [a.replace(pwork, "WORK") for a in pcmd[6:]]
        assert norm == [a.replace(jwork, "WORK")
                        for a in jcmd[entry[what]:]], what
        assert {k: (v.replace(pwork, "WORK") if isinstance(v, str) else v)
                for k, v in pkw.items()} == {
            k: (v.replace(jwork, "WORK") if isinstance(v, str) else v)
            for k, v in jkw.items()}, what
    # the temp work dirs are gone (no --keep)
    assert not os.path.exists(os.path.dirname(pseen["train"][1]))


GUARDS = [
    (["--extend"], "--extend requires --reuse"),
    (["--score_noise", "0.05"], "--score_noise requires --reuse"),
    (["--reuse", "WORK", "--extend", "--score_noise", "0.05"],
     "--score_noise requires --reuse"),
    (["--dataset_shape", "OASIS", "--n_patients", "5"], ">= 7 patients"),
    (["--dataset_shape", "dHCP", "--n_patients", "6"], ">= 7 patients"),
    (["--dataset_shape", "ACDC", "--n_patients", "5"], ">= 7 patients"),
    (["--dataset_shape", "ACDC", "--downsample_steps", "3"],
     "requires --downsample_steps 2"),
    (["--reuse", "WORK/missing"], "no exper/rpq/models"),
]


@pytest.mark.parametrize("argv,message", GUARDS,
                         ids=["extend", "score_noise", "score_noise_extend",
                              "oasis5", "dhcp6", "acdc5", "acdc_ds3",
                              "reuse_missing"])
def test_guards_match_jax(monkeypatch, tmp_path, argv, message):
    argv = [a.replace("WORK", str(tmp_path)) for a in argv]

    def no_child(*a, **k):
        raise AssertionError("a guard let a child run")

    for mod in (jrpq, prpq):
        monkeypatch.setattr(mod, "_run", no_child)
    monkeypatch.setattr(sys, "argv", ["real_pipeline_quality.py", *argv])
    with pytest.raises(SystemExit, match=message):
        jrpq.main()
    with pytest.raises(SystemExit, match=message):
        prpq.main([*argv, "--device", "cpu"])


# ---------------------------------------------------------------------------
# run_child
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mod", [jsub, psub], ids=["jax", "port"])
def test_run_child_timeout_clamped_below_epoll_limit(tmp_path, mod):
    r = mod.run_child([sys.executable, "-c", "print('ok')"],
                      str(tmp_path), "clamp-test", timeout=3_200_000,
                      verbose=False)
    assert r.returncode == 0 and "ok" in r.stdout


@pytest.mark.parametrize("mod", [jsub, psub], ids=["jax", "port"])
def test_run_child_budget_caps_across_stall_restarts(tmp_path, mod):
    t0 = time.time()
    log = tmp_path / "child.log"
    log.write_text("an earlier call's log\n")
    with pytest.raises(SystemExit, match="budget exhausted"):
        mod.run_child(
            [sys.executable, "-c",
             "import sys, time; print('attempt'); time.sleep(1.0); "
             "sys.exit(75)"],
            str(tmp_path), "budget-test", log_path=str(log), timeout=4.0,
            stall_restarts=10, min_stall_uptime_s=0.5, verbose=False)
    assert time.time() - t0 < 30
    text = log.read_text()
    assert "earlier" not in text and text.count("attempt") == 1


@pytest.mark.parametrize("mod", [jsub, psub], ids=["jax", "port"])
def test_run_child_environment_and_failure_tails(tmp_path, mod):
    code = ("import os, sys; print(sys.path); print(os.getcwd()); "
            "print(os.environ['SR_DATA_ROOT']); sys.exit(3)")
    with pytest.raises(SystemExit, match="FAIL \\[env\\]") as e:
        mod.run_child([sys.executable, "-c", code], str(tmp_path), "env",
                      verbose=False)
    out = str(e.value)
    assert str(tmp_path) in out and mod.REPO in out
    assert jsub.REPO == psub.REPO


# ---------------------------------------------------------------------------
# the scoring leg, end to end
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def kept_work(tmp_path_factory):
    """A kept work directory as ``--keep`` leaves it: the OASIS tree at
    σ 0.03, its fabrication.json, and ``exper/rpq`` trained by the
    port's training command for 3 epochs on the CPU (a model whose
    VIF is not 0)."""
    from superresolution_aniso_mri_tpu_torch.cli import entry

    work = str(tmp_path_factory.mktemp("rpq_work"))
    data = os.path.join(work, "data")
    prpq.make_textured_oasis_tree(data, 3, N, HW, SLICES, noise_sigma=0.03)
    with open(os.path.join(work, "fabrication.json"), "w") as f:
        json.dump({"dataset_shape": "OASIS", "anatomy": "rotate",
                   "n_patients": N, "num_slices": SLICES, "inplane": HW,
                   "num_frames": 6, "phantom_noise": 0.03}, f)
    old = os.environ.get("SR_DATA_ROOT")
    os.environ["SR_DATA_ROOT"] = data
    try:
        entry.train_brain([
            "-d", "OASIS", "-m", "ae_combined", "--downsample_steps", "3",
            "--width", str(HW), "--latent_width", "8", "--latent", "8",
            "--depth", "4", "--aug_patch_size", str(HW), "-b", "4",
            "--lr", "0.002", "-e", "3", "--epoch_threshold", "-1",
            "--image_mix_loss_func", "mse", "--use_batchnorm", "0",
            "--volume_preview_interval", "0", "--seed", "7",
            "-o", os.path.join(work, "exper"), "-id", "rpq",
            "--device", "cpu"])
    finally:
        if old is None:
            os.environ.pop("SR_DATA_ROOT", None)
        else:
            os.environ["SR_DATA_ROOT"] = old
    assert os.path.isfile(os.path.join(work, "exper", "rpq", "models",
                                       "caisr.models"))
    return work


def test_scoring_leg_matches_jax(monkeypatch, tmp_path, kept_work):
    argv = ["--reuse", kept_work, "--checkpoint", "caisr",
            "--extra_test_volumes", "2", "--latent_interp", "lanczos3"]
    jout, pout = str(tmp_path / "jax.jsonl"), str(tmp_path / "port.jsonl")

    def no_child(*a, **k):
        raise AssertionError("--checkpoint scoring ran a child")

    for mod in (jrpq, prpq):
        monkeypatch.setattr(mod, "_run", no_child)
    monkeypatch.setenv("SR_DATA_ROOT", "unset")
    monkeypatch.setattr(sys, "argv", ["real_pipeline_quality.py", *argv,
                                      "--json_out", jout])
    jrpq.main()
    returned = prpq.main([*argv, "--json_out", pout, "--device", "cpu"])
    with open(jout) as f:
        jrow = json.loads(f.read())
    with open(pout) as f:
        prow = json.loads(f.read())
    assert returned == prow
    assert list(prow) == list(jrow)
    for k, v in jrow.items():
        if k not in METRIC_KEYS:
            assert prow[k] == v, k
            continue
        assert list(prow[k]) == list(v), k
        for m, want in v.items():
            got = prow[k][m]
            assert abs(got - want) <= ROW_RTOL * abs(want) + 1e-5, (k, m,
                                                                   got, want)
    assert jrow["checkpoint"] == "caisr" and jrow["n_extra_test"] == 2


def test_quality_check_row_matches_jax(monkeypatch, tmp_path):
    """One epoch of each tool on the same phantoms: the same row keys
    and non-timing values, the conventional methods' scores (the
    phantoms alone decide them) within ``ROW_RTOL``; the trained models
    differ (each package's own initialisers)."""
    argv = ["--epochs", "1", "--width", "16", "--depth", "4",
            "--num_train_volumes", "2", "--batch_size", "4",
            "--downsample_steps", "2", "--phantom", "textured"]
    jout, pout = str(tmp_path / "jax.jsonl"), str(tmp_path / "port.jsonl")
    monkeypatch.setattr(sys, "argv", ["quality_check.py", *argv,
                                      "--json_out", jout])
    jqc.main()
    prow = pqc.main([*argv, "--json_out", pout, "--device", "cpu"])
    with open(jout) as f:
        jrow = json.loads(f.read())
    with open(pout) as f:
        assert json.loads(f.read()) == prow
    assert list(prow) == list(jrow)
    for k in ("loss_mode", "lpips_mode", "latent_interp", "epochs", "depth",
              "phantom", "downsample_steps"):
        assert prow[k] == jrow[k], k
    for m, want in jrow["best_conventional"].items():
        got = prow["best_conventional"][m]
        assert abs(got - want) <= ROW_RTOL * abs(want) + 1e-5, (m, got,
                                                               want)
    assert all(np.isfinite(v) for v in prow["model"].values())


@pytest.mark.parametrize("tool", ["rpq", "qc"])
def test_quality_tools_default_to_the_card(tool):
    """Without ``--device cpu`` the tools take the card, and without
    one they raise before training anything."""
    mod = prpq if tool == "rpq" else pqc
    assert mod.build_parser().parse_args([]).device == "cuda"
    if tool == "qc":
        with pytest.raises(RuntimeError, match="no CUDA device"):
            pqc.main(["--epochs", "1"])


def test_quality_check_batch_guard_matches_jax(monkeypatch):
    argv = ["--num_train_volumes", "1", "--batch_size", "64", "--width",
            "16", "--depth", "4", "--downsample_steps", "2"]
    monkeypatch.setattr(sys, "argv", ["quality_check.py", *argv])
    with pytest.raises(SystemExit, match="exceeds the"):
        jqc.main()
    with pytest.raises(SystemExit, match="exceeds the"):
        pqc.main([*argv, "--device", "cpu"])


def test_commands_log_their_kernel_launches(monkeypatch, tmp_path):
    """With ``SR_KERNEL_LAUNCHES_LOG`` set, a command of the port's CLI
    appends its name and its kernel launch counts (how phase 18 of
    ``chip_smoke.py`` counts a child's SSIM launches); unset, nothing
    is written."""
    from superresolution_aniso_mri_tpu_torch.cli.__main__ import main
    from superresolution_aniso_mri_tpu_torch.ops import cuda_kernels

    argv = ["quality-check", "--epochs", "1", "--width", "16", "--depth",
            "4", "--num_train_volumes", "2", "--batch_size", "4",
            "--downsample_steps", "2", "--device", "cpu"]
    log = tmp_path / "launches.jsonl"
    monkeypatch.delenv("SR_KERNEL_LAUNCHES_LOG", raising=False)
    assert main(argv) == 0 and not log.exists()
    monkeypatch.setenv("SR_KERNEL_LAUNCHES_LOG", str(log))
    for _ in range(2):
        assert main(argv) == 0
    lines = [json.loads(line) for line in log.read_text().splitlines()]
    assert lines == [{"command": "quality-check",
                      "launches": dict(cuda_kernels.LAUNCHES)}] * 2
    assert set(lines[0]["launches"]) == {"ssim_slice"}
