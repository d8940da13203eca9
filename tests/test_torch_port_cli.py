"""PyTorch port, the experiment-directory commands against the JAX
package on the CPU: one experiment trained by each package's train
command (the same argv), then generate-hr-volumes, find-best-model,
serve-hr-volumes and create_hr_images across the two: a JAX-written
directory serves and scores in the port, a port-written one serves in
JAX, with the same results.

Tiny config: width 32, latent_width 16, depth 8, latent 8, ds 2,
``--limited_load``, 2 epochs of 8 steps, ``--epoch_threshold -1`` (so
``models/0.models`` and ``1.models``). The JAX side runs in-process at
``jax.default_matmul_precision("highest")``; float32 volumes agree
within ``ATOL`` = 1e-5, as in ``tests/test_torch_port_serve.py``.
"""
import json
import os
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
import yaml

from superresolution_aniso_mri_tpu.cli import entry as jentry
from superresolution_aniso_mri_tpu.config import arguments as jargs
from superresolution_aniso_mri_tpu_torch.cli import entry
from superresolution_aniso_mri_tpu_torch.utils import read_image, write_image

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL = 1e-5
TINY = ["-d", "MNIST3D", "--use_synthetic_data", "-m", "ae_combined",
        "--image_mix_loss_func", "mse", "--downsample_steps", "2",
        "--epoch_threshold", "-1", "--width", "32", "--latent_width", "16",
        "--depth", "8", "--latent", "8", "--limited_load", "-b", "8",
        "-bt", "4", "--num_val_batches", "2", "--lr", "1e-4", "-e", "2"]
AFFINE = np.array([[0.0, -1.2, 0.0, 10.5], [1.1, 0.0, 0.0, -3.0],
                   [0.0, 0.0, 3.0, 7.25], [0.0, 0.0, 0.0, 1.0]])


def _highest():
    return jax.default_matmul_precision("highest")


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    """{'jax': JAX-trained experiment dir, 'port': port-trained one,
    'inputs': a directory of volumes to densify}."""
    from superresolution_aniso_mri_tpu.cli.train_loop import run_training

    root = tmp_path_factory.mktemp("cli")
    _, d = jargs.parse_args(TINY + ["-o", str(root), "-id", "jax"])
    with _highest():
        run_training(d, verbose=False)
    entry.train_brain(TINY + ["-o", str(root), "-id", "port", "--device",
                              "cpu"])
    inputs = root / "inputs"
    inputs.mkdir()
    rng = np.random.RandomState(0)
    # a [0, 1] volume with a sform affine and a label companion, and one
    # outside [0, 1] (the percentile rescale path) without labels
    write_image(str(inputs / "a.nii.gz"),
                rng.rand(5, 36, 40).astype(np.float32),
                spacing=(3.0, 1.1, 1.2), affine=AFFINE)
    write_image(str(inputs / "a_gt.nii.gz"),
                rng.randint(0, 4, (5, 36, 40)).astype(np.int16),
                spacing=(3.0, 1.1, 1.2), affine=AFFINE, dtype=np.int16)
    write_image(str(inputs / "b.nii"),
                (rng.rand(4, 32, 28) * 900 - 100).astype(np.float32),
                spacing=(2.0, 1.0, 1.0))
    return {"jax": str(root / "jax"), "port": str(root / "port"),
            "inputs": str(inputs), "root": str(root)}


def test_both_train_commands_write_the_same_experiment_files(dirs):
    """Same file names (numbered checkpoints carry the 0-based epoch,
    PNG names the toy patient id), the same settings keys and values
    (but the device and the paths), settings.yaml as pyyaml writes it,
    and the same loss archive keys."""
    jd, pd = dirs["jax"], dirs["port"]
    for sub in ("", "models", "log_images"):
        assert sorted(os.listdir(os.path.join(pd, sub))) == sorted(
            os.listdir(os.path.join(jd, sub))), sub
    assert sorted(os.listdir(os.path.join(pd, "models"))) == [
        "0.models", "1.models", "ae.models", "caisr.models", "last.models"]
    with open(os.path.join(pd, "settings.yaml")) as f:
        text = f.read()
    got = yaml.safe_load(text)
    assert text == yaml.safe_dump(got, sort_keys=True)
    with open(os.path.join(jd, "settings.yaml")) as f:
        want = yaml.safe_load(f)
    assert sorted(got) == sorted(want)
    assert (got.pop("device"), want.pop("device")) == ("cpu", "tpu")
    for key in ("output_dir", "dir_models", "dir_images", "exper_id"):
        assert got.pop(key) != want.pop(key)
    assert got == want
    for npz in ("loss_iters.npz", "losses_train.npz", "losses_test.npz"):
        g = np.load(os.path.join(pd, npz))
        w = np.load(os.path.join(jd, npz))
        assert sorted(g.files) == sorted(w.files)
        assert all(g[k].shape == w[k].shape == (2,) for k in w.files)


def _generate(fn, exper_dir, out, extra, **kw):
    argv = ["--exper_dir", exper_dir, "--data_input_dir", kw.pop("inputs"),
            "--output_dir", out, "--num_interpolations", "2"] + extra
    with _highest():
        fn(argv, **kw)
    return {name: read_image(os.path.join(out, name))
            for name in sorted(os.listdir(out))}


def _assert_same_outputs(got, want):
    assert sorted(got) == sorted(want) == [
        "a_ni02.nii.gz", "a_ni02_gt.nii.gz", "b_ni02.nii.gz"]
    for name in want:
        (g, g_sp, g_aff), (w, w_sp, w_aff) = got[name], want[name]
        assert g.dtype == w.dtype
        if name.endswith("_gt.nii.gz"):
            np.testing.assert_array_equal(g, w)
        else:
            np.testing.assert_allclose(g, w, atol=ATOL, err_msg=name)
        np.testing.assert_array_equal(g_sp, w_sp)
        np.testing.assert_array_equal(g_aff, w_aff)
    a, spacing, affine = got["a_ni02.nii.gz"]
    assert a.shape == (13, 36, 40) and got["b_ni02.nii.gz"][0].shape == (
        10, 32, 28)
    np.testing.assert_allclose(spacing, [1.0, 1.1, 1.2], rtol=1e-6)
    np.testing.assert_allclose(affine[:3, 2], AFFINE[:3, 2] / 3, rtol=1e-6)


@pytest.mark.parametrize("extra", [[], ["--model_nbr", "1",
                                        "--latent_interp", "lanczos3"]],
                         ids=["caisr_linear", "epoch1_lanczos3"])
def test_port_generates_from_a_jax_dir_as_jax_does(dirs, tmp_path, extra):
    """The JAX dir's settings.yaml (device: tpu) and checkpoints serve in
    the port: the _ni02 volumes, their spacing and sform, and the label
    companion's output equal JAX's generate_hr_volumes."""
    want = _generate(jentry.generate_hr_volumes, dirs["jax"],
                     str(tmp_path / "jax"), extra, inputs=dirs["inputs"])
    got = _generate(entry.generate_hr_volumes, dirs["jax"],
                    str(tmp_path / "port"), extra, inputs=dirs["inputs"],
                    device="cpu")
    _assert_same_outputs(got, want)


def test_jax_generates_from_a_port_dir_as_the_port_does(dirs, tmp_path):
    """The port-written dir (settings.yaml, checkpoints) serves in JAX
    through get_trainer + generate_hr_volumes with the port's volumes."""
    got = _generate(entry.generate_hr_volumes, dirs["port"],
                    str(tmp_path / "port"), [], inputs=dirs["inputs"],
                    device="cpu")
    want = _generate(jentry.generate_hr_volumes, dirs["port"],
                     str(tmp_path / "jax"), [], inputs=dirs["inputs"])
    _assert_same_outputs(got, want)


@pytest.mark.parametrize("batched", [False, True], ids=["plain", "batched"])
def test_find_best_model_on_a_jax_dir_matches_jax(dirs, tmp_path, batched):
    """The port's sweep of the JAX dir writes model_perf_ds2.npz with
    JAX's keys and epochs and values within 1e-4, and picks the same
    epochs."""
    exper = str(tmp_path / "exper")
    shutil.copytree(dirs["jax"], exper)
    argv = ["--exper_dir", exper, "--use_synthetic_data"] + (
        ["--batched"] if batched else [])
    npz = os.path.join(exper, "model_perf_ds2.npz")
    with _highest():
        want_res = jentry.find_best_model(argv)
    want = dict(np.load(npz))
    os.remove(npz)
    got_res = entry.find_best_model(argv, device="cpu")
    got = dict(np.load(npz))
    assert sorted(got) == sorted(want) == sorted(
        ["epochs", "ssim", "psnr", "vif", "ssim_synth", "psnr_synth",
         "vif_synth"])
    np.testing.assert_array_equal(got["epochs"], [0, 1])
    np.testing.assert_array_equal(got["epochs"], want["epochs"])
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=1e-4, rtol=0,
                                   err_msg=k)
    assert {k: v["epoch"] for k, v in got_res["best"].items()} == {
        k: v["epoch"] for k, v in want_res["best"].items()}


def _eval_volumes(volume_cls):
    """The 2 toy validation volumes (the first with labels) and a 4D
    cine-like stack of both, as ``volume_cls`` instances."""
    from superresolution_aniso_mri_tpu_torch.data.datasets import get_datasets

    val = get_datasets(dict(dataset="MNIST3D", width=32, downsample_steps=2,
                            seed=3, limited_load=True))[1]
    labels = np.digitize(val[0].image, [0.3, 0.6]).astype(np.int32)
    return [volume_cls(image=val[0].image, spacing=val[0].spacing,
                       patient_id=val[0].patient_id, labels=labels),
            volume_cls(image=val[1].image, spacing=val[1].spacing,
                       patient_id=val[1].patient_id),
            volume_cls(image=np.stack([v.image for v in val]),
                       spacing=val[0].spacing, patient_id="cine")]


def test_create_hr_images_saves_and_scores_like_jax(dirs, tmp_path):
    """3D volumes (one with labels) and a 4D one: the same per-volume
    scores (1e-4), metric npz and saved volumes as JAX."""
    from superresolution_aniso_mri_tpu.data import Volume as JaxVolume
    from superresolution_aniso_mri_tpu.evaluate import (
        create_hr_images as jax_create)
    from superresolution_aniso_mri_tpu.train import get_trainer as jax_trainer
    from superresolution_aniso_mri_tpu_torch.data import Volume
    from superresolution_aniso_mri_tpu_torch.evaluate import create_hr_images
    from superresolution_aniso_mri_tpu_torch.train import get_trainer

    with _highest():
        want = jax_create(jax_trainer(dirs["jax"], "caisr"),
                          _eval_volumes(JaxVolume), 2, str(tmp_path / "jax"),
                          save_volumes=True)
    vols = _eval_volumes(Volume)
    got = create_hr_images(get_trainer(dirs["jax"], "caisr", device="cpu"),
                           vols, 2, str(tmp_path / "port"),
                           save_volumes=True)
    assert list(got["per_volume"]) == list(want["per_volume"])
    for pid, m in want["per_volume"].items():
        for k, v in m.items():
            np.testing.assert_allclose(got["per_volume"][pid][k], v,
                                       atol=1e-4, err_msg=f"{pid} {k}")
    for k, (m, sd) in want["aggregate"].items():
        np.testing.assert_allclose(got["aggregate"][k], (m, sd), atol=1e-4)
    g_npz = np.load(tmp_path / "port" / "results" / "model_2x.npz")
    w_npz = np.load(tmp_path / "jax" / "results" / "model_2x.npz")
    assert sorted(g_npz.files) == sorted(w_npz.files)
    np.testing.assert_array_equal(g_npz["patient_ids"], w_npz["patient_ids"])
    saved = []                        # labels go to '<output_dir>_labels'
    for side in ("jax", "jax_labels"):
        for root, _, files in os.walk(tmp_path / side):
            saved += [os.path.relpath(os.path.join(root, f), tmp_path)
                      for f in files if f.endswith(".nii.gz")]
    assert len(saved) == 4            # 3 volumes + the labels of the first
    for rel in saved:
        g = read_image(str(tmp_path / rel.replace("jax", "port", 1)))
        w = read_image(str(tmp_path / rel))
        np.testing.assert_allclose(g[0], w[0], atol=ATOL, err_msg=rel)
        assert g[0].dtype == w[0].dtype
        np.testing.assert_array_equal(g[1], w[1])
    # the conventional baseline needs no trainer: the same scores as JAX
    with _highest():
        want = jax_create(None, _eval_volumes(JaxVolume), 2,
                          interpol_method="linear")
    got = create_hr_images(None, vols, 2, interpol_method="linear",
                           device="cpu")
    for pid, v in want["per_volume"].items():
        for k in v:
            np.testing.assert_allclose(got["per_volume"][pid][k], v[k],
                                       atol=1e-4, err_msg=f"linear {pid} {k}")


@pytest.mark.parametrize("per_frame", [False, True])
def test_batched_volume_scores_match_jax(dirs, per_frame):
    from superresolution_aniso_mri_tpu.data import Volume as JaxVolume
    from superresolution_aniso_mri_tpu.evaluate import (
        evaluate_volumes_batched as jax_eval)
    from superresolution_aniso_mri_tpu.train import get_trainer as jax_trainer
    from superresolution_aniso_mri_tpu_torch.data import Volume
    from superresolution_aniso_mri_tpu_torch.evaluate import (
        evaluate_volumes_batched)
    from superresolution_aniso_mri_tpu_torch.train import get_trainer

    with _highest():
        want = jax_eval(jax_trainer(dirs["jax"], "1"),
                        _eval_volumes(JaxVolume), 2, per_frame=per_frame,
                        latent_interp="cubic")
    got = evaluate_volumes_batched(get_trainer(dirs["jax"], "1",
                                               device="cpu"),
                                   _eval_volumes(Volume), 2,
                                   per_frame=per_frame, latent_interp="cubic")
    assert sorted(got) == sorted(want)
    for pid, m in want.items():
        for k, v in m.items():
            np.testing.assert_allclose(got[pid][k], v, atol=1e-4,
                                       err_msg=f"{pid} {k}")


def test_serve_once_writes_the_manifest_and_guards_its_dirs(dirs, tmp_path):
    out, manifest = tmp_path / "served", tmp_path / "m.jsonl"
    argv = ["--exper_dir", dirs["jax"], "--watch_dir", dirs["inputs"],
            "--output_dir", str(out), "--once", "--manifest",
            str(manifest), "--latent_interp", "lanczos3"]
    assert entry.serve_hr_volumes(argv, device="cpu") == 2
    lines = [json.loads(line) for line in manifest.read_text().splitlines()]
    assert [os.path.basename(r["input"]) for r in lines] == ["a.nii.gz",
                                                             "b.nii"]
    assert [len(r["outputs"]) for r in lines] == [2, 1]
    assert all(r["seconds"] > 0 for r in lines)
    assert sorted(os.listdir(out)) == ["a_ni01.nii.gz", "a_ni01_gt.nii.gz",
                                       "b_ni01.nii.gz"]
    gen = tmp_path / "gen"
    entry.generate_hr_volumes(
        ["--exper_dir", dirs["jax"], "--data_input_dir", dirs["inputs"],
         "--output_dir", str(gen), "--latent_interp", "lanczos3"],
        device="cpu")
    for name in os.listdir(out):
        np.testing.assert_array_equal(read_image(str(out / name))[0],
                                      read_image(str(gen / name))[0])
    with pytest.raises(SystemExit, match="does not exist"):
        entry.serve_hr_volumes(["--exper_dir", dirs["jax"], "--watch_dir",
                                str(tmp_path / "nope"), "--output_dir",
                                str(out), "--once"], device="cpu")
    with pytest.raises(SystemExit, match="must differ"):
        entry.serve_hr_volumes(["--exper_dir", dirs["jax"], "--watch_dir",
                                dirs["inputs"], "--output_dir",
                                dirs["inputs"] + "/", "--once"],
                               device="cpu")


def test_port_train_resumes_and_saves_on_interrupt(dirs, tmp_path,
                                                    monkeypatch):
    """--auto_resume continues from last.models (one more epoch); an
    interrupt saves last.models with the interrupted epoch."""
    from superresolution_aniso_mri_tpu_torch.train import Trainer

    root = tmp_path / "resume"
    shutil.copytree(dirs["port"], root / "port")
    tr = entry.train_brain(TINY[:-1] + ["3", "-o", str(root), "-id", "port",
                                        "--device", "cpu", "--auto_resume"])
    assert tr.epoch == 3
    assert "2.models" in os.listdir(root / "port" / "models")
    assert np.load(root / "port" / "losses_train.npz")["loss_ae"].shape == (
        3,)

    def interrupted(self, batch):
        raise KeyboardInterrupt

    monkeypatch.setattr(Trainer, "train", interrupted)
    tr = entry.train_brain(TINY[:-1] + ["5", "-o", str(root), "-id", "port",
                                        "--device", "cpu", "--auto_resume"])
    assert tr.epoch == 3
    from superresolution_aniso_mri_tpu_torch.train import get_trainer

    assert get_trainer(str(root / "port"), "last", device="cpu").epoch == 3


@pytest.mark.parametrize("extra, item", [
    (["--get_masks"], "labeled volumes"),
    (["-d", "MNISTRoto", "--train_latent_interp", "lanczos3"],
     "not supported for MNISTRoto"),
    (["--num_processes", "2"], "incomplete configuration"),
    (["--num_devices", "2", "--steps_per_dispatch", "8"],
     "steps_per_dispatch > 1 is not supported with num_devices > 1"),
    (["--num_devices", "3"], r"batch pairs \(8\) must be divisible by "
                             r"num_devices \(3\)"),
])
def test_train_refuses_what_is_not_ported_before_writing(tmp_path, extra,
                                                         item):
    """The ValueErrors JAX raises, here before anything is written:
    ``--get_masks`` on a dataset without labels, MNISTRoto with a
    multi-tap ``--train_latent_interp``, ``--num_processes 2`` without a
    coordinator, ``--num_devices`` with ``--steps_per_dispatch > 1`` and
    a batch that ``--num_devices`` does not divide."""
    with pytest.raises(ValueError, match=item):
        entry.train_brain(TINY + ["-o", str(tmp_path), "-id", "x",
                                  "--device", "cpu"] + extra)
    assert not os.path.exists(tmp_path / "x")


def test_train_brain_trains_the_perceptual_mix_loss(tmp_path):
    """``--image_mix_loss_func perceptual`` trains (it was refused before
    the LPIPS port): finite losses, and settings.yaml records the LPIPS
    weights' mode as the JAX script does."""
    from superresolution_aniso_mri_tpu_torch.config import load_settings

    with pytest.warns(UserWarning, match="RANDOM VGG features"):
        tr = entry.train_brain(TINY + ["-o", str(tmp_path), "-id", "p",
                                       "--device", "cpu", "-e", "1",
                                       "--image_mix_loss_func",
                                       "perceptual"])
    settings = load_settings(str(tmp_path / "p" / "settings.yaml"))
    assert settings["image_mix_loss_func"] == "perceptual"
    assert settings["lpips_mode"] == "lin_converted_vgg_random"
    loss = np.load(tmp_path / "p" / "losses_train.npz")
    assert np.isfinite(loss["loss_ae_dist_extra"]).all()
    assert tr.lpips_params is not None


def test_commands_raise_without_a_card(dirs, tmp_path, monkeypatch):
    """No device given means CUDA; without a card every command raises
    device.resolve_device's error and writes nothing."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = str(tmp_path / "out")
    calls = [
        (entry.generate_hr_volumes, ["--exper_dir", dirs["jax"],
                                     "--data_input_dir", dirs["inputs"],
                                     "--output_dir", out]),
        (entry.serve_hr_volumes, ["--exper_dir", dirs["jax"], "--watch_dir",
                                  dirs["inputs"], "--output_dir", out,
                                  "--once"]),
        (entry.find_best_model, ["--exper_dir", dirs["jax"],
                                 "--use_synthetic_data"]),
        (entry.train_brain, TINY + ["-o", out, "-id", "x"]),
    ]
    for fn, argv in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fn(argv)
    assert not os.path.exists(out)


def test_dispatcher_runs_the_commands_and_names_the_missing_one(dirs,
                                                                tmp_path):
    from superresolution_aniso_mri_tpu_torch.cli.__main__ import (COMMANDS,
                                                                  main)

    assert sorted(COMMANDS) == ["convert-lpips-weights",
                                "convert-reference-checkpoint",
                                "export-reference-checkpoint",
                                "find-best-model", "fit-latent-taps",
                                "fit-perceptual-head",
                                "generate-hr-volumes", "lpips-gap-study",
                                "quality-check", "real-pipeline-quality",
                                "serve-hr-volumes",
                                "train-brain", "train-cardiac"]
    assert main([]) == 2 and main(["generate"]) == 2
    # the commands run on the card unless the caller asks for the CPU
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["fit-latent-taps", "--exper_dir", dirs["jax"]])
    for cmd in (["lpips-gap-study"],
                ["fit-perceptual-head", "--exper_dir", dirs["jax"]],
                ["quality-check"]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(cmd)
    with pytest.raises(SystemExit, match="cardiac datasets only"):
        main(["train-cardiac"] + TINY + ["--device", "cpu"])
    r = subprocess.run([sys.executable, "-m",
                        "superresolution_aniso_mri_tpu_torch.cli"],
                       cwd=REPO, capture_output=True, text=True, timeout=120)
    assert r.returncode == 2 and "train-brain" in r.stderr


def test_plain_and_batched_sweeps_agree(dirs, tmp_path):
    """The port's two sweeps of one experiment (per-volume
    create_hr_images, and one synthesis and one SSIM call per chunk)
    agree within 1e-4, the tolerance chip_smoke.py holds them to on the
    card."""
    exper = str(tmp_path / "exper")
    shutil.copytree(dirs["port"], exper)
    argv = ["--exper_dir", exper, "--use_synthetic_data"]
    plain = entry.find_best_model(argv, device="cpu")["history"]
    batched = entry.find_best_model(argv + ["--batched"],
                                    device="cpu")["history"]
    for k, v in plain.items():
        np.testing.assert_allclose(batched[k], v, atol=1e-4, rtol=0,
                                   err_msg=k)


def test_get_trainer_serves_any_vanilla_experiment(dirs, tmp_path):
    """An eval-mode trainer ignores what only training uses: a JAX
    experiment trained with the perceptual mix loss, EMA, TensorBoard
    and 2 devices still serves in the port. With ``ae_class:
    MultiChannelAE`` the trainer builds that class, so the VanillaACAI
    checkpoint does not fit it: a ValueError, as in JAX."""
    from superresolution_aniso_mri_tpu_torch.train import get_trainer

    exper = tmp_path / "exper"
    shutil.copytree(dirs["jax"], exper)
    path = exper / "settings.yaml"
    settings = yaml.safe_load(path.read_text())
    settings.update(image_mix_loss_func="perceptual", ema_decay=0.999,
                    log_tensorboard=True, num_devices=2, device="tpu")
    path.write_text(yaml.safe_dump(settings, sort_keys=True))
    trainer = get_trainer(str(exper), "caisr", device="cpu")
    assert trainer.eval_mode and trainer.epoch == 2
    assert not hasattr(trainer, "train_step")
    settings["ae_class"] = "MultiChannelAE"
    path.write_text(yaml.safe_dump(settings, sort_keys=True))
    assert type(get_trainer(str(exper), device="cpu")._ae_model()
                ).__name__ == "MultiChannelAE"
    with pytest.raises(ValueError, match="does not match"):
        get_trainer(str(exper), "caisr", device="cpu")
