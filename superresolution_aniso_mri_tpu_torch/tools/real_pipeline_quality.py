"""Production-pipeline quality benchmark on realistic-shaped data.

Port of the JAX package's ``tools/real_pipeline_quality.py``, with its
flags, defaults, prints and JSON row, and one more flag, ``--device``
(``cuda`` unless it says ``cpu``). Where ``quality-check`` measures
training quality through direct ``Trainer`` calls on phantoms, this
tool shows the same result through the whole production path a user
runs — the dataset's on-disk layout, the training command, the epoch
sweep and the scoring:

  1. fabricate an OASIS-shaped tree (``root/OASIS/nifti/OAS1_xxxx_MR1/
     *_t88_gfc[_<ds>mm].nii.gz``) of textured rotated-anatomy volumes
     (band-limited fine texture is what through-plane interpolation
     blurs away, so it separates the methods on VIF as real MRI does),
     or a dHCP- or ACDC-shaped one (``--dataset_shape``);
  2. train through ``python -m superresolution_aniso_mri_tpu_torch.cli
     train-brain | train-cardiac`` (a child process on ``--device``;
     this process touches no device until the child has exited);
  3. sweep the numbered checkpoints with ``find-best-model --batched``;
  4. score the chosen model against linear, bspline and lanczos on the
     held-out test split (and ``--extra_test_volumes`` fresh volumes)
     with ``evaluate.create_hr_images``, in this process on
     ``--device``, and print the side-by-side.

    python -m superresolution_aniso_mri_tpu_torch.cli real-pipeline-quality \\
        --epochs 450 --loss_mode mse --phantom_noise 0.03 \\
        --latent_width 32 --use_batchnorm 0 --lr_schedule \\
        --latent_interp lanczos3 --extra_test_volumes 20 \\
        --json_out docs/quality_port_r1.jsonl

The trees and the extra volumes are the JAX tool's arrays bit for bit
(the same phantoms, seeds and preprocessing), and its split files the
same bytes (``config/settings.py::dump_string_lists``), so the two
tools score a kept work directory (``--keep`` / ``--reuse``) alike.
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import re
import shutil
import sys
import tempfile

import numpy as np

from ._subproc import run_child as _run

LOSS_MODES = ("mse", "perceptual", "perceptual_enc", "mse+ssim")
CONVENTIONAL = ("linear", "bspline", "lanczos")
SCORED = ("ssim_synth", "psnr_synth", "vif_synth")


def cli_command(command: str, device: str) -> list:
    """The child's entry point: the port's command ``command`` on
    ``device``; the JAX tool's flags follow it unchanged."""
    return [sys.executable, "-m", "superresolution_aniso_mri_tpu_torch.cli",
            command, "--device", device]


def loss_mode_flags(mode: str):
    """--loss_mode → training-command flags (``ae_combined`` trains the
    perceptual mix unless ``--image_mix_loss_func`` is given).
    'perceptual_enc' = the encoder-backbone perceptual loss
    (``ops/perceptual.py``; ``weights/perceptual_enc.npz``)."""
    if mode == "mse":
        return ["--image_mix_loss_func", "mse"]
    if mode == "perceptual":
        return ["--image_mix_loss_func", "perceptual"]
    if mode == "perceptual_enc":
        return ["--image_mix_loss_func", "perceptual_enc"]
    if mode == "mse+ssim":
        return ["--image_mix_loss_func", "mse", "--use_ssim_loss"]
    raise ValueError(f"unknown loss_mode {mode!r}")


def _brain_phantom(inplane: int, num_slices: int, seed: int,
                   anatomy: str) -> np.ndarray:
    from ..data.synthetic import (make_anatomy3d_volume,
                                  make_textured_rotated_volume)

    if anatomy == "anatomy3d":
        # 3-D structures whose edges drift and vanish across slices
        return make_anatomy3d_volume(size=inplane, num_slices=num_slices,
                                     seed=seed).image
    return make_textured_rotated_volume(size=inplane, num_slices=num_slices,
                                        seed=seed).image


def make_textured_oasis_tree(data_root: str, ds: int, n_patients: int,
                             inplane: int, num_slices: int,
                             anatomy: str = "rotate",
                             noise_sigma: float = 0.0) -> None:
    """OASIS-shaped tree: per patient the HR file and its thick-slice LR
    companion ``_<ds>mm``, Rician noise (seed 20_000 + i) on the HR
    acquisition before the PSF, as a real LR scan averages it."""
    from ..data.synthetic import add_rician_noise
    from ..data.volume import simulate_thick_slices
    from ..utils.nifti import write_nifti

    for i in range(n_patients):
        hr = _brain_phantom(inplane, num_slices, 10_000 + i, anatomy)
        hr = add_rician_noise(hr, noise_sigma, seed=20_000 + i)
        pdir = os.path.join(data_root, "OASIS", "nifti",
                            f"OAS1_{i:04d}_MR1")
        os.makedirs(pdir, exist_ok=True)
        write_nifti(os.path.join(pdir, f"OAS1_{i:04d}_MR1_t88_gfc.nii.gz"),
                    hr, spacing=np.array([1.0, 1.0, 1.0]))
        write_nifti(
            os.path.join(pdir, f"OAS1_{i:04d}_MR1_t88_gfc_{ds}mm.nii.gz"),
            simulate_thick_slices(hr, float(ds)),
            spacing=np.array([1.0, 1.0, 1.0]))


def _split(pids) -> dict:
    """The fabricated trees' split: last 3 patients test, 2 validation,
    the rest training."""
    return {"training": pids[:-5], "validation": pids[-5:-3],
            "test": pids[-3:]}


def make_textured_dhcp_tree(data_root: str, ds: int, n_patients: int,
                            inplane: int, num_slices: int,
                            anatomy: str = "rotate",
                            noise_sigma: float = 0.0) -> None:
    """dHCP-shaped tree (``root/dHCP_cropped_256/<id>_t2w[_<ds/2>mm]
    .nii.gz`` + ``train_test_split.yaml``) at the neonatal 0.5 mm grid;
    LR files carry dHCP's ds/2 mm suffix."""
    from ..config.settings import save_string_lists
    from ..data.synthetic import add_rician_noise
    from ..data.volume import simulate_thick_slices
    from ..utils.nifti import write_nifti

    d = os.path.join(data_root, "dHCP_cropped_256")
    os.makedirs(d, exist_ok=True)
    pids = []
    for i in range(n_patients):
        pid = f"{1000 + i}"
        pids.append(pid)
        hr = _brain_phantom(inplane, num_slices, 10_000 + i, anatomy)
        hr = add_rician_noise(hr, noise_sigma, seed=20_000 + i)
        write_nifti(os.path.join(d, f"{pid}_t2w.nii.gz"), hr,
                    spacing=np.array([0.5, 0.5, 0.5]))
        write_nifti(os.path.join(d, f"{pid}_t2w_{ds / 2:.1f}mm.nii.gz"),
                    simulate_thick_slices(hr, float(ds)),
                    spacing=np.array([0.5, 0.5, 0.5]))
    save_string_lists(_split(pids), os.path.join(d, "train_test_split.yaml"))


def make_textured_acdc_tree(data_root: str, n_patients: int,
                            inplane: int, num_slices: int,
                            num_frames: int,
                            noise_sigma: float = 0.0) -> None:
    """ACDC-shaped 4-D cine tree (``root/ACDC/all_cardiac_phases/
    patientXXX/patientXXX_4d.nii.gz`` + ``train_val_test_split_sr.yaml``)
    of beating cardiac phantoms, written at the loader's 1.4 mm
    in-plane target (the per-frame resample keeps the shape) with 5 mm
    slices, at a raw-MRI-like intensity scale the loader's percentile
    rescale undoes."""
    from ..config.settings import save_string_lists
    from ..data.synthetic import make_cardiac4d_volume
    from ..utils.nifti import write_nifti

    pids = []
    for i in range(1, n_patients + 1):
        pid = f"patient{i:03d}"
        pids.append(pid)
        pdir = os.path.join(data_root, "ACDC", "all_cardiac_phases", pid)
        os.makedirs(pdir, exist_ok=True)
        vol4d = make_cardiac4d_volume(size=inplane, num_slices=num_slices,
                                      num_frames=num_frames,
                                      seed=10_000 + i,
                                      noise_sigma=noise_sigma)
        write_nifti(os.path.join(pdir, f"{pid}_4d.nii.gz"),
                    (vol4d * 400.0).astype(np.float32),
                    spacing=np.array([5.0, 1.4, 1.4]))
    save_string_lists(_split(pids), os.path.join(
        data_root, "ACDC", "train_val_test_split_sr.yaml"))


def compute_train_budget(args, steps: int) -> float:
    """Wall-clock budget of the training child: an explicit
    ``--train_timeout_s`` unchanged; else 4 s a step at inplane 64 /
    depth 24 / latent 64, scaled by (inplane/64)² and the wider of depth
    and latent, at least 2 h and at most 48 h."""
    if args.train_timeout_s > 0:
        return args.train_timeout_s
    per_step = (4.0 * (args.inplane / 64.0) ** 2
                * max(1.0, args.depth / 24.0)
                * max(1.0, args.latent / 64.0))
    return min(max(7200, int(steps * per_step)), 48 * 3600)


def apply_reuse_overrides(kept: dict, args) -> list:
    """--reuse provenance: the flags that the kept experiment's
    ``settings.yaml`` records (the training configuration) override this
    call's values. Returns the overrides applied, as ``flag=value``."""
    overrides = []
    for flag, key, cast in (
            ("dataset_shape", "dataset", str),
            ("downsample_steps", "downsample_steps", int),
            ("inplane", "width", int),
            ("latent_width", "latent_width", int),
            ("ex_loss_weight", "ex_loss_weight1", float),
            ("lr_schedule", "use_lr_scheduler", bool),
            ("lr_warmup_steps", "lr_warmup_steps", int),
            ("depth", "depth", int),
            ("latent", "latent", int),
            ("batch_size", "batch_size", int),
            ("ema_decay", "ema_decay", float),
            ("train_latent_interp", "train_latent_interp", str),
            ("compute_dtype", "compute_dtype", str),
            ("aug_noise", "aug_noise", bool),
            ("aug_blur", "aug_blur", bool),
            ("max_grad_norm", "max_grad_norm", float),
            ("model", "model", str)):
        if kept.get(key) is None:
            continue
        val = cast(kept[key])
        if val != getattr(args, flag):
            overrides.append(f"{flag}={val}")
            setattr(args, flag, val)
    # the loss mode is two settings keys, and use_batchnorm changes the
    # parameter tree: a resumed (--extend) child must inherit both
    mix = kept.get("image_mix_loss_func")
    if mix is not None:
        mode = (mix if mix in ("perceptual", "perceptual_enc")
                else "mse+ssim" if kept.get("use_ssim_loss") else "mse")
        if mode != args.loss_mode:
            overrides.append(f"loss_mode={mode}")
            args.loss_mode = mode
    if kept.get("use_batchnorm") is not None:
        bn = int(bool(kept["use_batchnorm"]))
        if bn != args.use_batchnorm:
            overrides.append(f"use_batchnorm={bn}")
            args.use_batchnorm = bn
    return overrides


def select_score_checkpoint(score: str, ema_decay: float,
                            have_ema: bool, sweep_nbr):
    """--score → the checkpoint to score: 'auto' takes the EMA weights
    when the experiment trained with EMA (decay > 0) and ``ema.models``
    exists, 'sweep' the sweep's epoch, 'ema' the EMA weights or an
    error."""
    if score == "ema":
        if not have_ema:
            raise SystemExit("--score ema: no models/ema.models in the "
                             "experiment (train with --ema_decay)")
        return "ema"
    if score == "auto" and ema_decay > 0 and have_ema:
        return "ema"
    return sweep_nbr


def make_extra_test_volumes(ds: int, n: int, inplane: int,
                            num_slices: int, anatomy: str = "rotate",
                            noise_sigma: float = 0.0):
    """N extra held-out Volumes (LR image + HR ground truth) at seeds
    50_000 + i, disjoint from the tree's 10_000 + i, with the dataset
    loader's preprocessing (thick-slice PSF, (0, 100) rescale)."""
    from ..data.synthetic import add_rician_noise
    from ..data.volume import (Volume, rescale_intensities,
                               simulate_thick_slices)

    vols = []
    for i in range(n):
        hr = _brain_phantom(inplane, num_slices, 50_000 + i, anatomy)
        hr = add_rician_noise(hr, noise_sigma, seed=60_000 + i)
        lr = simulate_thick_slices(hr, float(ds))
        vols.append(Volume(
            image=rescale_intensities(lr, percs=(0, 100)),
            spacing=np.array([1.0, 1.0, 1.0]),
            patient_id=f"EXTRA_{i:04d}",
            image_hr=rescale_intensities(hr, percs=(0, 100))))
    return vols


def make_extra_test_volumes_acdc(n: int, inplane: int, num_slices: int,
                                 num_frames: int,
                                 noise_sigma: float = 0.0):
    """The cardiac ``make_extra_test_volumes``: N fresh cine phantoms
    (seeds 50_000 + i) as per-frame Volumes with ``load_acdc_volumes``'
    preprocessing (the identity in-plane resample with its blur, 1-99
    percentile rescale)."""
    from ..data.synthetic import make_cardiac4d_volume
    from ..data.volume import Volume, apply_2d_zoom_4d, rescale_intensities

    sp = np.array([1.4, 1.4], np.float64)
    vols = []
    for i in range(n):
        arr = make_cardiac4d_volume(size=inplane, num_slices=num_slices,
                                    num_frames=num_frames,
                                    seed=50_000 + i,
                                    noise_sigma=noise_sigma) * 400.0
        arr = apply_2d_zoom_4d(arr, sp, sp)
        for t in range(arr.shape[0]):
            vols.append(Volume(
                image=rescale_intensities(arr[t], percs=(1, 99)),
                spacing=np.array([5.0, 1.4, 1.4]),
                patient_id=f"EXTRA_{i:04d}_f{t:02d}",
                frame_id=t, num_frames=num_frames))
    return vols


def build_parser():
    p = argparse.ArgumentParser(
        prog="real-pipeline-quality",
        description="model vs conventional interpolation through the "
                    "production pipeline on fabricated trees")
    p.add_argument("--epochs", type=int, default=300)
    p.add_argument("--sweep_last", type=int, default=30,
                   help="numbered checkpoints kept for the epoch sweep")
    p.add_argument("--dataset_shape", type=str, default="OASIS",
                   choices=["OASIS", "ACDC", "dHCP"],
                   help="'OASIS' = brain thick-slice (LR files, "
                        "train-brain, per-sample alphas), 'ACDC' = cardiac "
                        "4D cine (train-cardiac, fixed alpha 0.5, ds=2), "
                        "'dHCP' = neonatal brain (ds=4, flat layout + "
                        "split file)")
    p.add_argument("--num_frames", type=int, default=6,
                   help="cine frames per fabricated 4D patient (ACDC "
                        "shape only)")
    p.add_argument("--downsample_steps", type=int, default=None,
                   help="default 3 for OASIS, 4 for dHCP; ACDC is fixed "
                        "at 2")
    p.add_argument("--inplane", type=int, default=64)
    p.add_argument("--num_slices", type=int, default=37)
    p.add_argument("--n_patients", type=int, default=24)
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--lr", type=float, default=0.002)
    p.add_argument("--depth", type=int, default=24)
    p.add_argument("--latent", type=int, default=64,
                   help="latent channels")
    p.add_argument("--latent_width", type=int, default=0,
                   help="latent spatial size (0 = inplane // 4)")
    p.add_argument("--n_res_block", type=int, default=None,
                   help="residual blocks at the latent bottleneck")
    p.add_argument("--model", type=str, default="ae_combined",
                   choices=["ae_combined", "ae", "acai_combined", "acai",
                            "vae", "vae_combined",
                            "alpha_combined", "alpha_end_to_end"],
                   help="trainer family")
    p.add_argument("--loss_mode", type=str, default="perceptual",
                   choices=LOSS_MODES)
    p.add_argument("--anatomy", type=str, default="rotate",
                   choices=["rotate", "anatomy3d"],
                   help="fabricated-volume family: 'rotate' = textured "
                        "rotating base, 'anatomy3d' = drifting 3-D "
                        "ellipsoid anatomy")
    p.add_argument("--phantom_noise", type=float, default=0.0,
                   help="Rician noise sigma of the fabricated phantoms "
                        "(on the HR acquisition, before the thick-slice "
                        "PSF); 0.03 = the calibrated setting")
    p.add_argument("--checkpoint", type=str, default=None,
                   help="with --reuse: score THIS checkpoint (epoch "
                        "number / 'caisr' / 'ema') and skip the sweep")
    p.add_argument("--score_noise", type=float, default=None,
                   help="with --reuse (no --extend): score the kept model "
                        "against a fresh fabrication at this Rician "
                        "sigma (same anatomy seeds)")
    p.add_argument("--aug_noise", action="store_true",
                   help="pass --aug_noise to the training command")
    p.add_argument("--aug_blur", action="store_true",
                   help="pass --aug_blur to the training command")
    p.add_argument("--max_grad_norm", type=float, default=0.0,
                   help="global-norm gradient clipping in the training "
                        "command (0 = off)")
    p.add_argument("--compute_dtype", type=str, default="float32",
                   choices=("float32", "bfloat16"),
                   help="training compute dtype of the training command")
    p.add_argument("--use_batchnorm", type=int, default=None,
                   choices=[0, 1],
                   help="override the architecture's BN default")
    p.add_argument("--ex_loss_weight", type=float, default=0.001,
                   help="synthesis-loss mix weight")
    p.add_argument("--latent_interp", type=str, default="linear",
                   choices=["linear", "cubic", "lanczos3", "fitted"],
                   help="latent z-interpolation of the model's scoring "
                        "pass; 'fitted' fits the tap table on the val "
                        "split (fit-latent-taps: before the sweep, and "
                        "again on the selected checkpoint)")
    p.add_argument("--train_latent_interp", type=str, default="linear",
                   choices=["linear", "cubic", "lanczos3"],
                   help="latent z-mixing of the training synthesis loss")
    p.add_argument("--tta", type=str, default=None,
                   choices=["flips", "dihedral"],
                   help="test-time augmentation of the model's scoring "
                        "pass")
    p.add_argument("--lr_schedule", action="store_true",
                   help="cosine-anneal the LR over the whole run "
                        "(--use_lr_scheduler, lr_iter_max = epochs x an "
                        "upper bound of the steps an epoch)")
    p.add_argument("--lr_warmup_steps", type=int, default=0,
                   help="linear LR warmup steps of the training command")
    p.add_argument("--ema_decay", type=float, default=0.0,
                   help="train with EMA weights and score ema.models "
                        "(0 = off)")
    p.add_argument("--score", type=str, default="auto",
                   choices=("auto", "sweep", "ema"),
                   help="which checkpoint to score: 'auto' = the EMA "
                        "weights when trained with --ema_decay, else the "
                        "sweep's epoch")
    p.add_argument("--step_timeout_s", type=float, default=300,
                   help="per-step watchdog of the training command: the "
                        "child exits 75 on a stall and is restarted with "
                        "--auto_resume, up to 10 times; 0 disarms")
    p.add_argument("--train_timeout_s", type=float, default=0,
                   help="wall-clock budget of the training command "
                        "(0 = auto, compute_train_budget)")
    p.add_argument("--extra_test_volumes", type=int, default=0,
                   help="also score N freshly fabricated held-out "
                        "volumes (seeds disjoint from the tree)")
    p.add_argument("--json_out", type=str, default=None)
    p.add_argument("--keep", action="store_true")
    p.add_argument("--reuse", type=str, default=None,
                   help="a work dir kept by --keep (data/ + exper/rpq): "
                        "skip fabrication and training, sweep and score "
                        "only")
    p.add_argument("--extend", action="store_true",
                   help="with --reuse: continue training the kept "
                        "experiment to --epochs, then sweep and score")
    p.add_argument("--device", type=str, default="cuda",
                   help="device of the children and of the scoring "
                        "('cpu' only when asked)")
    return p


def _steps_per_epoch_bound(args, cardiac: bool) -> int:
    """An upper bound of the training steps an epoch: every patient's
    slices (× frames for the cardiac index) in batches."""
    return max(1, (args.n_patients * args.num_slices
                   * (args.num_frames if cardiac else 1))
               // args.batch_size)


def train_command(args, ds: int, cardiac: bool, exper_root: str) -> list:
    """The training child's command line (the JAX tool's flags after the
    port's entry point)."""
    return [
        *cli_command("train-cardiac" if cardiac else "train-brain",
                     args.device),
        "-d", args.dataset_shape,
        "-m", args.model, "--downsample_steps", str(ds),
        "--width", str(args.inplane), "--latent_width",
        str(args.latent_width or args.inplane // 4),
        "--latent", str(args.latent),
        "--depth", str(args.depth),
        "--aug_patch_size", str(args.inplane),
        "-b", str(args.batch_size), "--lr", str(args.lr),
        "-e", str(args.epochs),
        "--epoch_threshold", str(args.epochs - args.sweep_last),
        "--ex_loss_weight1", str(args.ex_loss_weight),
        "--volume_preview_interval", "0", "--seed", "7",
        *loss_mode_flags(args.loss_mode),
        *(["--use_batchnorm", str(args.use_batchnorm)]
          if args.use_batchnorm is not None else []),
        *(["--ema_decay", str(args.ema_decay)]
          if args.ema_decay > 0 else []),
        *(["--lr_warmup_steps", str(args.lr_warmup_steps)]
          if args.lr_warmup_steps > 0 else []),
        *(["--n_res_block", str(args.n_res_block)]
          if args.n_res_block is not None else []),
        *(["--train_latent_interp", args.train_latent_interp]
          if args.train_latent_interp != "linear" else []),
        *(["--compute_dtype", args.compute_dtype]
          if args.compute_dtype != "float32" else []),
        *(["--aug_noise"] if args.aug_noise else []),
        *(["--aug_blur"] if args.aug_blur else []),
        *(["--max_grad_norm", str(args.max_grad_norm)]
          if args.max_grad_norm else []),
        *(["--step_timeout_s", str(args.step_timeout_s), "--auto_resume"]
          if args.step_timeout_s > 0 else []),
        *(["--use_lr_scheduler", "--lr_iter_max",
           str(args.epochs * _steps_per_epoch_bound(args, cardiac))]
          if args.lr_schedule else []),
        "-o", exper_root, "-id", "rpq",
    ]


def _fabricate(args, root: str, ds: int, cardiac: bool,
               sigma: float) -> None:
    if cardiac:
        make_textured_acdc_tree(root, args.n_patients, args.inplane,
                                args.num_slices, args.num_frames,
                                noise_sigma=sigma)
    elif args.dataset_shape == "dHCP":
        make_textured_dhcp_tree(root, ds, args.n_patients, args.inplane,
                                args.num_slices, anatomy=args.anatomy,
                                noise_sigma=sigma)
    else:
        make_textured_oasis_tree(root, ds, args.n_patients, args.inplane,
                                 args.num_slices, anatomy=args.anatomy,
                                 noise_sigma=sigma)


def score_methods(trainer, volumes, ds: int, tta, latent_interp,
                  device) -> dict:
    """``create_hr_images`` aggregates of the model and of the
    conventional methods on ``volumes``."""
    from ..evaluate import create_hr_images

    rows = {"model (AESR)": create_hr_images(
        trainer, volumes, downsample_steps=ds, tta=tta,
        latent_interp=latent_interp)["aggregate"]}
    for method in CONVENTIONAL:
        rows[method] = create_hr_images(
            None, volumes, downsample_steps=ds, interpol_method=method,
            device=device)["aggregate"]
    return rows


def _print_rows(rows: dict, hdr: str) -> None:
    # the all-slice columns include the original-grid slices (the model
    # reconstructs them through the AE, conventional methods copy them):
    # a large synth-vs-all gap of the model points at synthesis, a small
    # one at the AE's reconstruction
    print(hdr)
    print("-" * len(hdr))
    for name, agg in rows.items():
        print(f"{name:>14} | {agg['ssim_synth'][0]:12.4f} | "
              f"{agg['psnr_synth'][0]:12.3f} | "
              f"{agg['vif_synth'][0]:12.4f} | "
              f"{agg['ssim'][0]:9.4f} | {agg['psnr'][0]:9.3f}")


def _wins(rows: dict, suffix: str = "") -> dict:
    """metric → (model, best conventional), printed as the verdict."""
    model = rows["model (AESR)"]
    wins = {}
    for metric in SCORED:
        best_conv = max(rows[m][metric][0] for m in CONVENTIONAL)
        wins[metric] = (float(model[metric][0]), float(best_conv))
        tag = ("BEATS" if wins[metric][0] > wins[metric][1]
               else "does not beat")
        print(f"{metric}: model {tag} best conventional "
              f"({wins[metric][0]:.4f} vs {wins[metric][1]:.4f}){suffix}")
    return wins


def main(argv=None):
    args = build_parser().parse_args(argv)

    if args.extend and not args.reuse:
        raise SystemExit("--extend requires --reuse (it continues a "
                         "kept experiment's training)")
    if args.score_noise is not None and (not args.reuse or args.extend):
        raise SystemExit("--score_noise requires --reuse without "
                         "--extend (it re-scores a kept model, never "
                         "retrains)")
    if args.checkpoint is not None and not args.reuse:
        # a pinned checkpoint names an epoch of a kept experiment: fail
        # before any fabrication or training child, not after them
        raise SystemExit("--checkpoint requires --reuse")
    if args.downsample_steps is None:
        args.downsample_steps = {"ACDC": 2, "dHCP": 4}.get(
            args.dataset_shape, 3)
    # the parent touches no device until the training child has exited
    # (fabrication is numpy, the scoring comes after it); a misspelt
    # device fails here all the same
    import torch
    torch.device(args.device)

    if args.reuse:
        work = os.path.expanduser(args.reuse)
        data_root = os.path.join(work, "data")
        exper_root = os.path.join(work, "exper")
        if not os.path.isdir(os.path.join(exper_root, "rpq", "models")):
            raise SystemExit(f"--reuse {work}: no exper/rpq/models — not "
                             f"a kept real_pipeline_quality work dir")
        args.keep = True  # never delete a user-provided tree
        # the kept settings.yaml records the training configuration;
        # downsample_steps must match the fabricated '*_{ds}mm' tree
        spath = os.path.join(exper_root, "rpq", "settings.yaml")
        if os.path.exists(spath):
            from ..config.settings import parse_settings

            with open(spath) as f:
                kept = parse_settings(f.read(), spath)
            overrides = apply_reuse_overrides(kept, args)
            if overrides:
                print("[reuse] from kept settings.yaml: "
                      + " ".join(overrides), flush=True)
        # the fabrication's provenance is a property of the data, which
        # settings.yaml cannot know
        fab_path = os.path.join(work, "fabrication.json")
        if os.path.exists(fab_path):
            with open(fab_path) as f:
                fab = json.load(f)
            fab_overrides = []
            for key in ("dataset_shape", "anatomy", "n_patients",
                        "num_slices", "inplane", "num_frames",
                        "phantom_noise"):
                if key in fab and fab[key] != getattr(args, key):
                    fab_overrides.append(f"{key}={fab[key]}")
                    setattr(args, key, fab[key])
            if fab_overrides:
                print("[reuse] from kept fabrication.json: "
                      + " ".join(fab_overrides), flush=True)
    ds = args.downsample_steps  # after the settings.yaml overrides
    cardiac = args.dataset_shape == "ACDC"
    if cardiac and ds != 2:
        raise SystemExit("--dataset_shape ACDC requires "
                         f"--downsample_steps 2, got {ds} (the cardiac "
                         "pipeline trains/evaluates at gap 2)")
    if args.n_patients < 7:
        # every tree reserves 3 test + 2 val patients
        raise SystemExit(f"--dataset_shape {args.dataset_shape} needs "
                         ">= 7 patients (split reserves 3 test + 2 "
                         f"val), got {args.n_patients}")
    if not args.reuse:
        work = tempfile.mkdtemp(prefix="sr_rpq_")
        data_root = os.path.join(work, "data")
        exper_root = os.path.join(work, "exper")
    try:
        if args.reuse:
            print(f"[reuse] kept work dir {work} — skipping fabrication"
                  + ("" if args.extend else "/training"), flush=True)
        else:
            if cardiac:
                print(f"[fabricate] {args.n_patients} cardiac 4D cine "
                      f"phantoms ({args.num_frames}x{args.num_slices}x"
                      f"{args.inplane}^2) under {data_root}", flush=True)
            elif args.dataset_shape == "dHCP":
                print(f"[fabricate] {args.n_patients} {args.anatomy} dHCP "
                      f"volumes ({args.num_slices}x{args.inplane}^2, "
                      f"{ds / 2:.1f}mm LR) under {data_root}", flush=True)
            else:
                print(f"[fabricate] {args.n_patients} {args.anatomy} "
                      f"volumes ({args.num_slices}x{args.inplane}^2, "
                      f"{ds}mm LR) under {data_root}", flush=True)
            _fabricate(args, data_root, ds, cardiac, args.phantom_noise)
            with open(os.path.join(work, "fabrication.json"), "w") as f:
                json.dump({k: getattr(args, k)
                           for k in ("dataset_shape", "anatomy",
                                     "n_patients", "num_slices",
                                     "inplane", "num_frames",
                                     "phantom_noise")}, f)

        score_root = data_root
        score_sigma = args.phantom_noise
        if args.score_noise is not None:
            score_sigma = float(args.score_noise)
            score_root = os.path.join(
                work, f"scoredata_{score_sigma:g}", "data")
            if not os.path.isdir(score_root):
                print(f"[score-noise] fabricating evaluation tree at "
                      f"sigma={score_sigma:g} (same anatomy seeds) "
                      f"under {score_root}", flush=True)
                _fabricate(args, score_root, ds, cardiac, score_sigma)

        train_cmd = train_command(args, ds, cardiac, exper_root)
        if args.extend and "--auto_resume" not in train_cmd:
            # an extension continues from the kept rolling checkpoint
            train_cmd += ["--auto_resume"]
        if not args.reuse or args.extend:
            print("[train] " + " ".join(train_cmd), flush=True)
            steps = args.epochs * _steps_per_epoch_bound(args, cardiac)
            _run(train_cmd, data_root, "train",
                 log_path=os.path.join(work, "train.log"),
                 timeout=compute_train_budget(args, steps),
                 stall_restarts=10 if args.step_timeout_s > 0 else 0)
        exper = os.path.join(exper_root, "rpq")

        def _fit_taps(model_nbr, what):
            _run([*cli_command("fit-latent-taps", args.device),
                  "--exper_dir", exper, "--downsample_steps", str(ds),
                  "--model_nbr", str(model_nbr)],
                 data_root, what,
                 log_path=os.path.join(work, f"{what}.log"))

        if args.latent_interp == "fitted":
            # the sweep selects under the fitted scheme: fit on the
            # min-val-loss alias first, refit on the selected epoch
            _fit_taps("caisr", "fit_taps")

        if args.checkpoint is not None:
            if not args.reuse:
                raise SystemExit("--checkpoint requires --reuse")
            best_nbr = (int(args.checkpoint) if args.checkpoint.isdigit()
                        else args.checkpoint)
            print(f"[score] using pinned checkpoint: {best_nbr}",
                  flush=True)
        else:
            r = _run([*cli_command("find-best-model", args.device),
                      "--exper_dir", exper, "--downsample_steps", str(ds),
                      "--batched",
                      # select under the z-mixing the scoring serves with
                      *(["--latent_interp", args.latent_interp]
                        if args.latent_interp != "linear" else [])],
                     data_root, "find_best",
                     log_path=os.path.join(work, "find_best.log"))
            best_lines = [l for l in r.stdout.splitlines()
                          if "best per metric" in l or "ssim" in l.lower()]
            print("\n".join(best_lines[-6:]), flush=True)
            # the epoch the validation sweep picked by synthesized-slice
            # SSIM, else the min-val-loss 'caisr' alias
            m = re.search(r"ssim_synth: epoch (\d+)", r.stdout)
            best_nbr = int(m.group(1)) if m else "caisr"
            have_ema = os.path.isfile(
                os.path.join(exper, "models", "ema.models"))
            best_nbr = select_score_checkpoint(args.score, args.ema_decay,
                                               have_ema, best_nbr)
            kind = "EMA" if best_nbr == "ema" else "sweep-selected"
            print(f"[score] using {kind} checkpoint: {best_nbr}",
                  flush=True)

        score_latent_interp = args.latent_interp
        if args.latent_interp == "fitted":
            _fit_taps(best_nbr, "fit_taps_refit")
            from ..infer import resolve_latent_interp

            score_latent_interp = resolve_latent_interp("fitted", exper)

        # ------------------------------------------------------------------
        # held-out test scoring, in this process, on --device
        # ------------------------------------------------------------------
        from ..data.datasets import load_acdc_volumes, load_brain_volumes
        from ..device import resolve_device
        from ..train import get_trainer

        dev = resolve_device(args.device)
        os.environ["SR_DATA_ROOT"] = score_root
        if cardiac:
            # one 3-D Volume per (patient, frame)
            test_vols = load_acdc_volumes("test")
        else:
            test_vols = load_brain_volumes(args.dataset_shape, ds,
                                           split="test",
                                           include_hr_images=True)
        assert test_vols, "empty test split"
        print(f"[score] {len(test_vols)} held-out test volumes", flush=True)

        trainer = get_trainer(exper, model_nbr=best_nbr, eval_mode=True,
                              device=dev)
        rows = score_methods(trainer, test_vols, ds, args.tta,
                             score_latent_interp, dev)

        loss_mode = args.loss_mode
        if args.reuse:
            # describe the kept experiment, not this call's defaults
            ta = trainer.args
            if ta.get("image_mix_loss_func") == "perceptual":
                loss_mode = ("perceptual+lap" if ta.get("use_laploss")
                             else "perceptual")
            elif ta.get("image_mix_loss_func") == "perceptual_enc":
                loss_mode = "perceptual_enc"
            else:
                loss_mode = ("mse+ssim" if ta.get("use_ssim_loss")
                             else "mse")

        hdr = (f"{'method':>14} | {'SSIM synth':>12} | "
               f"{'PSNR synth':>12} | {'VIF synth':>12} | "
               f"{'SSIM all':>9} | {'PSNR all':>9}")
        print(f"\n=== production-pipeline {args.dataset_shape}-shaped "
              f"quality (ds={ds}, loss={loss_mode}) ===")
        _print_rows(rows, hdr)
        model = rows["model (AESR)"]
        wins = _wins(rows)
        all_beat = all(m > c for m, c in wins.values())
        print(f"\nmodel {'BEATS' if all_beat else 'does not beat'} "
              f"conventional interpolation on ALL metrics "
              f"(full production pipeline)")

        wins_extra = None
        all_beat_extra = None
        if args.extra_test_volumes > 0:
            if cardiac:
                extra = make_extra_test_volumes_acdc(
                    args.extra_test_volumes, args.inplane,
                    args.num_slices, args.num_frames,
                    noise_sigma=score_sigma)
            else:
                extra = make_extra_test_volumes(
                    ds, args.extra_test_volumes, args.inplane,
                    args.num_slices, anatomy=args.anatomy,
                    noise_sigma=score_sigma)
            print(f"\n=== extra held-out set: {len(extra)} fresh "
                  f"volumes (disjoint seeds) ===")
            rows_x = score_methods(trainer, extra, ds, args.tta,
                                   score_latent_interp, dev)
            _print_rows(rows_x, hdr)
            wins_extra = _wins(rows_x, "  [extra set]")
            all_beat_extra = all(m > c for m, c in wins_extra.values())
            print(f"model {'BEATS' if all_beat_extra else 'does not beat'}"
                  f" conventional on ALL metrics (extra held-out set)")

        rec = {
            "tool": "real_pipeline_quality",
            "dataset_shape": args.dataset_shape,
            "anatomy": "cardiac4d" if cardiac else args.anatomy,
            "num_frames": args.num_frames if cardiac else None,
            "phantom_noise": args.phantom_noise,
            "score_noise": score_sigma,
            "compute_dtype": trainer.args.get("compute_dtype",
                                              "float32"),
            "loss_mode": loss_mode,
            "model_family": args.model,
            "lpips_mode": trainer.args.get("lpips_mode"),
            # with --reuse the settings' value describes the kept run
            "epochs": int(trainer.args.get("epochs") or args.epochs),
            "checkpoint": str(best_nbr),
            # int 0/1: the settings hold a bool or an int
            "use_batchnorm": (
                None if trainer.args.get("use_batchnorm") is None
                else int(bool(trainer.args.get("use_batchnorm")))),
            "lr_schedule": bool(args.lr_schedule),
            "aug_noise": bool(trainer.args.get("aug_noise")),
            "aug_blur": bool(trainer.args.get("aug_blur")),
            "max_grad_norm": float(
                trainer.args.get("max_grad_norm", 0) or 0),
            "lr_warmup_steps": int(trainer.args.get(
                "lr_warmup_steps", 0) or 0),
            "n_res_block": trainer.args.get("n_res_block"),
            "tta": args.tta,
            "latent_interp": args.latent_interp,
            "train_latent_interp": trainer.args.get(
                "train_latent_interp", "linear"),
            "ema_decay": args.ema_decay,
            "ex_loss_weight": args.ex_loss_weight,
            "downsample_steps": ds,
            "latent": int(args.latent), "depth": int(args.depth),
            "latent_width": int(args.latent_width
                                or args.inplane // 4),
            "inplane": args.inplane, "num_slices": args.num_slices,
            "n_patients": args.n_patients,
            "model": {k: round(mv, 5)
                      for k, (mv, _) in wins.items()},
            "model_all_slices": {
                k: round(float(model[k][0]), 5)
                for k in ("ssim", "psnr", "vif")},
            "best_conventional": {k: round(cv, 5)
                                  for k, (_, cv) in wins.items()},
            "beats_all": bool(all_beat),
        }
        if wins_extra is not None:
            rec["n_extra_test"] = int(args.extra_test_volumes)
            rec["model_extra"] = {k: round(mv, 5)
                                  for k, (mv, _) in wins_extra.items()}
            rec["best_conventional_extra"] = {
                k: round(cv, 5) for k, (_, cv) in wins_extra.items()}
            rec["beats_all_extra"] = bool(all_beat_extra)
        if args.json_out:
            with open(args.json_out, "a") as f:
                f.write(json.dumps(rec) + "\n")
            print(f"appended result to {args.json_out}")
        return rec
    finally:
        if args.keep:
            print(f"artifacts kept in {work}")
        else:
            # on failure keep the children's logs (the tracebacks that
            # the SystemExit message truncates) before deleting the tree
            if sys.exc_info()[0] is not None:
                rescue = tempfile.mkdtemp(prefix="sr_rpq_logs_")
                for f in glob.glob(os.path.join(work, "*.log")):
                    shutil.copy2(f, rescue)
                print(f"FAILED — child logs preserved in {rescue}",
                      file=sys.stderr)
            shutil.rmtree(work, ignore_errors=True)
