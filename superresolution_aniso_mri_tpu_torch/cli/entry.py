"""The experiment-directory commands: train, generate, serve, find-best,
fit-latent-taps, and the reference-checkpoint converters.

Port of ``superresolution_aniso_mri_tpu/cli/entry.py``, with the same
flags, prints and return values, reading and writing the same
experiment directory (``settings.yaml``, ``models/*.models``, the loss
archives, ``log_images/``, ``model_perf_ds<k>.npz``) and the same
``<base>_niNN.nii.gz`` outputs. Run them as

    python -m superresolution_aniso_mri_tpu_torch.cli <command> [flags]

(``cli/__main__.py``). Training runs on ``--device`` (``cuda`` unless it
says ``cpu``); the other commands' functions take ``device`` (None: the
CUDA device). Without a card, and unless the CPU is asked for, every
command raises ``device.resolve_device``'s error. ``fit_latent_taps``
fits the learned latent tap table, and ``convert_reference_checkpoint``
/ ``export_reference_checkpoint`` read and write the reference's torch
checkpoints (the JAX package's ``tools/`` scripts of those names).
"""
from __future__ import annotations

import argparse
import glob
import os

import numpy as np

from ..device import resolve_device

BRAIN_DATASETS = ("brainMASI", "dHCP", "OASIS", "ADNI", "MNIST3D",
                  "MNISTRoto")
CARDIAC_DATASETS = ("ACDC", "ACDCC", "ACDCLBL", "ARVC")
_LATENT_INTERPS = ["linear", "cubic", "lanczos3", "fitted"]


def train_cardiac(argv=None):
    """Reference: train_cardiac_aesr.py:153-214."""
    from ..config.arguments import parse_args
    from .train_loop import run_training

    args, args_dict = parse_args(argv)
    if args.dataset not in CARDIAC_DATASETS:
        raise SystemExit(f"train_cardiac: cardiac datasets only, "
                         f"got {args.dataset}")
    np.random.seed(args.seed)
    return run_training(args_dict)


def train_brain(argv=None):
    """Reference: train_brain_aesr.py:137-192."""
    from ..config.arguments import parse_args
    from .train_loop import run_training

    args, args_dict = parse_args(argv)
    if args.dataset not in BRAIN_DATASETS:
        raise SystemExit(f"train_brain: brain/toy datasets only, "
                         f"got {args.dataset}")
    np.random.seed(args.seed)
    return run_training(args_dict)


_IMAGE_EXTS = (".nii.gz", ".nii", ".mha", ".mhd")


def _split_image_ext(path: str):
    base = os.path.basename(path)
    for ext in _IMAGE_EXTS:
        if base.endswith(ext):
            return base[: -len(ext)], ext
    return base, ""


def _load_image_paths(data_input_dir: str, label_suffix: str = "",
                      strict_labels: bool = False):
    files = []
    for pat in ("*.nii", "*.nii.gz", "*.mha", "*.mhd"):
        files.extend(glob.glob(os.path.join(data_input_dir, pat)))
    files = sorted(set(files))
    if label_suffix:
        # a '<stem><suffix>' file is a label companion — an input to its
        # image volume, not a volume to densify — but ONLY when that
        # image sibling exists; ``strict_labels`` (the polling daemon)
        # excludes suffix matches even WITHOUT a sibling: a label that
        # lands before its image must not be densified as an image
        stems = {_split_image_ext(f)[0] for f in files}

        def _is_label(f):
            stem = _split_image_ext(f)[0]
            return stem.endswith(label_suffix) and (
                strict_labels or stem[:-len(label_suffix)] in stems)

        files = [f for f in files if not _is_label(f)]
    if not files:
        raise SystemExit(f"no volumes found in {data_input_dir}")
    return files


def _find_label_companion(path: str, label_suffix: str):
    """'<stem><suffix>.<ext>' sibling of an image volume, trying every
    supported extension (the label file need not share the image's)."""
    stem, _ = _split_image_ext(path)
    for ext in _IMAGE_EXTS:
        cand = os.path.join(os.path.dirname(path),
                            f"{stem}{label_suffix}{ext}")
        if os.path.isfile(cand):
            return cand
    return None


def _model_nbr(text: str):
    return int(text) if text.isdigit() else text


def generate_hr_volumes(argv=None, device=None):
    """Reference: generate_hr_volumes.py:159-209 — synthesize
    num_interpolations slices between every adjacent pair (originals
    kept verbatim), z-spacing divided by (n+1)."""
    from ..infer import resolve_latent_interp
    from ..train import get_trainer

    parser = argparse.ArgumentParser(
        description="Synthesize in-between slices for anisotropic volumes")
    parser.add_argument("--exper_dir", type=str, required=True,
                        help="experiment directory (settings.yaml + models/)")
    parser.add_argument("--model_nbr", type=str, default="caisr",
                        help="epoch number or 'ae'/'caisr'")
    parser.add_argument("--data_input_dir", type=str, required=True)
    parser.add_argument("--output_dir", type=str, required=True)
    parser.add_argument("--num_interpolations", type=int, default=1)
    parser.add_argument("--num_devices", type=int, default=1,
                        help="shard the slice axis over the first N "
                             "devices (multi-chip volume inference)")
    parser.add_argument("--label_suffix", type=str, default="_gt",
                        help="sibling '<name><suffix>.nii.gz' files are "
                             "loaded as segmentation labels and ride "
                             "through synthesis; '' disables")
    parser.add_argument("--tta", type=str, default=None,
                        choices=["flips", "dihedral"],
                        help="test-time augmentation: average synthesis "
                             "over 4 ('flips') or 8 ('dihedral') in-plane "
                             "symmetries")
    parser.add_argument("--readback_dtype", type=str, default="float32",
                        choices=["float32", "bfloat16"],
                        help="device->host transfer precision for the "
                             "synthesized volume; files are still "
                             "written float32")
    parser.add_argument("--latent_interp", type=str, default="linear",
                        choices=_LATENT_INTERPS,
                        help="latent z-interpolation: 'linear' = the "
                             "reference's 2-tap lerp; 'cubic' = 4-tap "
                             "Catmull-Rom; 'lanczos3' = 6-tap; 'fitted' = "
                             "the experiment's learned tap table")
    args = parser.parse_args(argv)
    dev = resolve_device(device)

    exper_dir = os.path.expanduser(args.exper_dir)
    trainer = get_trainer(exper_dir, model_nbr=_model_nbr(args.model_nbr),
                          eval_mode=True, device=dev)
    latent_interp = resolve_latent_interp(args.latent_interp, exper_dir)
    os.makedirs(args.output_dir, exist_ok=True)

    for path in _load_image_paths(os.path.expanduser(args.data_input_dir),
                                  args.label_suffix):
        _densify_file(trainer, path, args.output_dir,
                      args.num_interpolations, args.label_suffix,
                      args.num_devices, tta=args.tta,
                      latent_interp=latent_interp,
                      readback_dtype=args.readback_dtype)


def _densify_file(trainer, path: str, output_dir: str, n: int,
                  label_suffix: str, num_devices: int = 1,
                  tta: str | None = None, latent_interp: str = "linear",
                  readback_dtype: str | None = None):
    """Densify one on-disk volume: read (+ label companion), synthesize
    ``n`` in-between slices per gap, write '<base>_niNN.nii.gz' (and the
    label output when input labels existed). Returns the written paths.
    Shared by the batch command and the serving daemon."""
    from ..data.volume import rescale_intensities
    from ..infer import create_super_volumes
    from ..utils import read_image, write_image

    arr, spacing, affine = read_image(path)
    arr = arr.astype(np.float32)
    # sibling label volume ('<name>_gt.nii.gz'): rides through synthesis,
    # decoded by a MultiChannelAE (ACDCLBL), a nearest-slice ride-along
    # otherwise
    lbl_arr = None
    if label_suffix:
        lbl_path = _find_label_companion(path, label_suffix)
        if lbl_path is not None:
            lbl_arr, _, _ = read_image(lbl_path)
            if lbl_arr.shape != arr.shape:
                print(f"WARNING: ignoring {lbl_path} — shape "
                      f"{lbl_arr.shape} != image {arr.shape}")
                lbl_arr = None
    alpha_range = np.linspace(0, 1, n + 2)[1:-1]
    frames = arr[None] if arr.ndim == 3 else arr
    lbl_frames = (None if lbl_arr is None
                  else (lbl_arr[None] if lbl_arr.ndim == 3 else lbl_arr))
    # percentile-normalize frames outside [0,1]
    # (reference: generate_hr_volumes.py:104-111,130-133)
    frames = [frame if frame.min() >= 0 and frame.max() <= 1
              else rescale_intensities(frame, percs=(1, 99))
              for frame in frames]
    # the frames of a 4D sequence share a shape and synthesize as one
    # batch; 3D inputs are a single-volume call
    res_list = create_super_volumes(
        trainer, frames, alpha_range=alpha_range, use_original=True,
        downsample_steps=None, generate_inbetween_slices=False,
        labels_list=(None if lbl_frames is None else list(lbl_frames)),
        num_devices=num_devices, tta=tta, latent_interp=latent_interp,
        readback_dtype=readback_dtype)
    out_frames = [r["upsampled_image"] for r in res_list]
    out_lbl_frames = [r["upsampled_labels"] for r in res_list]
    out = (out_frames[0] if arr.ndim == 3
           else np.stack(out_frames, axis=0))
    # a label output only when INPUT labels existed: a MultiChannelAE
    # decodes labels from a zero label plane too, and those would be a
    # segmentation nobody provided
    out_lbl = None
    if lbl_arr is not None and all(u is not None
                                   for u in out_lbl_frames):
        out_lbl = (out_lbl_frames[0] if arr.ndim == 3
                   else np.stack(out_lbl_frames, axis=0))
    new_spacing = np.asarray(spacing, np.float64).copy()
    # the densified axis is z = index -3 (a 4D MetaImage's spacing is
    # (t, z, y, x); for 3D (z, y, x) -3 == 0)
    new_spacing[-3] = new_spacing[-3] / (n + 1)
    base, _ = _split_image_ext(path)
    out_path = os.path.join(output_dir, f"{base}_ni{n:02d}.nii.gz")
    # keep the source orientation/translation, but rescale the affine's z
    # column to the densified slice spacing (consumers prefer the sform)
    new_affine = affine
    if affine is not None:
        new_affine = np.asarray(affine, np.float64).copy()
        new_affine[:3, 2] *= new_spacing[-3] / spacing[-3]
    write_image(out_path, out.astype(np.float32), spacing=new_spacing,
                affine=new_affine)
    print(f"saved {out_path}  "
          f"({out.shape[0] if out.ndim == 3 else out.shape[1]} slices, "
          f"z-spacing {new_spacing[-3]:.3f}mm)", flush=True)
    written = [out_path]
    if out_lbl is not None:
        lbl_out_path = os.path.join(
            output_dir, f"{base}_ni{n:02d}{label_suffix}.nii.gz")
        write_image(lbl_out_path,
                    np.rint(out_lbl).astype(np.int16),
                    spacing=new_spacing, affine=new_affine,
                    dtype=np.int16)
        print(f"saved {lbl_out_path}", flush=True)
        written.append(lbl_out_path)
    return written


def _mhd_payload_path(path: str):
    """External ElementDataFile target of a .mhd header (None for .mha /
    LOCAL data): the payload is where the bytes land, so the
    write-in-progress guard must watch it too."""
    if not path.endswith(".mhd"):
        return None
    try:
        with open(path, "rb") as f:
            for _ in range(256):
                line = f.readline()
                if not line:
                    break
                text = line.decode("ascii", errors="replace").strip()
                if text.replace(" ", "").startswith("ElementDataFile="):
                    val = text.split("=", 1)[1].strip()
                    # only plain single-file payload names: LOCAL means
                    # in-header data, LIST / printf patterns name
                    # multi-file series
                    if (val and val.upper() not in ("LOCAL", "LIST")
                            and "%" not in val):
                        return os.path.join(os.path.dirname(path), val)
                    return None
    except OSError:
        return None
    return None


def _file_signature(path: str, label_suffix: str):
    """Change-detection key for a volume: its own (mtime_ns, size) plus
    the label companion's, and for .mhd headers the external payload's
    (a payload not there yet gives a never-stable signature)."""
    import time

    st = os.stat(path)
    sig = [path, st.st_mtime_ns, st.st_size]
    payload = _mhd_payload_path(path)
    if payload is not None:
        try:
            pst = os.stat(payload)
            sig += [payload, pst.st_mtime_ns, pst.st_size]
        except OSError:
            sig += [payload, -1, time.monotonic_ns()]
    if label_suffix:
        comp = _find_label_companion(path, label_suffix)
        if comp is not None and os.path.isfile(comp):
            cst = os.stat(comp)
            sig += [comp, cst.st_mtime_ns, cst.st_size]
    return tuple(sig)


def serve_hr_volumes(argv=None, device=None):
    """Directory-watching serving daemon: densify volumes as they land.

    Keeps the model on the device and picks up new or changed files
    (including late-arriving label companions) on a poll loop. A file is
    processed once its stat is stable across two consecutive polls
    (write-in-progress guard). ``--once`` drains the current directory
    and exits. Returns the number of volumes served."""
    import json
    import signal
    import time

    from ..infer import resolve_latent_interp
    from ..train import get_trainer

    parser = argparse.ArgumentParser(
        description="Serve HR-volume synthesis over a watched directory")
    parser.add_argument("--exper_dir", type=str, required=True)
    parser.add_argument("--model_nbr", type=str, default="caisr")
    parser.add_argument("--watch_dir", type=str, required=True)
    parser.add_argument("--output_dir", type=str, required=True)
    parser.add_argument("--num_interpolations", type=int, default=1)
    parser.add_argument("--num_devices", type=int, default=1)
    parser.add_argument("--label_suffix", type=str, default="_gt")
    parser.add_argument("--poll_seconds", type=float, default=2.0)
    parser.add_argument("--once", action="store_true",
                        help="drain the directory once, then exit")
    parser.add_argument("--max_volumes", type=int, default=0,
                        help="exit after N volumes (0 = run forever)")
    parser.add_argument("--manifest", type=str, default=None,
                        help="append one JSON line per served volume")
    parser.add_argument("--tta", type=str, default=None,
                        choices=["flips", "dihedral"],
                        help="test-time augmentation for every served "
                             "volume (see generate_hr_volumes --tta)")
    parser.add_argument("--latent_interp", type=str, default="linear",
                        choices=_LATENT_INTERPS,
                        help="latent z-interpolation for every served "
                             "volume (see generate_hr_volumes "
                             "--latent_interp)")
    parser.add_argument("--synth_timeout_s", type=float, default=0,
                        help="stall watchdog: exit 75 (EX_TEMPFAIL) if "
                             "one volume's synthesis hangs this long so a "
                             "supervisor can restart the daemon; 0 "
                             "disables")
    args = parser.parse_args(argv)

    watch = os.path.expanduser(args.watch_dir)
    if not os.path.isdir(watch):
        # fail fast: a typo'd watch dir would otherwise spin forever
        raise SystemExit(f"watch_dir does not exist: {watch}")
    if os.path.realpath(watch) == os.path.realpath(
            os.path.expanduser(args.output_dir)):
        # served outputs would be re-ingested next poll
        raise SystemExit("watch_dir and output_dir must differ")
    dev = resolve_device(device)
    trainer = get_trainer(os.path.expanduser(args.exper_dir),
                          model_nbr=_model_nbr(args.model_nbr),
                          eval_mode=True, device=dev)
    latent_interp = resolve_latent_interp(
        args.latent_interp, os.path.expanduser(args.exper_dir))
    os.makedirs(args.output_dir, exist_ok=True)

    stop = {"flag": False}

    def _stop(signum, frame):
        stop["flag"] = True

    for sig in (signal.SIGINT, signal.SIGTERM):
        try:
            signal.signal(sig, _stop)
        except ValueError:
            pass                        # non-main thread (tests)

    processed: dict = {}   # image path → signature already served
    pending: dict = {}     # image path → signature seen last poll
    served = 0
    # armed only while a volume is in flight — idle polling never fires it
    watchdog = None
    if args.synth_timeout_s > 0:
        from ..utils.watchdog import StepWatchdog

        watchdog = StepWatchdog(
            args.synth_timeout_s, label="serve",
            first_timeout_s=max(args.synth_timeout_s, 600.0)).start()
        watchdog.pause()
    print(f"serving {watch} → {args.output_dir} "
          f"(n={args.num_interpolations}, model={args.model_nbr})",
          flush=True)
    while not stop["flag"]:
        try:
            # strict_labels: a label companion that lands BEFORE its
            # image must not be densified as an image meanwhile
            paths = _load_image_paths(watch, args.label_suffix,
                                      strict_labels=True)
        except SystemExit:              # empty directory: keep watching
            paths = []
        for path in paths:
            if stop["flag"]:
                break
            try:
                sig = _file_signature(path, args.label_suffix)
            except OSError:
                continue                # vanished mid-scan
            if processed.get(path) == sig:
                continue
            if not args.once and pending.get(path) != sig:
                pending[path] = sig     # wait one poll for stability
                continue
            t0 = time.perf_counter()
            if watchdog is not None:
                watchdog.resume()
            try:
                written = _densify_file(
                    trainer, path, args.output_dir,
                    args.num_interpolations, args.label_suffix,
                    args.num_devices, tta=args.tta,
                    latent_interp=latent_interp)
            except Exception as exc:    # keep serving on bad volumes
                print(f"ERROR serving {path}: {exc}", flush=True)
                processed[path] = sig   # don't retry-loop a poison file
                continue
            finally:
                if watchdog is not None:
                    watchdog.pause()
            if watchdog is not None:
                # beat on success only: the first completed volume ends
                # the warm-up window
                watchdog.beat()
            dt = time.perf_counter() - t0
            processed[path] = sig
            pending.pop(path, None)
            served += 1
            print(f"served {os.path.basename(path)} in {dt:.2f}s "
                  f"({served} total)", flush=True)
            if args.manifest:
                with open(args.manifest, "a") as f:
                    f.write(json.dumps({
                        "input": path, "outputs": written,
                        "seconds": round(dt, 4),
                        "unix_time": time.time()}) + "\n")
            if args.max_volumes and served >= args.max_volumes:
                stop["flag"] = True
        if args.once:
            break
        if not stop["flag"]:
            time.sleep(args.poll_seconds)
    if watchdog is not None:
        watchdog.stop()
    print(f"serve loop exit after {served} volumes", flush=True)
    return served


def find_best_model(argv=None, device=None):
    """Reference: evaluate/find_best_model.py:184-213."""
    from ..config.settings import load_settings
    from ..data.datasets import get_datasets
    from ..evaluate import find_best_val_model
    from ..infer import resolve_latent_interp

    parser = argparse.ArgumentParser(description="Find best val model")
    parser.add_argument("--exper_dir", type=str, required=True)
    parser.add_argument("--downsample_steps", type=int, default=None)
    parser.add_argument("--limited_load", action="store_true")
    parser.add_argument("--use_synthetic_data", action="store_true")
    parser.add_argument("--batched", action="store_true",
                        help="one batched synthesis and one SSIM launch "
                             "per shape group of validation volumes")
    parser.add_argument("--latent_interp", type=str, default="linear",
                        choices=_LATENT_INTERPS,
                        help="latent z-interpolation for the sweep's "
                             "synthesis — select checkpoints with the "
                             "scheme you will serve with")
    args = parser.parse_args(argv)
    dev = resolve_device(device)

    exper_dir = os.path.expanduser(args.exper_dir)
    settings = load_settings(os.path.join(exper_dir, "settings.yaml"))
    if args.limited_load:
        settings["limited_load"] = True
    if args.use_synthetic_data:
        settings["use_synthetic_data"] = True
    ds = (args.downsample_steps if args.downsample_steps is not None
          else int(settings.get("downsample_steps") or 2))
    if ds < 1:
        raise SystemExit(f"--downsample_steps must be >= 1, got {ds}")
    # the validation volumes are built for the SAME factor the sweep
    # scores (toy slice counts depend on it)
    settings["downsample_steps"] = ds
    _train, val = get_datasets(settings)
    res = find_best_val_model(
        exper_dir, val, ds, batched=args.batched, verbose=True,
        latent_interp=resolve_latent_interp(args.latent_interp, exper_dir),
        device=dev)
    print("best per metric:")
    for metric, info in res["best"].items():
        print(f"  {metric}: epoch {info['epoch']}  value {info['value']:.4f}")
    return res


def fit_latent_taps(argv=None, device=None):
    """Reference: the JAX package's ``cli/entry.py::fit_latent_taps`` —
    fit the learned per-alpha latent tap table on the validation split
    (``infer/latent_taps.py``) and save it next to the checkpoints as
    ``<exper>/models/latent_taps.npz``; serve it with ``--latent_interp
    fitted``. Returns the fit's result dict."""
    from ..config.settings import load_settings
    from ..data.datasets import get_datasets
    from ..infer.latent_taps import fit_latent_taps as _fit
    from ..infer.latent_taps import save_latent_taps
    from ..train import get_trainer

    parser = argparse.ArgumentParser(
        description="Fit learned latent tap weights on the val split")
    parser.add_argument("--exper_dir", type=str, required=True)
    parser.add_argument("--model_nbr", type=str, default="caisr",
                        help="checkpoint to fit against — use the one "
                             "you will serve (epoch number, 'caisr', "
                             "'ae' or 'ema')")
    parser.add_argument("--downsample_steps", type=int, default=None)
    parser.add_argument("--limited_load", action="store_true")
    parser.add_argument("--use_synthetic_data", action="store_true")
    parser.add_argument("--steps", type=int, default=300)
    parser.add_argument("--lr", type=float, default=0.02)
    parser.add_argument("--batch_pairs", type=int, default=16)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--l2_to_init", type=float, default=0.0,
                        help="trust-region penalty toward the lanczos3 "
                             "init (lambda * ||W - W0||^2): damps "
                             "overfitting to a small validation split")
    parser.add_argument("--holdout_frac", type=float, default=0.2,
                        help="fraction of fitting pairs held out to "
                             "gate weight selection (the returned table "
                             "is the best-holdout candidate, analytic "
                             "init included); 0 disables")
    args = parser.parse_args(argv)
    dev = resolve_device(device)

    exper_dir = os.path.expanduser(args.exper_dir)
    settings = load_settings(os.path.join(exper_dir, "settings.yaml"))
    if args.limited_load:
        settings["limited_load"] = True
    if args.use_synthetic_data:
        settings["use_synthetic_data"] = True
    ds = (args.downsample_steps if args.downsample_steps is not None
          else int(settings.get("downsample_steps") or 2))
    if ds < 2:
        raise SystemExit(f"--downsample_steps must be >= 2, got {ds}")
    settings["downsample_steps"] = ds
    _train, val = get_datasets(settings)

    model_nbr = _model_nbr(args.model_nbr)
    trainer = get_trainer(exper_dir, model_nbr=model_nbr, eval_mode=True,
                          device=dev)
    res = _fit(trainer, val, ds, steps=args.steps, lr=args.lr,
               batch_pairs=args.batch_pairs, seed=args.seed,
               l2_to_init=args.l2_to_init,
               holdout_frac=args.holdout_frac, verbose=True)
    out = os.path.join(exper_dir, "models", "latent_taps.npz")
    save_latent_taps(out, res["offsets"], res["alphas"], res["weights"],
                     meta={"downsample_steps": ds,
                           "model_nbr": str(model_nbr),
                           "loss_init": res["loss_init"],
                           "loss_final": res["loss_final"],
                           "n_pairs": res["n_pairs"]})
    gain = (1.0 - res["loss_final"] / res["loss_init"]
            if res["loss_init"] > 0 else 0.0)
    print(f"fitted {res['weights'].shape} tap table on "
          f"{res['n_pairs']} pairs: val synthesis MSE "
          f"{res['loss_init']:.6f} → {res['loss_final']:.6f} "
          f"({100 * gain:.1f}% lower than lanczos3 init)")
    print(f"saved {out} — serve with --latent_interp fitted")
    return res


def convert_reference_checkpoint(argv=None, device=None):
    """Reference: ``tools/convert_reference_checkpoint.py`` — rewrite a
    reference experiment's torch ``.models`` checkpoints as ``SRTPU1``
    files (optimizer moments fresh). In place, each original is kept as
    ``<name>.models.torch``; with ``--output_dir`` the settings and loss
    archives are copied beside the converted files. Returns the number
    of files converted."""
    import shutil

    from ..config.settings import load_settings, save_experiment_settings
    from ..train import Trainer
    from ..train.checkpoint import save_checkpoint
    from ..train.import_torch import is_torch_checkpoint, load_torch_reference

    p = argparse.ArgumentParser(
        description="Convert reference torch checkpoints to SRTPU1")
    p.add_argument("--exper_dir", required=True,
                   help="reference experiment dir (settings.yaml + models/)")
    p.add_argument("--output_dir", default=None,
                   help="destination experiment dir (default: convert "
                        "in place, writing <name>.models alongside with "
                        "the originals preserved as <name>.models.torch)")
    p.add_argument("--files", nargs="*", default=None,
                   help="specific checkpoint filenames under models/ "
                        "(default: all *.models)")
    args = p.parse_args(argv)

    src = os.path.expanduser(args.exper_dir)
    settings = load_settings(os.path.join(src, "settings.yaml"))
    settings["output_dir"] = None       # no experiment-dir side effects
    settings.pop("device", None)        # the reference's own key
    trainer = Trainer(settings, eval_mode=True, device=device)
    names = args.files or sorted(
        os.path.basename(f)
        for f in glob.glob(os.path.join(src, "models", "*.models")))
    if not names:
        raise SystemExit(f"no *.models files under {src}/models")
    dst = os.path.expanduser(args.output_dir) if args.output_dir else src
    os.makedirs(os.path.join(dst, "models"), exist_ok=True)
    n_done = 0
    for name in names:
        fsrc = os.path.join(src, "models", name)
        if not is_torch_checkpoint(fsrc):
            print(f"skip {name}: already SRTPU1")
            continue
        state, epoch = load_torch_reference(fsrc, trainer.state)
        fdst = os.path.join(dst, "models", name)
        if os.path.abspath(fdst) == os.path.abspath(fsrc):
            os.replace(fsrc, fsrc + ".torch")
        save_checkpoint(fdst, state, epoch)
        print(f"converted {name} (epoch {epoch})")
        n_done += 1
    if os.path.abspath(dst) != os.path.abspath(src):
        save_experiment_settings(settings,
                                 os.path.join(dst, "settings.yaml"))
        for aux in ("loss_iters.npz", "losses_train.npz",
                    "losses_test.npz"):
            if os.path.isfile(os.path.join(src, aux)):
                shutil.copy2(os.path.join(src, aux), os.path.join(dst, aux))
    print(f"done: {n_done} checkpoint(s) converted into {dst}")
    return n_done


def export_reference_checkpoint(argv=None, device=None):
    """Reference: ``tools/export_reference_checkpoint.py`` — write an
    experiment's checkpoint as a reference-loadable torch ``.models``
    (the original PyTorch code's Sequential state dict and a fresh Adam
    state); the architecture comes from settings.yaml."""
    from ..train import get_trainer
    from ..train.export_torch import save_reference_checkpoint

    p = argparse.ArgumentParser(
        description="Export a checkpoint to the reference torch format")
    p.add_argument("--exper_dir", type=str, required=True)
    p.add_argument("--model_nbr", type=str, default="caisr",
                   help="epoch number or 'ae'/'caisr'/'last'")
    p.add_argument("--out", type=str, required=True,
                   help="output .models path (torch pickle)")
    args = p.parse_args(argv)

    trainer = get_trainer(os.path.expanduser(args.exper_dir),
                          model_nbr=_model_nbr(args.model_nbr),
                          eval_mode=True, device=device)
    save_reference_checkpoint(
        os.path.expanduser(args.out), trainer._ae_model(),
        epoch=int(trainer.epoch or 0),
        lr=float(trainer.args.get("lr", 0.0001) or 0.0001))
    print(f"exported {args.exper_dir} [{args.model_nbr}] -> {args.out}")
