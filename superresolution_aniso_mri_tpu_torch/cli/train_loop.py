"""Shared training loop driven by the train commands.

Port of ``superresolution_aniso_mri_tpu/cli/train_loop.py`` (reference:
train_cardiac_aesr.py:153-204 / train_brain_aesr.py:137-192): the epoch
loop over the host sampler's batches (``TripletSampler.epoch_batches``,
uploaded and shaped by ``data.device_batch``), ``num_val_batches``
validation batches, the per-epoch loss flush, image dumps and volume
previews at their intervals, best aliases and checkpoints,
``--model_filename`` / ``--auto_resume``, and KeyboardInterrupt →
``last.models``.

With ``--device_data_cache`` on (``auto``: when the padded stacks fit
the budget, ``data/device_cache.py::auto_budget_bytes``) the slices stay
on the device and a batch is one gather; without it each batch is
assembled on the host and uploaded from pinned memory. Batches are made
on the training thread: a prefetch thread was measured no faster on the
H100 with the cache or without it (PERF.md §6). The random
augmentations draw from one CPU ``torch.Generator`` per epoch, seeded
from ``(seed, epoch)``, so a resumed run redraws the stream of the
epoch it resumes.

``--steps_per_dispatch N`` (N > 1) buffers N batches and runs them
through ``Trainer.train_many`` (a CUDA graph replayed per step on the
card), the epoch's remainder through ``Trainer.train``.
``--profile_dir`` records a ``torch.profiler`` trace of the first epoch
run; ``--log_tensorboard`` also logs the image grid and, every 10
epochs, the parameter histograms.

``--get_masks`` (labeled datasets) samples each triplet with its
between slice's loss mask as the last channel; it rides through the
augmentation and reaches the step as ``batch["loss_mask"]``.
Every batch carries each pair's slice-geometry features
(``batch["alpha_features"]`` [B, 5], ``TripletSampler``'s), which the
alpha families' probes read and the other families ignore.

``-d MNISTRoto`` samples rotation triplets on the fly
(``data.synthetic.RotoTripletSampler``: phantoms, or digits from
``--mnist_path`` / ``$SR_MNIST_PATH``, with ``alpha_features`` on the
rotation grid) instead of the MNIST3D stacks.

``--num_devices N`` (N > 1) trains data-parallel, one rank per device
(``parallel.launch``): on one host the loop starts N ranks itself, one
per ``cuda:i`` over NCCL (N ranks on the CPU over gloo with ``--device
cpu``). Across hosts, ``--num_processes P --coordinator_address h:p
--process_id i`` (or ``SR_*``, ``parallel.initialize_distributed``) make
each host start N/P ranks with global ranks ``i·N/P + local``, meeting at
``h:p``; ``--num_devices`` is the global count, as JAX's mesh size.
Every rank draws the same global batches from the same seeds and steps
on its rows; rank 0 alone prints, writes images and previews and saves
(``Trainer``). The launching process returns an eval-mode trainer of
the ``last.models`` that rank 0 wrote. JAX's ValueErrors (``--num_devices``
with ``--steps_per_dispatch > 1``, a batch size N does not divide, more
devices than attached) are raised before a rank starts or anything is
written.
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Dict

import numpy as np
import torch

from ..config.net_config import NetworkConfig, merge_args_architecture
from ..data import AugmentConfig, TripletSampler, device_batch
from ..data.datasets import get_datasets
from ..data.device_cache import maybe_device_cache
from ..data.synthetic import RotoTripletSampler
from ..parallel.distributed import (cluster, initialize_distributed,
                                    is_main_process, is_rank, launch)
from ..parallel.mesh import local_mesh
from ..train import Trainer, get_trainer
from ..utils.grids import generate_recon_grid, save_image_grid
from ..utils.profiling import trace


def build_augment_config(args: Dict) -> AugmentConfig:
    """Per-dataset transform composition, as the JAX package composes it
    (reference: train_cardiac_aesr.py:83-105 get_transforms,
    datasets/common_brains.py:47-100 get_transforms_brain)."""
    dataset = args["dataset"]
    width = int(args["width"])
    aug_patch = args.get("aug_patch_size")
    if dataset in ("MNIST3D", "MNISTRoto"):
        return AugmentConfig(patch_size=width, aug_patch_size=aug_patch,
                             random_crop=False, rot90=False, intensity=False)
    # label channels (ACDCLBL) and loss-mask channels must stay exact
    exact_channels = dataset == "ACDCLBL" or bool(args.get("get_masks"))
    return AugmentConfig(
        patch_size=width,
        aug_patch_size=int(aug_patch) if aug_patch else None,
        random_crop=True, rot90=True, intensity=not exact_channels,
        rotate_any=bool(args.get("rotate_any")) and not exact_channels,
        max_degree=359,
        crop_next_to_center=dataset in ("dHCP", "ADNI", "brainMASI"),
        max_translation=35,
        noise=bool(args.get("aug_noise")) and not exact_channels,
        blur=bool(args.get("aug_blur")) and not exact_channels,
    )


def rehydrate_resume_loss_config(args_dict: Dict) -> list:
    """--auto_resume continuation: loss-defining keys the CLI left unset
    come from the experiment's recorded settings.yaml, not from ambient
    defaults (the combined families' default mix loss depends on
    SR_MIX_LOSS_DEFAULT, config/net_config.py). Returns the list of
    rehydrated keys."""
    if not args_dict.get("auto_resume"):
        return []
    out = args_dict.get("output_dir")
    spath = os.path.join(out, "settings.yaml") if out else None
    if not spath or not os.path.isfile(spath):
        return []
    from ..config.settings import load_settings

    kept = load_settings(spath) or {}
    took = []
    for key in ("image_mix_loss_func", "alpha_loss_func"):
        if args_dict.get(key) is None and kept.get(key) is not None:
            args_dict[key] = kept[key]
            took.append(key)
    return took


def epoch_generator(seed: int, epoch: int) -> torch.Generator:
    """The CPU generator of one epoch's augmentation draws, seeded from
    ``(seed, epoch)`` (the JAX loop folds the epoch into its key)."""
    state = np.random.SeedSequence([int(seed) % 2 ** 64, int(epoch)])
    return torch.Generator().manual_seed(
        int(state.generate_state(1, np.uint64)[0]))


def _check_options(merged: Dict) -> None:
    """Raise JAX's ValueErrors for ``--get_masks`` on a dataset without
    labels and for MNISTRoto with a multi-tap ``--train_latent_interp``
    (JAX raises them once the experiment directory is written)."""
    if merged.get("get_masks") and merged["dataset"] != "ACDCLBL":
        raise ValueError(
            f"--get_masks requires labeled volumes (the loss masks are "
            f"derived from RV/MYO/LV segmentations); dataset "
            f"{merged['dataset']!r} carries no labels")
    tli = str(merged.get("train_latent_interp") or "linear")
    if merged["dataset"] == "MNISTRoto" and tli in ("cubic", "lanczos3"):
        raise ValueError(
            f"--train_latent_interp {tli} is not supported for "
            "MNISTRoto (the roto sampler generates rotation "
            "triplets on the fly, not volume quintets/septets)")


def _generate_volume_previews(trainer, val_vols, merged: Dict,
                              epoch: int) -> None:
    """Synthesize the first validation volume (ds=2) and save its
    original-vs-synth compare grid (reference: base_trainer.py:149-162,
    evaluate/evaluate_image.py:36-107)."""
    interval = int(merged.get("volume_preview_interval", 1) or 0)
    if not val_vols or interval <= 0 or epoch % interval != 0:
        return
    from ..evaluate import generate_val_volume_grids

    vol = val_vols[0]
    image_dicts = {getattr(vol, "patient_id", "val0") or "val0":
                   {"image": np.asarray(vol.image, np.float32)}}
    try:
        res = generate_val_volume_grids(
            trainer, image_dicts, eval_patch_size=int(merged["width"]))
    except Exception as exc:  # a preview must never kill training
        print(f"volume preview skipped: {exc}")
        return
    for pid, grid in res["grids"].items():
        save_image_grid(grid, os.path.join(
            trainer.dir_images, f"synth_vol_{pid}_e{epoch:03d}.png"))


def _launch_ranks(args_dict: Dict, merged: Dict, verbose: bool) -> Trainer:
    """Start this host's ranks of a ``--num_devices`` run (see the
    module docstring) and wait for them; returns an eval-mode trainer of
    the ``last.models`` rank 0 wrote."""
    n_dev = int(merged.get("num_devices") or 1)
    address, hosts, host = cluster()
    if n_dev % hosts:
        raise ValueError(f"--num_devices {n_dev} must be a multiple of "
                         f"--num_processes {hosts}")
    per_host = n_dev // hosts
    device = merged.get("device") or "cuda"
    if int(merged.get("steps_per_dispatch", 1) or 1) > 1:
        raise ValueError("steps_per_dispatch > 1 is not supported with "
                         "num_devices > 1")
    mesh = local_mesh(per_host, device)
    if int(merged["batch_size"]) % n_dev:
        raise ValueError(f"batch pairs ({merged['batch_size']}) must be "
                         f"divisible by num_devices ({n_dev})")
    launch(run_training, (args_dict, verbose), mesh,
           init_method=f"tcp://{address}" if address else None,
           rank_offset=host * per_host, world_size=n_dev)
    return get_trainer(merged["output_dir"], "last", eval_mode=True,
                       device=device)


def run_training(args_dict: Dict, verbose: bool = True) -> Trainer:
    """Train the experiment that ``args_dict`` (``parse_args``' dict)
    describes on its ``device`` (``cuda`` unless it says ``cpu``), into
    its ``output_dir``. Returns the Trainer (a launching process: see
    the module docstring)."""
    # multi-host configuration first, as JAX joins its cluster before
    # any device query
    initialize_distributed(args_dict)
    rehydrate_resume_loss_config(args_dict)
    net_cfg = NetworkConfig(args_dict["model"], args_dict["dataset"],
                            args_dict.get("ae_class", "VanillaACAI"))
    merged = merge_args_architecture(args_dict, net_cfg.architecture)
    _check_options(merged)
    if int(merged.get("num_devices") or 1) > 1 and not is_rank():
        return _launch_ranks(args_dict, merged, verbose)
    main_proc = is_main_process()
    verbose = verbose and main_proc

    trainer = Trainer(merged, device=merged.get("device"))
    trainer.prepare_run()
    merged = trainer.args
    dev = trainer.device

    train_vols, val_vols = get_datasets(merged)
    ds = int(merged.get("downsample_steps") or 2)
    pad = int(merged.get("aug_patch_size") or merged["width"])
    tli = str(merged.get("train_latent_interp") or "linear")
    latent_taps = {"cubic": 4, "lanczos3": 6}.get(tli, 2)
    seed = int(merged.get("seed", 0))
    use_masks = bool(merged.get("get_masks"))
    if merged["dataset"] == "MNISTRoto":
        # on-the-fly rotation triplets (reference: MNIST/data_roto.py
        # MakeRotatedTriple), not the pre-built MNIST3D stacks; a local
        # MNIST file (mnist_path or $SR_MNIST_PATH) gives real digits
        sampler = RotoTripletSampler(
            size=int(merged["width"]), downsample_steps=ds, seed=seed,
            mnist_path=merged.get("mnist_path"), mnist_split="train")
        val_sampler = RotoTripletSampler(
            size=int(merged["width"]), downsample_steps=ds, seed=seed + 1,
            mnist_path=merged.get("mnist_path"), mnist_split="val")
    else:
        sampler = TripletSampler(
            train_vols, ds, merged.get("slice_selection", "adjacent_plus"),
            pad_size=pad, seed=seed, use_masks=use_masks,
            latent_taps=latent_taps)
        val_sampler = TripletSampler(val_vols, ds, "adjacent_plus",
                                     pad_size=pad, seed=seed + 1,
                                     use_masks=use_masks,
                                     latent_taps=latent_taps)
    # device-resident slice cache: the padded stacks uploaded once, each
    # batch gathered on the device (the same batches as the host path)
    cache_mode = merged.get("device_data_cache", "auto")
    sampler = maybe_device_cache(sampler, cache_mode, dev, verbose=verbose)
    val_sampler = maybe_device_cache(val_sampler, cache_mode, dev)
    aug_cfg = build_augment_config(merged)
    val_cfg = AugmentConfig(patch_size=int(merged["width"]),
                            aug_patch_size=aug_cfg.aug_patch_size,
                            random_crop=False, rot90=False, intensity=False)

    batch_size = int(merged["batch_size"])
    test_batch_size = int(merged.get("test_batch_size", batch_size))
    epochs = int(merged["epochs"])

    if merged.get("model_filename"):
        trainer.load(merged["model_filename"])
        if verbose:
            print(f"resumed from {merged['model_filename']} "
                  f"(epoch {trainer.epoch})")
    elif merged.get("auto_resume"):
        # elastic restart: prefer the rolling last.models (written every
        # epoch), else the newest numbered checkpoint
        from ..evaluate.find_best_model import list_epoch_checkpoints

        last = os.path.join(trainer.dir_models, "last.models")
        ckpt = None
        if os.path.isfile(last):
            ckpt = last
        else:
            epochs_saved = list_epoch_checkpoints(merged["output_dir"])
            if epochs_saved:
                ckpt = os.path.join(trainer.dir_models,
                                    f"{epochs_saved[-1]}.models")
        if ckpt:
            trainer.load(ckpt)
            if verbose:
                print(f"auto-resumed from {ckpt} (epoch {trainer.epoch})")

    # stall watchdog (--step_timeout_s): a hung device blocks instead of
    # raising — beat after every completed step and exit 75 on silence
    # so a supervisor can restart with --auto_resume
    watchdog = None
    timeout_s = float(merged.get("step_timeout_s") or 0)
    if timeout_s > 0:
        from ..utils.watchdog import StepWatchdog

        first_s = max(timeout_s,
                      float(merged.get("first_step_timeout_s") or 600.0))
        watchdog = StepWatchdog(timeout_s, label=str(
            merged.get("exper_id") or "train"),
            first_timeout_s=first_s).start()

    def _beat():
        if watchdog is not None:
            watchdog.beat()
            # re-arm after a pause across rank 0's epoch end (no-op when
            # armed)
            watchdog.resume()

    profile_dir = merged.get("profile_dir")
    start_epoch = trainer.epoch
    spd = int(merged.get("steps_per_dispatch", 1) or 1)
    try:
        for epoch in range(trainer.epoch, epochs):
            t0 = time.time()
            last_batch = None
            gen = epoch_generator(seed, epoch)
            # --profile_dir: a torch.profiler trace of the first epoch run
            prof = (trace(profile_dir, dev) if profile_dir
                    and epoch == start_epoch else contextlib.nullcontext())
            with prof:
                buf = []
                for raw in sampler.epoch_batches(batch_size):
                    last_batch = device_batch(raw, aug_cfg, dev,
                                              latent_taps, generator=gen,
                                              with_mask=use_masks)
                    if spd <= 1:
                        trainer.train(last_batch)
                        _beat()
                        continue
                    buf.append(last_batch)
                    if len(buf) == spd:
                        trainer.train_many(buf)
                        _beat()
                        buf = []
                for batch in buf:  # the epoch's remainder
                    trainer.train(batch)
                    _beat()
            # end-of-epoch validation over several batches, so best-model
            # selection averages a real estimate
            n_val = int(merged.get("num_val_batches", 4) or 4)
            val_batch = None
            for _ in range(n_val):
                val_batch = device_batch(
                    val_sampler.sample_batch(test_batch_size), val_cfg, dev,
                    latent_taps, with_mask=use_masks)
                trainer.validate(val_batch)
                _beat()
            trainer.show_loss_on_tensorboard("train")
            trainer.show_loss_on_tensorboard("test")

            if last_batch is None:
                raise ValueError(
                    f"epoch {epoch} produced 0 training batches — the "
                    f"dataset has fewer slices ({len(sampler)}) than "
                    f"batch_size ({batch_size})")
            if verbose:
                tr = trainer.mean_losses["loss_ae"][-1]
                te = trainer.mean_losses_test["loss_ae"][-1]
                print(f"epoch {epoch:4d}  loss_ae={tr:.5f} "
                      f"val={te:.5f}  ({time.time() - t0:.1f}s)")

            # image dumps (reference: base_trainer.py:395-420)
            dump_every = int(merged.get("image_dump_interval", 1) or 0)
            if main_proc and trainer.test_predictions and dump_every > 0 \
                    and epoch % dump_every == 0:
                grid = generate_recon_grid(
                    val_batch["image"][:, 0].cpu().numpy(),
                    trainer.test_predictions["reconstruction"][:, 0]
                    .cpu().numpy())
                save_image_grid(grid, os.path.join(
                    trainer.dir_images, f"val_recons_e{epoch:03d}.png"))
                trainer.log_tb_image("val/reconstructions", grid)
                _beat()

            if main_proc:
                _generate_volume_previews(trainer, val_vols, merged, epoch)
                _beat()
            if merged.get("log_tensorboard") and epoch % 10 == 0:
                trainer.log_tb_histograms()
            trainer.reset_losses()
            trainer.end_epoch_processing()
            _beat()
            if not main_proc and watchdog is not None:
                # the next epoch's first collective waits for rank 0's
                # previews and checkpoints: its progress, not a stall here
                # (rank 0's own watchdog covers a hung device)
                watchdog.pause()
    except KeyboardInterrupt:
        if watchdog is not None:
            watchdog.stop()
        # the rolling checkpoint, not a numbered file: a numbered name
        # means "epoch N completed" to the find-best sweep. Stored epoch
        # = trainer.epoch, so --auto_resume reruns the interrupted epoch
        fname = os.path.join(trainer.dir_models, "last.models")
        trainer.save_models(fname, trainer.epoch)
        print(f"interrupted — saved {fname} (epoch {trainer.epoch})")
    finally:
        if watchdog is not None:
            watchdog.stop()
        if trainer.tb_writer is not None:
            trainer.tb_writer.close()
            trainer.tb_writer = None
    return trainer
