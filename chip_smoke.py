#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU: serve and score
a full-width OASIS ae_combined volume, train it, run the experiment-
directory commands of the README quick start, and hold every
hand-written kernel against its plain PyTorch version.

    python3 chip_smoke.py                        # one card, no arguments
    python3 chip_smoke.py --profile out/prof.txt # + trace one serve+score,
                                                 # one train step, 10
                                                 # steps each of phase 8's
                                                 # and phase 9's OASIS and
                                                 # 16 graph-replayed ones
                                                 # of phase 10's, 10 of
                                                 # phase 11's acai, 10
                                                 # eager and 16 replayed
                                                 # of phase 12's and of
                                                 # phase 13's

Phases (any failure ends the run with a non-zero exit):
  1. device: the card's name and power limit (nvidia-smi);
  2. kernels: build ``csrc/ssim.cu``; check its branch-free division by
     the window against IEEE division for every float32 input; hold the
     SSIM kernel against the plain ``ops.metrics.ssim_volume`` for win
     3/5/7/11 on the shapes of ``KERNEL_SHAPES`` and on a pair of
     phantom volumes (flat patches, all-zero end slices);
  3. serve: the bench config (width 64, latent_width 16, depth 32,
     latent 128, BN, sigmoid, bfloat16 compute) with seeded random
     weights; 30 kept slices of a seeded 175 x 220 x 220 phantom at
     ds=6 → 175 slices, linear and lanczos3; a batch of 4 volumes against
     4 single calls; bf16 against f32; card against CPU on a small crop;
  4. score: ``compute_volume_metrics`` on the card (SSIM through the
     CUDA kernel), against the same call on the CPU;
  5. train: the README's OASIS recipe at full width (float32,
     ae_combined, MSE mix loss, ex_loss_weight1 0.001, lr 1e-5, 16 pairs
     of 64² patches from four seeded phantoms through TripletSampler,
     the deterministic augment_batch and prepare_batch_pairs, ds=4):
     30 steps on one batch must lower loss_ae; 5 steps of a small config
     on the card against the CPU; a 2-epoch Trainer run writes the
     experiment files; its caisr.models is served (ds=6) and scored on
     the card; train ms/step, steps/s and peak memory;
  6. timings from CUDA events after warm-up, beside the card's name and
     power limit; the kernel both back to back (``ms``, inputs partly in
     the 50 MB L2) and with a 256 MB scratch write before each launch
     (``ms_cold``);
  7. experiment-directory CLIs (``cli/entry.py``, in-process, in a temp
     dir): train-brain, the README quick start (MNIST3D, synthetic data,
     ae_combined, MSE mix loss, ds=6, 2 epochs of 16 pairs) at the bench
     config's widths in float32, checked for its experiment files and
     its settings.yaml; generate-hr-volumes of the phantom's 30 kept
     slices (6 mm) into 175 slices (1 mm), with read, synthesis and
     write timed apart; find-best-model plain and ``--batched`` with the
     SSIM launches counted (4 and 2) and their scores held together;
     serve-hr-volumes ``--once`` over two volumes with a manifest; and a
     small experiment trained on the card, densified on the card and on
     the CPU;
  8. production recipes from disk (``$SR_DATA_ROOT`` in a temp dir, trees
     written with the port's NIfTI writer): train-brain -d OASIS
     (train_brain_aesr.py:8-10 with the MSE mix loss, ``--epoch_threshold
     -1``, 2 epochs; 5 patients of [176, 208, 176] at 1 mm, 3 train / 1
     validation / 1 test) with the random crop, rot90 and intensity
     drawn, with the device slice cache and without it (s/epoch, ms/step
     from CUDA events), and the cache's ``auto`` budget on the card
     against the recipe's 200 training patients;
     find-best-model over its 2 checkpoints on the validation patient,
     SSIM launches counted and the kernel held against the plain version
     on the pairs it scored; train-cardiac -d ACDC
     with ``--train_latent_interp lanczos3`` (3 cines of [12, 10, 216,
     256] at 10 x 1.5625 x 1.5625 mm, 1 epoch); ``augment_batch`` ms per
     batch for the OASIS, dHCP-noise, ACDC-lanczos3 and every-op recipes;
     ``apply_augment`` on the card against the CPU (every op but noise);
  9. the perceptual and SSIM losses, LPIPS scoring and the conventional
     baselines, on phase 8's trees: train-brain -d OASIS with the
     recipe's flags but ``--image_mix_loss_func`` (so ae_combined trains
     its default perceptual mix loss, VGG LPIPS over the shipped lins,
     ``lpips_mode`` in settings.yaml checked), 2 epochs, ms/step beside
     phase 8's MSE ms/step; one epoch each of ``perceptual_enc``,
     ``mse --use_ssim_loss`` and train-cardiac -d ACDC in bfloat16 with
     the perceptual default (the VGG stack in bfloat16); 3 small-config
     perceptual steps on the card against the CPU;
     ``create_hr_images(compute_percept_metrics=True)`` on the
     perceptual run's caisr checkpoint over the OASIS validation volume
     and each of the four ``FILTER_BENCH`` baselines on it (s/volume,
     SSIM/PSNR/VIF, the SSIM launches counted and held against the
     plain version); LPIPS of a [175, 220, 220] pair timed with CUDA
     events, its peak memory, and card against CPU on 4 slices;
 10. the training loop's options, fit-latent-taps and the reference
     checkpoints, on phase 8's trees: train-brain -d OASIS (cache on)
     with ``--steps_per_dispatch 8`` (the train step captured in a CUDA
     graph and replayed) for the MSE recipe and the perceptual default,
     2 epochs each, ms/step beside phases 8 and 9's eager ms/step of the
     same call; 8 replays of the captured full-width step against 8
     eager steps from the same state and batches (limit 1e-6
     relative); one epoch with ``--ema_decay 0.999 --profile_dir
     --log_tensorboard`` (``ema.models`` through ``get_trainer('ema')``,
     the trace file, the ``tb/`` event file when tensorboardX imports);
     fit-latent-taps (300 steps) on phase 8's caisr checkpoint and the
     validation patient, then ``create_hr_images`` with the fitted table
     (SSIM launches counted, the kernel held against the plain version);
     phase 8's caisr.models exported to the reference's torch format,
     converted back, and the three served on the card (limit 1e-6).
 11. the comparison families, on phase 8's trees with the OASIS
     recipe's flags: train-brain -m acai_combined, 2 epochs eager and 2
     with ``--steps_per_dispatch 8`` (ms/step of both), 8 replays against
     8 eager steps with the same draws (limit 1e-6 relative),
     find-best-model over its checkpoints on the validation patient;
     -m vae_combined (1 epoch, ``--epoch_threshold 0``: one 24 GiB
     checkpoint) and -m vae2 (1 epoch): ms/step, peak GiB, the
     checkpoint read back (every tensor's sum equal), a [175, 64, 64]
     phantom crop served and scored; -m ae_combined with ``--ae_class
     LargerAE`` and ``VanillaACAIStrided``, 1 epoch each, served and
     scored on the validation patient (``create_hr_images``); 3
     small-config steps of each family on the card against the CPU with
     the same draws.
 12. the labeled cardiac path (ACDCLBL), on phase 8's data root: ED/ES
     frames of ``LABELED_PATIENTS`` patients ([10, 216, 256] at 10 x
     1.5625 x 1.5625 mm, phantom ``_gt`` maps in {0, 1, 2, 3}) written
     beside phase 8's cines, which must read back unchanged;
     train-cardiac -d ACDCLBL with the cardiac recipe's flags
     (MultiChannelAE, multichannel_combined, width 128, latent 128,
     depth 32, -b 12): 2 epochs eager, 1 with ``--get_masks``, 1 with
     ``--steps_per_dispatch 8`` (ms/step, peak GiB), 8 replays against 8
     eager steps (limit 1e-6 relative); 3 small-config steps on the card
     against the CPU (limit 1e-5 relative); generate-hr-volumes of the
     validation patient's frame with its ``_gt`` map (decoded labels in
     {0, 1, 2, 3} on the output grid, s/volume); the decoded labels of
     bf16 serving against float32's (share of equal voxels);
     ``create_hr_images`` and find-best on the validation frames (SSIM
     launches counted, each pair held against the plain version).
 13. the alpha-probe families, on phase 8's ACDC cines with the cardiac
     recipe's flags (``ALPHA_ARGV``: width 128, latent 128, depth 32,
     -b 12): train-cardiac -m alpha_end_to_end 2 epochs eager and 1 with
     ``--steps_per_dispatch 8`` (ms/step, the spd 8 one from 8 replays
     of the captured step, peak GiB), 8 replays against 8 eager steps
     (limit 1e-6 relative); -m alpha, alpha_only (its autoencoder
     bitwise unchanged) and alpha_combined, and -m alpha_end_to_end
     --alpha_class AlphaProbe256v1 (the spatial scheme, a 2053-wide
     flatten), 1 epoch each; 3 small-config steps of each variant on the
     card against the CPU (limit 1e-5 relative); ``create_hr_images``
     and find-best over the alpha_end_to_end checkpoints on the
     validation frames; ``latent_space_interp_pred_alpha`` of the first
     validation frame's kept slices (its 128² center crop, ds 2) scored
     against the held-out slices (the predicted alphas' mean and range);
     ``reconstruct_in_patches`` on the card against the CPU; a forward of
     each legacy model on the card against the CPU. SSIM launches
     counted and each pair held against the plain version.
 14. evaluation of trained experiments, on phase 8's trees: train-brain
     -m ae (the OASIS recipe's flags, 1 epoch) is the primary of the
     AE+CAISR combo; ``load_caisr`` of phase 8's caisr.models, phase
     11's acai_combined checkpoint (its ``ae``) and phase 10's
     reference-torch export, in turn: the test volume served (its
     synthesized slices the SR model's own, within ``COMBO_ATOL``, and
     not the autoencoder's; its kept slices the primary's predict) and
     scored with ``create_hr_images``; the combo on the card against
     the CPU on a crop; ``combine_volumes`` of the AE-only and combo
     NIfTI files, ``compare_quantitative`` of both against the volume;
     ``evaluate_model_reconstruction`` on the validation and test
     volumes; the rigid-transform table at 0 and 10 degrees;
     ``compute_ppl`` of 64 pairs of 208 x 176 slices, and of 4 on the
     card against the CPU; ``resample_sax_to_lax`` of one of phase 8's
     cines onto a long-axis plane, card against CPU; train-brain -d
     MNISTRoto (1 epoch, the recipe's widths) through the CLI and
     ``create_brain_volumes`` on it. s/volume and s/call beside the
     card; SSIM launches counted and each pair held against the plain
     version.
 15. dataset preparation, SR-segmentation scoring and the perceptual
     tools, on phase 8's data root and the experiments of phases 8 and
     12: ``create_dhcp_dataset`` over ``DHCP_SUBJECTS`` raw subjects of
     ``DHCP_SHAPE`` at 0.5 mm, their 4x LR files and ``get_datasets -d
     dHCP``; ``create_masi_cropped_dataset`` and
     ``create_masi_lr_dataset`` over ``MASI_PATIENTS`` raw patients with
     6-class references, then ``get_datasets -d brainMASI``;
     ``create_centered_dataset`` of phase 12's patients (a 2-frame ED/ES
     cine where phase 8 wrote none), read back by ``load_acdc_volumes``,
     a centered validation frame served by phase 8's ACDC model and
     scored by ``create_hr_images``; an SR-seg set of fold-0 validation
     ids from phase 12's ED/ES frames and ``_gt`` maps, the
     MultiChannelAE's decoded labels scored by
     ``evaluate_sr_segmentation`` (the references against themselves:
     Dice 1, HD95 and ASSD 0); ``fit-perceptual-head`` on phase 8's
     OASIS caisr checkpoint and ``lpips-gap-study`` with the artifact
     (4 slices of 128²), both on the card against the CPU (2 slices of
     64²); ``convert-lpips-weights`` of a seeded torchvision-shaped
     VGG16 and lin state dict, its LPIPS equal to the same arrays
     passed directly. s/volume and s/call beside the card; SSIM launches
     counted and each pair held against the plain version.
 16. more than one device and the packed decoder (``parallel/``,
     ``infer/packed_decoder.py``): (a) the bench config's slice axis
     split over ``[cuda:0, cuda:0]`` (``make_sharded_synthesizer``; 29
     kept slices padded to 30), linear and lanczos3, float32 and bf16,
     against the unsharded core, the sharded volume scored (its SSIM
     pair within ``PARALLEL_SSIM_ATOL`` of the plain version); (b) the
     volume axis (``make_sharded_batched_synthesizer``, 3 volumes
     padded to 4), ``create_super_volume(num_devices=count)`` and
     ``count + 1`` raising; (c) two ranks on cuda:0 over gloo through
     ``parallel.launch`` (NCCL refuses two ranks on one GPU), each a
     data-parallel ``Trainer`` on the OASIS recipe at full width with
     ``--train_latent_interp lanczos3``, ``DP_STEPS`` steps, against the
     single process on the same global batches and on the batches with
     their pairs permuted ``MESH2D_PERMUTATIONS`` ways (the largest of
     their gaps: the float32 reordering noise that bounds the gaps of
     the loss, the step-1 gradient and θ − θ0), every run with cuDNN's
     deterministic algorithms, rank 1 writing nothing; (d) a one-rank
     NCCL group's ``make_sharded_train_step`` against
     ``make_train_step`` and ``train-brain --num_devices 1``;
     (e) the decode of ``DP_DECODE`` latents, packed against plain,
     float32 and bf16, medians of 20 CUDA-event times. Its numbers go on
     the ``parallel`` line.
 17. the last modules: (a) two ranks on cuda:0 over gloo as a dp 1 ×
     mp 2 mesh (``parallel.create_mesh_2d`` / ``shard_state_2d`` /
     ``make_sharded_train_step_2d``: each conv kernel's output channels
     split over the model group), phase 16's recipe for
     ``MESH2D_STEPS`` steps, the whole gradient and θ gathered from the
     shards (``gather_state_2d``), against the single process and the
     single process on pairs permuted ``MESH2D_PERMUTATIONS`` ways
     (phase 16c's gates, over the largest of the permuted gaps), every
     run with cuDNN's deterministic algorithms (as phase 16d); both
     ranks' replicated parameters and BatchNorm statistics the same
     bits; (b) on phase 8's OASIS tree (run inside phase 8's block,
     after phase 15): the native loader built at first use, every OASIS
     file decoded bit for bit against the numpy reader, the recipe's
     batches gathered bit for bit against the numpy stack, and in turns
     (numpy, native, native, numpy) the directory ingest's seconds
     (the native ingest against the loaders' Python pool), the batch
     assembly's host ms and the uncached recipe's ms/step (one epoch a
     run), medians, with the host named; (c) the figures: every page
     drawn where matplotlib imports, else ``evaluate`` imports and a
     figure call raises ``ModuleNotFoundError`` naming matplotlib. Its
     numbers go on the ``phase17`` line.
 18. the production-pipeline quality harness (``tools/
     real_pipeline_quality.py``, ``tools/quality_check.py``): the port's
     ``real-pipeline-quality`` end to end on the card, in a temp dir,
     for the README's OASIS recipe row (7 patients of 37 × 64², σ 0.03,
     MSE, latent width 32, no BN, the cosine schedule, lanczos3 serving,
     4 epochs, ``--sweep_last 2``, 2 extra volumes), its cardiac
     throughput row (7 cines of 6 × 15 × 64², bf16, lanczos3, 2 epochs,
     1 extra cine), its dHCP 4x row at σ 0.03 with ``--aug_noise
     --max_grad_norm 1.0`` (7 patients of 37 × 256², latent width 128,
     no BN, the cosine schedule, lanczos3, 2 epochs, 1 extra volume)
     and its cardiac float32 row served with ``--tta flips`` (cut as the
     bf16 row): fabrication, the training and find-best children
     (the port's CLI; their SSIM launches through
     ``SR_KERNEL_LAUNCHES_LOG``), the scoring in this process. Each row
     has the keys of JAX's recorded row (r4 row 1, with those JAX's
     tool has written since) and finite metrics; the SSIM launches of
     the scoring and of find-best equal the count predicted from the
     volumes (every pair the scoring scores held against the plain
     version); the kept OASIS and TTA checkpoints scored on the CPU
     agree with the card per aggregate within ``QUALITY_CPU_RTOL``; then
     ``quality-check`` for 2 epochs. Its numbers go on the ``phase18``
     line.
 19. the measurement commands (``tools/{bench,infer_roofline,
     train_bench,pipeline_bench,loader_bench}.py``), each a child
     ``python -m superresolution_aniso_mri_tpu_torch.cli <command>`` on
     the card as a user runs it (``MEASURE_ARGV``): ``bench`` at the full
     case (its JSON line; ``ssim_selfcheck`` within 1e-3 of 1,
     ``ssim_kernel_path`` "cuda", its SSIM launches through
     ``SR_KERNEL_LAUNCHES_LOG`` equal to the 2 predicted),
     ``infer-roofline --batches 1 8 --split --packed``, ``train-bench
     --steps 10`` (six rows), ``pipeline-bench --epochs 3 --n_patients 7
     --variants 0 1`` and ``loader-bench``. Every roofline share they
     print must lie in (0, 1] (a share above 1 is a wrong FLOP or byte
     count, never clamped), and every FLOP count must equal the same
     function's count on the meta device in this process (shapes only).
     Its numbers go on the ``phase19`` line.
The main path (serve linear → score) runs with every kernel launch count
set to 0 just before it and read just after; so do the train phase's
path (serve the trained checkpoint → score), each find-best sweep of
phase 7, phase 8's find-best, phase 9's scoring of the perceptual
checkpoint and of the baselines, phase 10's scoring of the fitted
table, phase 11's, 12's, 13's, 14's, 15's, 16's and 18's scoring paths,
phase 19's bench
(every pair each scored held against the plain version). The line
before the last lists every kernel with its check, launches
(``launches``: the main path; ``launches_by_path``: every counted path)
and times; the last line is the device summary.
"""
import argparse
import contextlib
import dataclasses
import itertools
import json
import os
import subprocess
import sys
import time

import numpy as np

HW, LR_SLICES, DS = 220, 30, 6
HR_SLICES = (LR_SLICES - 1) * DS + 1          # 175
BENCH_CFG = dict(width=64, latent_width=16, depth=32, latent=128, colors=1,
                 use_batchnorm=True, use_sigmoid=True)
KERNEL_SHAPES = ((HR_SLICES, HW, HW), (8, 256, 256), (5, 129, 97),
                 (3, 64, 1500),            # + the phantom pair, (S, 220, 220)
                 # phase 7's find-best sweeps of the two 49-slice toy
                 # volumes at 64²: one volume a launch (plain), then both
                 # volumes' 67 padded output slices in one (batched)
                 (8 * DS + 1, 64, 64), (2 * 67, 64, 64),
                 # phase 8's OASIS find-best: the validation volume's 44
                 # slices at ds 4 synthesised into 173 of 208 x 176
                 (43 * 4 + 1, 208, 176),
                 # phase 12's scoring: a [10, 216, 256] ACDC frame at
                 # 1.5625 mm resampled to 1.4 mm, its 9 on-grid slices
                 (9, 241, 286),
                 # phase 13's probe-mixed slices: 4 of a frame's 128²
                 # center crop at ds 2
                 (4, 128, 128),
                 # phase 14: an OASIS volume's 176 reconstructed slices,
                 # a MNISTRoto validation volume (ds 4, width 64)
                 (176, 208, 176), (33, 64, 64),
                 # phase 18: the quality rows' scored volumes (OASIS
                 # 37 x 64², ACDC frames 15 x 64²) and find-best's
                 # chunks (one OASIS validation volume's 13 kept slices
                 # padded to 16 → 46; 12 ACDC frames of 8 kept → 15)
                 (37, 64, 64), (15, 64, 64), (46, 64, 64),
                 (12 * 15, 64, 64),
                 # phase 18's dHCP entry: its scored 37 x 256² volumes
                 # and find-best's chunks (a validation volume's 10
                 # kept slices padded to 12 → 45, one volume a chunk)
                 (37, 256, 256), (45, 256, 256),
                 # phase 19's bench: ssim_selfcheck on 8 served slices
                 # (its bf16_ssim_delta is the first shape's)
                 (8, HW, HW))
KERNEL_ATOL = 1e-5
HBM_BYTES_PER_S = 3.35e12     # H100 SXM HBM3 (NVIDIA data sheet)
F32_FLOPS_PER_S = 67e12       # H100 SXM float32 outside the tensor cores
L2_FLUSH_BYTES = 256 << 20    # > 5x the H100's 50 MB L2
# train phase: the README's OASIS recipe (train_brain_aesr.py) at full width
TRAIN_ARGS = dict(model="ae_combined", dataset="OASIS", **BENCH_CFG,
                  compute_dtype="float32", image_mix_loss_func="mse",
                  ex_loss_weight1=0.001, lr=1e-5, batch_size=16,
                  downsample_steps=4, slice_selection="adjacent_plus")
TRAIN_PATCH, TRAIN_DS, TRAIN_LEARN_STEPS = 64, 4, 30
SMALL_CFG = dict(width=32, latent_width=8, depth=4, latent=6, colors=1,
                 use_batchnorm=True, use_sigmoid=True)
# phase 7: epochs of the quick-start train command; plain and batched
# find-best sweeps agree within SWEEP_ATOL (tests/test_torch_port_cli.py)
CLI_EPOCHS = 2
SWEEP_ATOL = 1e-4
# phase 8: the README's production recipes from on-disk trees. OASIS-1's
# T88 grid, thick-slice LR files; ACDC cines at their native spacing.
# Only the patient counts and the epochs are cut.
OASIS_PATIENTS, OASIS_SHAPE, OASIS_DS = 5, (176, 208, 176), 4
ACDC_PATIENTS, ACDC_SHAPE = 3, (12, 10, 216, 256)     # frames, z, y, x
ACDC_SPACING = (10.0, 1.5625, 1.5625)
OASIS_ARGV = ["-d", "OASIS", "-m", "ae_combined", "-b", "16", "--width", "64",
              "--latent_width", "16", "--latent", "128", "--downsample_steps",
              str(OASIS_DS), "-e", "2", "--aug_patch_size", "220",
              "--ex_loss_weight1", "0.001", "--image_mix_loss_func", "mse",
              "--epoch_threshold", "-1"]
ACDC_ARGV = ["-d", "ACDC", "-m", "ae_combined", "-b", "12", "--latent", "128",
             "--downsample_steps", "2", "-e", "1", "--ex_loss_weight1", "0.05",
             "--image_mix_loss_func", "mse", "--train_latent_interp",
             "lanczos3"]
AUG_ATOL = 1e-5
# phase 9: LPIPS on the card against the CPU, float32 with TF32 off.
# cuDNN and oneDNN sum the 13 convolutions (up to 4608 terms a pixel)
# in other orders: 1.5e-5 at 220² on an H100 80GB HBM3 at 700 W; TF32
# would give ~1e-3
LPIPS_CARD_RTOL = 1e-4
# phase 10: steps per dispatch of the graph-replayed runs; replays and
# eager steps agree within GRAPH_RTOL (bitwise expected: the same
# kernels); the fit's steps (the CLI's default)
SPD = 8
GRAPH_RTOL = 1e-6
FIT_STEPS = 300
# phase 12: the labeled cardiac path (ACDCLBL). ED/ES frames at ACDC's
# native spacing; 8 training patients so that one epoch of the recipe's
# 12-slice batches has the 12 batches graph vs eager takes (4 for the
# warm-up and capture, 8 compared); the README cardiac row's flags
# without --train_latent_interp (JAX trains the multichannel families
# through the 2-tap mix only), --epoch_threshold -1 for find-best.
LABELED_PATIENTS, LABELED_SHAPE = 9, (10, 216, 256)
LABELED_ARGV = (["-d", "ACDCLBL"]
                + ACDC_ARGV[2:ACDC_ARGV.index("--train_latent_interp")]
                + ["--epoch_threshold", "-1"])
LABELED_CARD_RTOL = 1e-5
# bf16 against float32 serving of an (almost untrained) model: the share
# of voxels whose decoded class agrees; a broken label path would agree
# by chance (~1/4 for 4 classes)
LABELED_BF16_AGREEMENT = 0.5
# phase 13: the alpha-probe families on phase 8's ACDC cines (2 training
# patients × 12 frames × 10 slices: 20 batches of 12 an epoch, so spd 8
# fills two dispatches and graph vs eager has its 12 batches), the README
# cardiac row's flags without --train_latent_interp (the alpha branch of
# JAX's loss_config_from_args ignores it), --epoch_threshold -1 for
# find-best
ALPHA_ARGV = (["-d", "ACDC", "-m", "alpha_end_to_end"]
              + ACDC_ARGV[4:ACDC_ARGV.index("--train_latent_interp")]
              + ["--epoch_threshold", "-1"])
ALPHA_CARD_RTOL = 1e-5
# the legacy models' float32 forwards (TF32 off) on the card against the
# CPU's, relative to the output's largest entry. DiscriminatorSpatial
# ends in a 32768-term Dense whose scores cancel, and the card and the
# CPU round it to opposite sides of its float64 forward (card 5.2e-6,
# CPU 4.8e-6, 1.0e-5 apart, on an H100 80GB HBM3 at 700 W and its
# host): it is held against the float64 forward instead, at the same
# limit
LEGACY_CARD_RTOL = 1e-5
# phase 14: the combo's synthesized slices against the SR model's own
# serving (the same decoder, other decode batches: cuDNN may pick other
# float32 algorithms), and the merged AE + CAISR files against the
# combo's; MNISTRoto at the OASIS recipe's widths (the sampler's
# triplets are --width square, so no --aug_patch_size)
COMBO_ATOL = 1e-5
# phase 15: dataset preparation, SR-segmentation scoring, the perceptual
# tools. dHCP subjects at the T2 grid (0.5 mm) prepared for the README's
# neonatal 4x row (2.0 → 0.5 mm); brainMASI on a cut grid and patch, 17
# patients so that the reference split (15 training) leaves a test set;
# the SR-seg set is the first 3 fold-0 validation ids (the loader's
# limited_load); the perceptual tools at 4 slices of 128². The fitted
# lins on the card against the CPU: 400 Adam steps over float32 feature
# sums that cuDNN and oneDNN add in other orders
DHCP_SUBJECTS, DHCP_SHAPE, DHCP_DS = 2, (217, 290, 290), 4
DHCP_SPACING = (0.5, 0.5, 0.5)
MASI_PATIENTS, MASI_SHAPE, MASI_PATCH, MASI_DS = 17, (64, 80, 64), 96, 4
SR_SEG_PATIENTS = 3
PERCEPT_ARGV = ["--n_slices", "4", "--size", "128"]
TOOLS_FIT_RTOL = 1e-3
ROTO_ARGV = ["-d", "MNISTRoto", "-m", "ae_combined", "-b", "16", "--width",
             "64", "--latent_width", "16", "--latent", "128",
             "--downsample_steps", str(OASIS_DS), "-e", "1",
             "--ex_loss_weight1", "0.001", "--image_mix_loss_func", "mse"]


# phase 16: the data-parallel OASIS recipe (lanczos3 training mix) and
# the sharded serving: 29 kept slices (padded to 30 over two shards),
# the decode timed on one auto decode_batch chunk of the bench volume
DP_ARGS = dict(TRAIN_ARGS, train_latent_interp="lanczos3")
DP_STEPS, DP_KEPT, DP_DECODE = 10, 29, 43
PARALLEL_SSIM_ATOL = 6e-8
# phase 17: steps of the 2-D (dp 1 × mp 2) step on phase 16's recipe;
# the permuted single-process runs that measure the reordering noise of
# phases 16c and 17a
MESH2D_STEPS, MESH2D_PERMUTATIONS = 5, 3
# phase 18: the production-pipeline quality harness at a reduced depth.
# The README's OASIS recipe row (docs/quality_real_r4.jsonl row 1), the
# cardiac throughput row (row 4, bfloat16), the dHCP 4x row at sigma
# 0.03 with the noise augmentation and the clip
# (docs/quality_real_r5.jsonl row 1: 256², latent width 128) and the
# cardiac float32 row served with TTA flips
# (docs/quality_real_r3.jsonl row 32) at their widths and shapes, cut to
# 7 patients (the tool's least) and 4 / 2 epochs; quality-check for 2
# epochs. The kept OASIS and TTA checkpoints scored on the card and on
# the CPU agree per aggregate within QUALITY_CPU_RTOL (relative, plus
# one rounding step of the row's 5 decimals)
QUALITY_ROWS = {
    "oasis": ["--dataset_shape", "OASIS", "--n_patients", "7",
              "--num_slices", "37", "--inplane", "64", "--phantom_noise",
              "0.03", "--loss_mode", "mse", "--latent_width", "32",
              "--use_batchnorm", "0", "--lr_schedule", "--latent_interp",
              "lanczos3", "--epochs", "4", "--sweep_last", "2",
              "--extra_test_volumes", "2"],
    "acdc": ["--dataset_shape", "ACDC", "--n_patients", "7", "--num_slices",
             "15", "--inplane", "64", "--num_frames", "6", "--phantom_noise",
             "0.03", "--loss_mode", "mse", "--latent_width", "32",
             "--compute_dtype", "bfloat16", "--train_latent_interp",
             "lanczos3", "--latent_interp", "lanczos3", "--epochs", "2",
             "--sweep_last", "2", "--extra_test_volumes", "1"],
    "dhcp": ["--dataset_shape", "dHCP", "--n_patients", "7", "--num_slices",
             "37", "--inplane", "256", "--phantom_noise", "0.03",
             "--loss_mode", "mse", "--latent_width", "128",
             "--use_batchnorm", "0", "--lr_schedule", "--train_latent_interp",
             "lanczos3", "--latent_interp", "lanczos3", "--aug_noise",
             "--max_grad_norm", "1.0", "--epochs", "2", "--sweep_last", "2",
             "--extra_test_volumes", "1"],
    "acdc_f32_tta": ["--dataset_shape", "ACDC", "--n_patients", "7",
                     "--num_slices", "15", "--inplane", "64", "--num_frames",
                     "6", "--phantom_noise", "0.03", "--loss_mode", "mse",
                     "--latent_width", "32", "--train_latent_interp",
                     "lanczos3", "--latent_interp", "lanczos3", "--tta",
                     "flips", "--epochs", "2", "--sweep_last", "2",
                     "--extra_test_volumes", "1"],
}
# the rows whose kept checkpoint is scored on the CPU too
QUALITY_CPU_ROWS = ("oasis", "acdc_f32_tta")
# find-best's chunks a numbered checkpoint: the validation volumes share
# one chunk, but at 256² one volume's in-flight decode (32 slices at 32
# channels, 4x headroom: 1.07 GB) fills the sweep's 1 GiB budget, so each
# of the dHCP tree's 2 validation volumes takes a chunk of its own
QUALITY_FIND_BEST_CHUNKS = {"dhcp": 2}
QUALITY_CHECK_ARGV = ["--epochs", "2"]
QUALITY_CPU_RTOL = 1e-4
# the keys JAX's tool writes that its recorded r4 rows predate (its r5
# rows carry them)
JAX_ROW_LATER_KEYS = ("score_noise", "aug_noise", "aug_blur",
                      "max_grad_norm")
ROW_METRICS = ("model", "model_all_slices", "best_conventional",
               "model_extra", "best_conventional_extra")

# phase 19: the measurement commands, each run as a child process on the
# card as a user runs it; every roofline share they print must read at
# most SHARE_LIMIT (a share above it means a wrong FLOP or byte count)
MEASURE_ARGV = {
    "bench": [],
    "infer-roofline": ["--batches", "1", "8", "--split", "--packed"],
    "train-bench": ["--steps", "10"],
    "pipeline-bench": ["--epochs", "3", "--n_patients", "7",
                       "--variants", "0", "1"],
    "loader-bench": [],
}
SHARE_LIMIT = 1.0
# bench's SSIM calls: the self-check and bf16_ssim_delta (bench.py:200-209)
BENCH_SSIM_LAUNCHES = 2


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def phantom(seed: int, s: int = HR_SLICES, h: int = HW,
            w: int = HW) -> np.ndarray:
    """A seeded [s, h, w] head-like phantom in [0, 1]: a bright shell,
    nested ellipsoids of tissue-like intensities and a smooth texture."""
    rng = np.random.RandomState(seed)
    z = np.linspace(-1, 1, s, dtype=np.float32)[:, None, None]
    y = np.linspace(-1, 1, h, dtype=np.float32)[None, :, None]
    x = np.linspace(-1, 1, w, dtype=np.float32)[None, None, :]
    vol = np.zeros((s, h, w), np.float32)

    def ellipsoid(c, r):
        return (((z - c[0]) / r[0]) ** 2 + ((y - c[1]) / r[1]) ** 2
                + ((x - c[2]) / r[2]) ** 2) < 1.0

    vol[ellipsoid((0, 0, 0), (0.95, 0.9, 0.75))] = 0.9
    vol[ellipsoid((0, 0, 0), (0.88, 0.82, 0.68))] = 0.35
    for _ in range(12):
        c = rng.uniform(-0.45, 0.45, 3)
        r = rng.uniform(0.08, 0.35, 3)
        vol[ellipsoid(c, r)] = rng.uniform(0.2, 0.8)
    inside = ellipsoid((0, 0, 0), (0.95, 0.9, 0.75))
    for _ in range(3):
        f = rng.uniform(2, 9, 3)
        ph = rng.uniform(0, 2 * np.pi)
        vol += inside * 0.04 * np.sin(f[0] * z + f[1] * y + f[2] * x + ph)
    return np.clip(vol, 0.0, 1.0).astype(np.float32)


def smooth_pair(shape, gen, dev):
    """A smooth [S, H, W] image in [0, 1] on the device and a noisy copy."""
    import torch
    import torch.nn.functional as F

    a = torch.rand(shape, generator=gen, device=dev)
    for _ in range(3):
        a = F.avg_pool2d(a[:, None], 5, stride=1, padding=2,
                         count_include_pad=False)[:, 0]
    lo = a.amin(dim=(1, 2), keepdim=True)
    hi = a.amax(dim=(1, 2), keepdim=True)
    a = (a - lo) / (hi - lo)
    b = (a + 0.05 * torch.rand(shape, generator=gen, device=dev)).clamp(0, 1)
    return a.contiguous(), b.contiguous()


def cuda_ms(fn, iters: int) -> float:
    """Mean milliseconds per call from CUDA events, after one warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def call_times_s(fn, iters: int) -> list:
    """Per-call seconds (CUDA events around a call that ends in a host
    readback), after one warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / 1e3)
    return times


def cold_ms(fn, iters: int) -> float:
    """Median milliseconds of one call from CUDA events, with a
    ``L2_FLUSH_BYTES`` scratch write before each, so the call finds its
    inputs in device memory and not in L2."""
    import torch

    scratch = torch.empty(L2_FLUSH_BYTES // 4, device="cuda")
    fn()
    times = []
    for i in range(iters):
        scratch.fill_(float(i))
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def ssim_bound(shape, win: int) -> tuple:
    """(bound_ms, bound_by) for per-slice SSIM: inputs read once and the
    [S] output written once over HBM bandwidth, against the float32
    operations of a separable box filter (5 moments x 2 passes x win
    adds, 3 products, ~30 for the map value and its mean per pixel)."""
    s, h, w = shape
    bytes_moved = 2 * s * h * w * 4 + s * 4
    ops = s * (h - win + 1) * (w - win + 1) * (5 * 2 * win + 3 + 30)
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_kernels(dev) -> dict:
    """Phase 2: build the SSIM kernel, check its division by the window
    exhaustively, and hold the kernel against the plain version on the
    card; returns the largest error seen."""
    import torch

    from superresolution_aniso_mri_tpu_torch.ops import _build, cuda_kernels
    from superresolution_aniso_mri_tpu_torch.ops.metrics import ssim_volume

    t0 = time.perf_counter()
    cuda_kernels._ssim_library()
    log(f"build: ssim.cu in {time.perf_counter() - t0:.2f} s")
    for line in _build.build_log("ssim", cuda_kernels._SSIM_FLAGS).splitlines():
        if "ptxas" in line or "nvcc" in line or "spill" in line:
            log(f"  {line.strip()}")
    for win in cuda_kernels.SSIM_WINDOWS:
        bad = cuda_kernels.window_division_mismatches(win, dev)
        log(f"kernel division by {win}: mismatches against IEEE over all "
            f"finite float32 inputs: {bad[0]}")
        if bad[0]:
            raise AssertionError(f"division by {win} differs from IEEE "
                                 f"division, first at bits {bad[1]:#010x}")
    gen = torch.Generator(device=dev).manual_seed(0)
    cases = [(shape, smooth_pair(shape, gen, dev)) for shape in KERNEL_SHAPES]
    cases.append(("phantom", tuple(torch.from_numpy(phantom(i)).to(dev)
                                   for i in (0, 1))))
    worst = 0.0
    for shape, (a, b) in cases:
        for win in cuda_kernels.SSIM_WINDOWS:
            got = cuda_kernels.ssim_volume_cuda(a, b, 1.0, win)
            want = ssim_volume(a, b, 1.0, win)
            again = cuda_kernels.ssim_volume_cuda(a, b, 1.0, win)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            worst = max(worst, err)
            log(f"kernel ssim_slice {shape} win={win}: max_abs_err={err:.3e}"
                f" mean={float(got.mean()):.6f}")
            if not err <= KERNEL_ATOL:
                raise AssertionError(
                    f"SSIM kernel disagrees with the plain version at "
                    f"{shape} win={win}: {err:.3e} > {KERNEL_ATOL}")
            if not torch.equal(got, again):
                raise AssertionError(f"SSIM kernel is not deterministic at "
                                     f"{shape} win={win}")
    return {"max_abs_err": worst}


def check_volume(vol: np.ndarray, what: str) -> None:
    if vol.shape != (HR_SLICES, HW, HW):
        raise AssertionError(f"{what}: shape {vol.shape}, expected "
                             f"{(HR_SLICES, HW, HW)}")
    if not np.isfinite(vol).all():
        raise AssertionError(f"{what}: non-finite values")
    if vol.min() < 0.0 or vol.max() > 1.0:
        raise AssertionError(f"{what}: values outside [0, 1]: "
                             f"[{vol.min()}, {vol.max()}]")


def train_data(seed: int, patch: int, pairs: int, batches: int,
               device) -> list:
    """``batches`` train batches of ``pairs`` pairs from four seeded
    phantoms: TripletSampler(pad 220) → the deterministic augment_batch
    (center crop 220, then ``patch``) → prepare_batch_pairs, on
    ``device``. Returns (raw numpy batches, device batches, aug config)."""
    from superresolution_aniso_mri_tpu_torch.data import (
        AugmentConfig, TripletSampler, Volume, device_batch)

    vols = [Volume(image=phantom(seed + 100 + i),
                   spacing=np.array([1.0, 1.0, 1.0])) for i in range(4)]
    sampler = TripletSampler(vols, TRAIN_DS, "adjacent_plus", pad_size=HW,
                             seed=seed)
    aug = AugmentConfig(patch_size=patch, aug_patch_size=HW,
                        random_crop=False, rot90=False, intensity=False)
    raw = [sampler.sample_batch(pairs) for _ in range(batches)]
    return raw, [device_batch(r, aug, device) for r in raw], aug


def _finite(metrics: dict, what: str) -> None:
    vals = {k: np.asarray(v) for k, v in metrics.items()}
    bad = [k for k, v in vals.items() if not np.isfinite(v).all()]
    if bad:
        raise AssertionError(f"{what}: non-finite metrics {bad}")


def check_train(dev, seed: int, hr: np.ndarray, serve_kw: dict, card: str,
                profile_path) -> dict:
    """Phase 5 (see the module docstring); returns the train path's SSIM
    launches and the train timings."""
    import tempfile

    import torch

    from superresolution_aniso_mri_tpu_torch.evaluate import (
        compute_volume_metrics)
    from superresolution_aniso_mri_tpu_torch.infer import (
        ServingModel, create_super_volume)
    from superresolution_aniso_mri_tpu_torch.models import (
        AEConfig, VanillaACAI, flax_to_torch)
    from superresolution_aniso_mri_tpu_torch.ops import cuda_kernels
    from superresolution_aniso_mri_tpu_torch.train import (
        Trainer, create_train_state, load_checkpoint_raw,
        loss_config_from_args, make_train_step)
    from superresolution_aniso_mri_tpu_torch.data import device_batch

    t0 = time.perf_counter()
    pairs = TRAIN_ARGS["batch_size"]
    raw, batches, aug = train_data(seed, TRAIN_PATCH, pairs, 3, dev)
    b = batches[0]
    log(f"train: data {time.perf_counter() - t0:.1f} s; image "
        f"{list(b['image'].shape)}, slice_between "
        f"{list(b['slice_between'].shape)}")
    cfg = AEConfig(**BENCH_CFG, compute_dtype="float32")
    loss_cfg = loss_config_from_args(TRAIN_ARGS)
    step = make_train_step(loss_cfg)
    mix = TRAIN_ARGS["ex_loss_weight1"]

    def fresh_state(config, device, gen_seed):
        model = VanillaACAI(config)
        model.reset_parameters(torch.Generator().manual_seed(gen_seed))
        return create_train_state(model.to(device), TRAIN_ARGS["lr"])

    # it learns: 30 steps on one repeated batch
    state = fresh_state(cfg, dev, seed)
    seen = []
    for _ in range(TRAIN_LEARN_STEPS):
        state, m = step(state, b, mix)
        seen.append(m)
    stacked = {k: torch.stack([m[k] for m in seen]).cpu().numpy()
               for k in seen[0]}
    _finite(stacked, "train")
    first, last = float(stacked["loss_ae"][0]), float(stacked["loss_ae"][-1])
    log(f"train: {TRAIN_LEARN_STEPS} steps on one batch, loss_ae "
        f"{first:.6f} → {last:.6f}, metrics {sorted(stacked)}")
    if not last < first:
        raise AssertionError(f"training did not lower loss_ae: {first} → "
                             f"{last}")

    # card against CPU: 5 steps of a small config from the same weights
    small = AEConfig(**SMALL_CFG)
    _, small_batches, _ = train_data(seed + 1, SMALL_CFG["width"], 4, 5, dev)
    card_state = fresh_state(small, dev, seed + 1)
    cpu_state = fresh_state(small, "cpu", seed + 1)
    worst_loss = 0.0
    for sb in small_batches:
        card_state, cm = step(card_state, sb, mix)
        cpu_state, hm = step(cpu_state, {k: v.cpu() for k, v in sb.items()},
                             mix)
        for k in hm:
            rel = abs(float(cm[k]) - float(hm[k])) / max(abs(float(hm[k])),
                                                         1e-12)
            worst_loss = max(worst_loss, rel)
    drift = max(float((p.detach().cpu() - q.detach()).abs().max())
                for p, q in zip(card_state.model.parameters(),
                                cpu_state.model.parameters()))
    bound = 2 * TRAIN_ARGS["lr"] * len(small_batches)
    log(f"train: card vs CPU, {len(small_batches)} steps of {SMALL_CFG}: "
        f"max rel loss diff {worst_loss:.3e} (limit 1e-4), max param diff "
        f"{drift:.3e} (limit 2·lr·steps = {bound:.1e})")
    if not worst_loss <= 1e-4 or not drift <= bound:
        raise AssertionError("card and CPU training differ")

    # a 2-epoch Trainer run into an experiment directory
    with tempfile.TemporaryDirectory() as out:
        trainer = Trainer(dict(TRAIN_ARGS, epochs=2, epoch_threshold=0,
                               output_dir=out, seed=seed), device=dev)
        trainer.prepare_run()
        for _ in range(2):
            for tb in batches[:2]:
                trainer.train(tb)
            trainer.validate(batches[2])
            trainer.show_loss_on_tensorboard("train")
            trainer.show_loss_on_tensorboard("test")
            trainer.reset_losses()
            trainer.end_epoch_processing()
        models = sorted(os.listdir(os.path.join(out, "models")))
        files = sorted(f for f in os.listdir(out) if f.endswith(".npz"))
        log(f"train: Trainer wrote models/{models} and {files}")
        want = ["1.models", "ae.models", "caisr.models", "last.models"]
        if models != want or files != ["loss_iters.npz", "losses_test.npz",
                                       "losses_train.npz"]:
            raise AssertionError(f"Trainer files: {models} {files}")
        again = Trainer(dict(TRAIN_ARGS, output_dir=out), device=dev,
                        seed=seed + 7)
        again.load(os.path.join(out, "models", "last.models"))
        same = all(torch.equal(again.model.state_dict()[k], v)
                   for k, v in trainer.model.state_dict().items())
        log(f"train: last.models reloads to the same tensors: {same}; "
            f"epoch {again.epoch}")
        if not same or again.epoch != 2:
            raise AssertionError("last.models does not reload")
        raw_ckpt = load_checkpoint_raw(os.path.join(out, "models",
                                                    "caisr.models"))

    # the trained checkpoint through the port's serve → score path
    served = ServingModel(cfg, flax_to_torch(raw_ckpt["model_dict_ae"],
                                             raw_ckpt["batch_stats"], cfg),
                          device=dev)
    cuda_kernels.reset_launch_counts()
    res = create_super_volume(served, hr, **serve_kw)
    scores = compute_volume_metrics(hr, res["upsampled_image"],
                                    downsample_steps=DS, device=dev)
    launches = dict(cuda_kernels.LAUNCHES)
    check_volume(res["upsampled_image"], "serve trained checkpoint")
    _finite(scores, "scores of the trained checkpoint")
    log(f"train → serve → score launches: {json.dumps(launches)}; scores "
        + json.dumps({k: round(v, 6) for k, v in scores.items()}))
    if launches["ssim_slice"] < 1:
        raise AssertionError("the SSIM kernel was not launched on the "
                             "train → serve → score path")

    # timings: upload + augment + split + step, CUDA events
    timed = fresh_state(cfg, dev, seed)

    def one_step():
        step(timed, device_batch(raw[0], aug, dev), mix)

    for _ in range(3):
        one_step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times, host = [], []
    for _ in range(20):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        t_host = time.perf_counter()
        one_step()
        host.append((time.perf_counter() - t_host) * 1e3)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    ms = float(np.median(times))
    # host_ms: the host's time to issue one step (its upload waits for
    # the copy); near ms, the host sets the pace, not the card
    out = {"train_ms_per_step": ms, "train_ms_min": float(np.min(times)),
           "train_host_ms_per_step": float(np.median(host)),
           "train_steps_per_s": 1e3 / ms,
           "train_peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
           "train_pairs_per_step": pairs, "launches": launches}
    log(f"train timings [{card}]: " + json.dumps(
        {k: v for k, v in out.items() if k != "launches"}))
    if profile_path:
        profile_train_step(one_step, ms, profile_path)
    return out


def _cli_train_argv(out: str, exper_id: str, cfg: dict, epochs: int,
                    extra=()) -> list:
    """train-brain argv: the MNIST3D quick start at ``cfg``'s widths."""
    return ["-d", "MNIST3D", "--use_synthetic_data", "-m", "ae_combined",
            "--image_mix_loss_func", "mse", "--epoch_threshold", "-1",
            "-e", str(epochs), "-o", out, "-id", exper_id,
            "--width", str(cfg["width"]),
            "--latent_width", str(cfg["latent_width"]),
            "--depth", str(cfg["depth"]), "--latent", str(cfg["latent"]),
            *extra]


def check_cli(seed: int, card: str) -> dict:
    """Phase 7 (see the module docstring): the port's CLIs in-process on
    the card, in a temp dir; returns the SSIM launches of the find-best
    paths and the CLI timings."""
    import tempfile

    import torch

    from superresolution_aniso_mri_tpu_torch.cli import entry
    from superresolution_aniso_mri_tpu_torch.config import load_settings
    from superresolution_aniso_mri_tpu_torch.infer import create_super_volumes
    from superresolution_aniso_mri_tpu_torch.ops import cuda_kernels
    from superresolution_aniso_mri_tpu_torch.train import get_trainer
    from superresolution_aniso_mri_tpu_torch.utils import (read_image,
                                                           write_image)

    out: dict = {}
    with tempfile.TemporaryDirectory() as tmp:
        # 1. train: the quick start at the bench model's full width
        t0 = time.time()
        trainer = entry.train_brain(_cli_train_argv(
            tmp, "mnist3d", BENCH_CFG, CLI_EPOCHS,
            ("--downsample_steps", str(DS), "-b", "16")))
        t_end = time.time()
        exper = os.path.join(tmp, "mnist3d")
        models = sorted(os.listdir(os.path.join(exper, "models")))
        files = sorted(os.listdir(exper))
        pngs = sorted(os.listdir(os.path.join(exper, "log_images")))
        log(f"cli train: {files}, models/{models}, log_images/{pngs}")
        if models != ["0.models", "1.models", "ae.models", "caisr.models",
                      "last.models"] or not pngs or not {
                "settings.yaml", "loss_iters.npz", "losses_train.npz",
                "losses_test.npz"} <= set(files):
            raise AssertionError("train-brain did not write the experiment "
                                 "files")
        written = {k: v for k, v in trainer.args.items()
                   if not k.startswith("_")}
        if load_settings(os.path.join(exper, "settings.yaml")) != written:
            raise AssertionError("settings.yaml does not read back as the "
                                 "Trainer's args")
        # numbered checkpoints are written at the end of their epoch: the
        # gap between them is one whole epoch (train, validation, image
        # dump, volume preview, checkpoints)
        ends = [os.stat(os.path.join(exper, "models", f"{e}.models"))
                .st_mtime_ns / 1e9 for e in range(CLI_EPOCHS)]
        out["train_s_per_epoch"] = ends[1] - ends[0]
        out["train_first_epoch_s"] = ends[0] - t0
        out["train_cli_s"] = t_end - t0
        out["train_steps_per_epoch"] = trainer.iters // CLI_EPOCHS
        loss = np.load(os.path.join(exper, "losses_train.npz"))["loss_ae"]
        log(f"cli train: loss_ae by epoch {loss.tolist()}; "
            f"{out['train_steps_per_epoch']} steps an epoch; s/epoch "
            f"{out['train_s_per_epoch']:.3f} (first epoch, set-up included: "
            f"{out['train_first_epoch_s']:.3f})")
        if not np.isfinite(loss).all():
            raise AssertionError("train-brain losses are not finite")

        # 2. generate: the OASIS-shaped phantom's kept slices, 6 mm → 1 mm
        inputs = os.path.join(tmp, "inputs")
        os.makedirs(inputs)
        kept = phantom(seed)[::DS]
        in_path = os.path.join(inputs, "oasis0.nii.gz")
        write_image(in_path, kept, spacing=(float(DS), 1.0, 1.0))
        gen_out = os.path.join(tmp, "generated")
        argv = ["--exper_dir", exper, "--model_nbr", "caisr",
                "--num_interpolations", str(DS - 1), "--data_input_dir",
                inputs, "--output_dir", gen_out]
        entry.generate_hr_volumes(argv)                  # warm-up
        t0 = time.perf_counter()
        entry.generate_hr_volumes(argv)
        out["generate_cli_s_per_volume"] = time.perf_counter() - t0
        res_path = os.path.join(gen_out, f"oasis0_ni{DS - 1:02d}.nii.gz")
        vol, spacing, affine = read_image(res_path)
        check_volume(vol, "generate-hr-volumes")
        if not (np.allclose(spacing, [1.0, 1.0, 1.0])
                and np.allclose(affine[:3, 2], [0.0, 0.0, 1.0])):
            raise AssertionError(f"generate-hr-volumes geometry: spacing "
                                 f"{spacing}, affine z column "
                                 f"{affine[:3, 2]}")
        # the same three steps outside the CLI, on the same arrays
        served = get_trainer(exper, "caisr")
        t0 = time.perf_counter()
        arr, _, _ = read_image(in_path)
        out["generate_read_s"] = time.perf_counter() - t0
        alphas = np.linspace(0, 1, DS + 1)[1:-1]
        synth = dict(alpha_range=alphas, use_original=True,
                     downsample_steps=None, generate_inbetween_slices=False)
        create_super_volumes(served, [arr], **synth)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        again = create_super_volumes(served, [arr], **synth)[0]
        out["generate_synthesis_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        write_image(os.path.join(tmp, "timed.nii.gz"), vol,
                    spacing=spacing, affine=affine)
        out["generate_write_s"] = time.perf_counter() - t0
        same = float(np.abs(again["upsampled_image"] - vol).max())
        log(f"cli generate: {os.path.basename(res_path)} {vol.shape}, "
            f"z-spacing {spacing[0]}, {os.path.getsize(res_path)} bytes; "
            f"synthesis outside the CLI differs by {same:.3e}")
        if not same <= 1e-6:
            raise AssertionError("generate-hr-volumes differs from the "
                                 "synthesis it runs")

        # 3. find best: every checkpoint scored, plain and batched
        sweeps = {}
        for name, extra in (("plain", []), ("batched", ["--batched"])):
            cuda_kernels.reset_launch_counts()
            t0 = time.perf_counter()
            res = entry.find_best_model(["--exper_dir", exper,
                                         "--use_synthetic_data",
                                         "--downsample_steps", str(DS)]
                                        + extra)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            out[f"find_best_{name}_launches"] = cuda_kernels.LAUNCHES[
                "ssim_slice"]
            out[f"find_best_{name}_s_per_checkpoint"] = dt / len(
                res["epochs"])
            sweeps[name] = res["history"]
        log(f"cli find-best: SSIM launches plain "
            f"{out['find_best_plain_launches']} (expected {2 * CLI_EPOCHS}), "
            f"batched {out['find_best_batched_launches']} (expected "
            f"{CLI_EPOCHS}); per-epoch SSIM plain {sweeps['plain']['ssim']}, "
            f"batched {sweeps['batched']['ssim']}")
        if (out["find_best_plain_launches"] != 2 * CLI_EPOCHS
                or out["find_best_batched_launches"] != CLI_EPOCHS):
            raise AssertionError("find-best-model did not score every "
                                 "checkpoint through the SSIM kernel")
        sweep_err = max(abs(a - b) for k in sweeps["plain"]
                        for a, b in zip(sweeps["plain"][k],
                                        sweeps["batched"][k])
                        if np.isfinite(a) or np.isfinite(b))
        log(f"cli find-best: plain vs batched max |diff| {sweep_err:.3e} "
            f"(limit {SWEEP_ATOL})")
        if not sweep_err <= SWEEP_ATOL:
            raise AssertionError("plain and batched sweeps disagree")

        # 4. serve: a watch dir of two volumes, drained once
        watch = os.path.join(tmp, "watch")
        os.makedirs(watch)
        for i in (1, 2):
            write_image(os.path.join(watch, f"oasis{i}.nii.gz"),
                        phantom(seed + i)[::DS], spacing=(float(DS), 1.0, 1.0))
        manifest = os.path.join(tmp, "manifest.jsonl")
        n_served = entry.serve_hr_volumes([
            "--exper_dir", exper, "--watch_dir", watch, "--output_dir",
            os.path.join(tmp, "served"), "--once", "--latent_interp",
            "lanczos3", "--num_interpolations", str(DS - 1),
            "--manifest", manifest])
        with open(manifest) as f:
            lines = [json.loads(line) for line in f]
        out["serve_cli_s_per_volume"] = [r["seconds"] for r in lines]
        for r in lines:
            check_volume(read_image(r["outputs"][0])[0], "serve-hr-volumes")
        log(f"cli serve: {n_served} volumes, manifest {len(lines)} lines, "
            f"s/volume {out['serve_cli_s_per_volume']}")
        if n_served != 2 or len(lines) != 2:
            raise AssertionError("serve-hr-volumes did not serve both "
                                 "volumes")

        # 5. card against CPU: a small experiment trained on the card
        entry.train_brain(_cli_train_argv(
            tmp, "small", SMALL_CFG, 1, ("--downsample_steps", "2",
                                         "--limited_load", "-b", "8")))
        crop_dir = os.path.join(tmp, "crop")
        os.makedirs(crop_dir)
        write_image(os.path.join(crop_dir, "crop.nii.gz"),
                    kept[:, 60:124, 70:134].copy(),
                    spacing=(float(DS), 1.0, 1.0))
        vols = {}
        for dev_name in ("cuda", "cpu"):
            o = os.path.join(tmp, f"small_{dev_name}")
            entry.generate_hr_volumes(
                ["--exper_dir", os.path.join(tmp, "small"),
                 "--num_interpolations", str(DS - 1), "--data_input_dir",
                 crop_dir, "--output_dir", o],
                device=dev_name)
            vols[dev_name] = read_image(os.path.join(
                o, f"crop_ni{DS - 1:02d}.nii.gz"))[0]
        card_cpu = float(np.abs(vols["cuda"] - vols["cpu"]).max())
        log(f"cli generate card vs CPU, {SMALL_CFG}: max_abs_diff "
            f"{card_cpu:.3e} (limit 1e-4)")
        if not card_cpu <= 1e-4:
            raise AssertionError("card and CPU generate-hr-volumes differ")
    log(f"cli timings [{card}]: " + json.dumps(out))
    return out


def _write_volumes(jobs) -> None:
    """Write (path, array, spacing) NIfTI files on a thread pool (gzip
    releases the interpreter lock)."""
    from concurrent.futures import ThreadPoolExecutor

    from superresolution_aniso_mri_tpu_torch.utils import write_image

    def one(job):
        os.makedirs(os.path.dirname(job[0]), exist_ok=True)
        write_image(job[0], job[1], spacing=job[2])

    with ThreadPoolExecutor(max_workers=len(jobs)) as pool:
        list(pool.map(one, jobs))


def make_disk_trees(root: str, seed: int) -> dict:
    """Phase 8's dataset trees under ``root`` (``$SR_DATA_ROOT``), in the
    real layouts, with the port's own writers: OASIS (OASIS-1's T88 grid,
    thick-slice LR files) and ACDC (4D cines). Returns the patient ids."""
    from superresolution_aniso_mri_tpu_torch.config import save_string_lists
    from superresolution_aniso_mri_tpu_torch.data import simulate_thick_slices
    from superresolution_aniso_mri_tpu_torch.data.datasets import (
        create_split_file)

    oasis = [f"OAS1_{i + 1:04d}_MR1" for i in range(OASIS_PATIENTS)]
    jobs = []
    for i, pid in enumerate(oasis):
        lr = simulate_thick_slices(phantom(seed + 200 + i, *OASIS_SHAPE),
                                   float(OASIS_DS))
        jobs.append((os.path.join(root, "OASIS", "nifti", pid,
                                  f"{pid}_t88_gfc_{OASIS_DS}mm.nii.gz"),
                     lr, (1.0, 1.0, 1.0)))
    acdc = [f"patient{i + 1:03d}" for i in range(ACDC_PATIENTS)]
    frames, slices, h, w = ACDC_SHAPE
    for i, pid in enumerate(acdc):
        cine = np.stack([phantom(seed + 300 + 20 * i + t, slices, h, w)
                         for t in range(frames)]) * 400.0
        jobs.append((os.path.join(root, "ACDC", "all_cardiac_phases", pid,
                                  f"{pid}_4d.nii.gz"), cine, ACDC_SPACING))
    _write_volumes(jobs)
    # 3 training, 1 test, 1 validation patient (the JAX package's writer
    # and shuffle)
    create_split_file(os.path.join(root, "OASIS"), oasis, (3, 1, 1))
    save_string_lists({"training": acdc[:2], "validation": acdc[2:],
                       "test": []},
                      os.path.join(root, "ACDC",
                                   "train_val_test_split_sr.yaml"))
    return {"oasis": oasis, "acdc": acdc}


def _train_timed(fn, argv, exper: str) -> dict:
    """Run a train command with a CUDA event recorded before every train
    step and every ``train_many`` dispatch; returns s/epoch (the gap
    between the numbered checkpoints), ms/step (median of the gaps
    between consecutive events of one epoch over the steps the earlier
    one ran, the first event of the run left out: with
    ``--steps_per_dispatch`` it carries the warm-up steps and the
    capture), each step's loss_ae, which random draws the augmentation
    made, and which samplers the loop used."""
    import torch

    from superresolution_aniso_mri_tpu_torch.cli import train_loop
    from superresolution_aniso_mri_tpu_torch.data import transforms
    from superresolution_aniso_mri_tpu_torch.train import trainer as trainer_mod

    events, drawn, samplers, step_loss = [], set(), [], []
    cls = trainer_mod.Trainer
    train, train_many = cls.train, cls.train_many
    draw = transforms.draw_augment_params
    cache = train_loop.maybe_device_cache

    def recorded(self, n):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events.append((self.epoch, ev, n))

    def timed_train(self, batch):
        recorded(self, 1)
        metrics = train(self, batch)
        step_loss.append(metrics["loss_ae"].reshape(1))
        return metrics

    def timed_train_many(self, batches):
        recorded(self, len(batches))
        metrics = train_many(self, batches)
        step_loss.append(metrics["loss_ae"])
        return metrics

    def recorded_draw(*a, **kw):
        params = draw(*a, **kw)
        drawn.update(k for k, v in vars(params).items() if v is not None)
        return params

    def recorded_cache(*a, **kw):
        out = cache(*a, **kw)
        samplers.append(type(out).__name__)
        return out

    cls.train, cls.train_many = timed_train, timed_train_many
    transforms.draw_augment_params = recorded_draw
    train_loop.maybe_device_cache = recorded_cache
    t0 = time.time()
    try:
        trainer = fn(argv)
    finally:
        cls.train, cls.train_many = train, train_many
        transforms.draw_augment_params = draw
        train_loop.maybe_device_cache = cache
    wall = time.time() - t0
    torch.cuda.synchronize()
    gaps = [a[1].elapsed_time(b[1]) / a[2]
            for a, b in zip(events[1:], events[2:]) if a[0] == b[0]]
    epochs = sorted(int(f.split(".")[0]) for f in os.listdir(
        os.path.join(exper, "models")) if f.split(".")[0].isdigit())
    ends = [os.stat(os.path.join(exper, "models", f"{e}.models"))
            .st_mtime_ns / 1e9 for e in epochs]
    loss = np.load(os.path.join(exper, "losses_train.npz"))["loss_ae"]
    if not np.isfinite(loss).all():
        raise AssertionError(f"{exper}: losses are not finite: {loss}")
    return {"s_per_epoch": (ends[-1] - ends[0]) / max(len(ends) - 1, 1)
            if len(ends) > 1 else None,
            "cli_s": wall, "steps": sum(e[2] for e in events),
            "dispatches": len(events),
            "ms_per_step": float(np.median(gaps)),
            "ms_per_step_min": float(np.min(gaps)),
            "drawn": sorted(drawn), "samplers": samplers,
            "loss_ae": loss.tolist(), "trainer": trainer,
            "step_loss_ae": torch.cat(step_loss).cpu().tolist()}


def augment_timings(dev, gen_seed: int, card: str) -> dict:
    """Phase 8's augmentation on the card: ms per batch of
    ``augment_batch`` (draws included) for four recipes, CUDA events; and
    ``apply_augment`` on the card against the CPU for the same draws
    (every op but noise)."""
    import torch

    from superresolution_aniso_mri_tpu_torch.cli.train_loop import (
        build_augment_config)
    from superresolution_aniso_mri_tpu_torch.data import (
        apply_augment, augment_batch, draw_augment_params)

    oasis = build_augment_config(dict(dataset="OASIS", width=64,
                                      aug_patch_size=220))
    every = dataclasses.replace(oasis, rotate_any=True, max_degree=359,
                                elastic=True, perspective=True, blur=True,
                                mirror=True, noise=True)
    recipes = {
        "oasis": (oasis, (16, 3, 220, 220)),
        "dhcp_noise": (build_augment_config(dict(
            dataset="dHCP", width=128, aug_patch_size=256, aug_noise=True)),
            (12, 7, 256, 256)),
        "acdc_lanczos3": (build_augment_config(dict(
            dataset="ACDC", width=128, aug_patch_size=180)),
            (12, 7, 180, 180)),
        "every_op": (every, (16, 3, 220, 220)),
    }
    gen = torch.Generator(device=dev).manual_seed(gen_seed)
    out: dict = {}
    for name, (cfg, shape) in recipes.items():
        x = torch.rand(shape, generator=gen, device=dev)
        draws = torch.Generator().manual_seed(gen_seed)
        y = augment_batch(x, cfg, draws)
        if y.shape != (shape[0], shape[1], cfg.patch_size, cfg.patch_size) \
                or not bool(torch.isfinite(y).all()):
            raise AssertionError(f"augment {name}: {tuple(y.shape)}")
        out[f"augment_{name}_ms"] = cuda_ms(
            lambda: augment_batch(x, cfg, draws), 20)
    no_noise = dataclasses.replace(every, noise=False)
    x = torch.rand(16, 3, 220, 220, generator=gen, device=dev)
    params = draw_augment_params(torch.Generator().manual_seed(gen_seed),
                                 no_noise, 16, 220, 220)
    got = apply_augment(x, params, no_noise)
    want = apply_augment(x.cpu(), params, no_noise)
    out["augment_card_vs_cpu"] = float((got.cpu() - want).abs().max())
    log(f"augment timings [{card}]: " + json.dumps(out))
    if not out["augment_card_vs_cpu"] <= AUG_ATOL:
        raise AssertionError(f"apply_augment on the card differs from the "
                             f"CPU: {out['augment_card_vs_cpu']}")
    return out


def _recipe_batches(trainer, dev, epoch: int = 0):
    """Device batches of ``trainer``'s recipe as ``run_training`` makes
    them (device slice cache, the random recipe, each batch made on the
    training thread), from epoch ``epoch``'s augmentation stream on, one
    epoch after another."""
    from superresolution_aniso_mri_tpu_torch.cli.train_loop import (
        build_augment_config, epoch_generator)
    from superresolution_aniso_mri_tpu_torch.data import (
        TripletSampler, device_batch, maybe_device_cache)
    from superresolution_aniso_mri_tpu_torch.data.datasets import (
        get_datasets)

    args = trainer.args
    masks = bool(args.get("get_masks"))
    sampler = maybe_device_cache(TripletSampler(
        get_datasets(args)[0], int(args["downsample_steps"]),
        args["slice_selection"],
        pad_size=int(args.get("aug_patch_size") or args["width"]),
        seed=int(args["seed"]), use_masks=masks), "1", dev)
    aug = build_augment_config(args)

    def stream():
        for e in itertools.count(epoch):
            gen = epoch_generator(int(args["seed"]), e)
            for raw in sampler.epoch_batches(int(args["batch_size"])):
                yield device_batch(raw, aug, dev, 2, generator=gen,
                                   with_mask=masks)

    return stream()


def profile_disk_steps(trainer, dev, path: str, steps: int = 10,
                       spd: int = 1) -> None:
    """Trace ``steps`` steps of ``trainer``'s recipe (``_recipe_batches``)
    after 5 untraced ones, in dispatches of ``spd`` through
    ``train_many`` when ``spd > 1``: device ms a step by kernel kind and
    the idle share of the traced wall. The table goes to ``path``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    batches = _recipe_batches(trainer, dev)

    def run(n):
        if spd <= 1:
            for _ in range(n):
                trainer.train(next(batches))
        else:
            for _ in range(n // spd):
                trainer.train_many([next(batches) for _ in range(spd)])

    run(5 if spd <= 1 else spd)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run(steps)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    events = prof.key_averages()
    attr = ("self_device_time_total"
            if hasattr(events[0], "self_device_time_total")
            else "self_cuda_time_total")
    kinds: dict = {}
    for e in events:
        if e.device_type == torch.autograd.DeviceType.CUDA \
                and e.key != "Activity Buffer Request":
            kind = _kernel_kind(e.key)
            kinds[kind] = kinds.get(kind, 0.0) + getattr(e, attr) / 1e3 / steps
    busy = sum(kinds.values())
    table = events.table(sort_by=attr, row_limit=40)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        f.write(table)
    log(f"profile {os.path.basename(path)}: device ms a train step by "
        f"kernel kind "
        + json.dumps({k: round(v, 4) for k, v in sorted(kinds.items())})
        + f"; busy {busy:.4f} ms of a traced {wall_ms:.4f} ms step, idle "
        f"share {1 - busy / wall_ms:.3f}")


@contextlib.contextmanager
def disk_trees(seed: int):
    """Phase 8's dataset trees in a temp dir, with ``$SR_DATA_ROOT``
    pointing at them while the block runs; yields (the temp dir, the
    seconds it took to write them). Phases 8 and 9 train from them."""
    import tempfile

    old_root = os.environ.get("SR_DATA_ROOT")
    with tempfile.TemporaryDirectory() as tmp:
        root = os.path.join(tmp, "data")
        os.environ["SR_DATA_ROOT"] = root
        try:
            t0 = time.perf_counter()
            ids = make_disk_trees(root, seed)
            fabricate_s = time.perf_counter() - t0
            log(f"disk: OASIS {len(ids['oasis'])} x {OASIS_SHAPE}, ACDC "
                f"{len(ids['acdc'])} x {ACDC_SHAPE} written in "
                f"{fabricate_s:.1f} s")
            yield tmp, fabricate_s
        finally:
            if old_root is None:
                os.environ.pop("SR_DATA_ROOT", None)
            else:
                os.environ["SR_DATA_ROOT"] = old_root


def _kept_ssim_pairs():
    """Stand in for the SSIM kernel's wrapper with one that keeps every
    pair it scores (and its result); returns (the list, a function that
    puts the wrapper back)."""
    from superresolution_aniso_mri_tpu_torch.ops import cuda_kernels

    scored, kernel = [], cuda_kernels.ssim_volume_cuda

    def kept_kernel(ref, dist, data_range=1.0, win_size=7):
        got = kernel(ref, dist, data_range, win_size)
        scored.append((ref.clone(), dist.clone(), data_range, win_size,
                       got.clone()))
        return got

    cuda_kernels.ssim_volume_cuda = kept_kernel

    def restore():
        cuda_kernels.ssim_volume_cuda = kernel

    return scored, restore


def check_kept_pairs(scored, what: str) -> float:
    """Hold the SSIM kernel against the plain version (and itself) on
    the pairs a path scored; returns the largest error."""
    import torch

    from superresolution_aniso_mri_tpu_torch.ops import cuda_kernels
    from superresolution_aniso_mri_tpu_torch.ops.metrics import ssim_volume

    worst = 0.0
    for ref, dist, data_range, win, got in scored:
        want = ssim_volume(ref, dist, data_range, win)
        again = cuda_kernels.ssim_volume_cuda(ref, dist, data_range, win)
        err = float((got - want).abs().max())
        worst = max(worst, err)
        log(f"kernel ssim_slice {tuple(ref.shape)} win={win} ({what}): "
            f"max_abs_err={err:.3e}")
        if not err <= KERNEL_ATOL or not torch.equal(got, again):
            raise AssertionError(
                f"SSIM kernel disagrees with the plain version on {what}'s "
                f"pair {tuple(ref.shape)}: {err:.3e}")
    return worst


def check_disk_recipes(tmp: str, seed: int, card: str, dev,
                       profile_path=None) -> dict:
    """Phase 8 (see the module docstring): the README's production
    recipes from the on-disk trees in ``tmp`` on the card; returns the
    SSIM launches of find-best and the phase's timings."""
    import torch

    from superresolution_aniso_mri_tpu_torch.cli import entry
    from superresolution_aniso_mri_tpu_torch.data import device_cache
    from superresolution_aniso_mri_tpu_torch.ops import cuda_kernels

    out: dict = {}
    # the auto cache budget on this card, against the README
    # OASIS recipe's 200 training patients
    budget = device_cache.auto_budget_bytes(dev)
    recipe = 200 * OASIS_SHAPE[0] * 220 * 220 * 4
    out["cache_auto_budget_mb"] = budget / 2 ** 20
    log(f"disk: auto cache budget {budget / 2**20:.0f} MB; the "
        f"README OASIS recipe's 200 training patients need "
        f"{recipe / 2**20:.0f} MB → cache "
        f"{'on' if recipe <= budget else 'off'}")
    if recipe > budget:
        raise AssertionError("the auto budget leaves the README "
                             "OASIS recipe uncached on this card")

    # 1. train-brain -d OASIS (train_brain_aesr.py:8-10, MSE)
    # with the device slice cache and without it, each twice
    for name, mode in (("cache", "auto"), ("nocache", "0"),
                       ("nocache2", "0"), ("cache2", "auto")):
        exper = os.path.join(tmp, f"oasis_{name}")
        res = _train_timed(entry.train_brain, OASIS_ARGV + [
            "-o", tmp, "-id", f"oasis_{name}",
            "--device_data_cache", mode], exper)
        want = ("DeviceCachedSampler" if mode == "auto"
                else "TripletSampler")
        log(f"disk train-brain OASIS ({name}): "
            + json.dumps({k: v for k, v in res.items()
                          if k not in ("trainer", "step_loss_ae")}))
        if res["samplers"] != [want, want]:
            raise AssertionError(f"samplers {res['samplers']}, "
                                 f"expected {want}")
        if not {"crop_top", "rot90_k", "gain"} <= set(res["drawn"]):
            raise AssertionError(f"random recipe not drawn: "
                                 f"{res['drawn']}")
        for k in ("s_per_epoch", "ms_per_step", "ms_per_step_min",
                  "cli_s", "steps"):
            out[f"oasis_{name}_{k}"] = res[k]
        if profile_path and name == "cache":
            profile_disk_steps(res["trainer"], dev,
                               profile_path + ".disk.txt")
    exper = os.path.join(tmp, "oasis_cache")

    # 2. find-best-model on the validation patient, SSIM counted;
    # the pairs it scores are kept for the check below
    scored, restore = _kept_ssim_pairs()
    try:
        cuda_kernels.reset_launch_counts()
        t0 = time.perf_counter()
        best = entry.find_best_model(["--exper_dir", exper])
        torch.cuda.synchronize()
        out["find_best_s_per_checkpoint"] = (
            (time.perf_counter() - t0) / len(best["epochs"]))
        out["find_best_launches"] = \
            cuda_kernels.LAUNCHES["ssim_slice"]
    finally:
        restore()
    # the kernel against the plain version on those exact pairs
    if len(scored) != out["find_best_launches"]:
        raise AssertionError(f"{len(scored)} pairs kept for "
                             f"{out['find_best_launches']} launches")
    out["find_best_kernel_err"] = check_kept_pairs(
        scored, "OASIS find-best")
    log(f"disk find-best OASIS: epochs {best['epochs']}, SSIM "
        f"{best['history']['ssim']}, launches "
        f"{out['find_best_launches']} (expected "
        f"{len(best['epochs'])}), "
        f"{out['find_best_s_per_checkpoint']:.3f} s/checkpoint")
    if best["epochs"] != [0, 1] or out["find_best_launches"] != 2 \
            or not np.isfinite(best["history"]["ssim"]).all():
        raise AssertionError("find-best-model did not score both "
                             "checkpoints through the SSIM kernel")

    # 3. train-cardiac -d ACDC, lanczos3 (README cardiac row, MSE)
    exper = os.path.join(tmp, "acdc")
    t0 = time.time()
    trainer = entry.train_cardiac(ACDC_ARGV + ["-o", tmp, "-id",
                                               "acdc"])
    out["acdc_cli_s"] = time.time() - t0
    out["acdc_steps"] = trainer.iters - 1
    loss = np.load(os.path.join(exper, "losses_train.npz"))
    models = sorted(os.listdir(os.path.join(exper, "models")))
    log(f"disk train-cardiac ACDC lanczos3: {out['acdc_steps']} "
        f"steps, loss_ae {loss['loss_ae'].tolist()}, models "
        f"{models}, {out['acdc_cli_s']:.1f} s")
    if models != ["last.models"] or not np.isfinite(
            loss["loss_ae"]).all() or out["acdc_steps"] < 1:
        raise AssertionError("train-cardiac ACDC did not train")

    # 4. the augmentation alone, and card against CPU
    out.update(augment_timings(dev, seed, card))
    log(f"disk timings [{card}]: " + json.dumps(out))
    return out


def _without_mix_loss(argv: list) -> list:
    """``argv`` without its ``--image_mix_loss_func`` pair, so the
    combined model trains its default (perceptual) mix loss."""
    i = argv.index("--image_mix_loss_func")
    return argv[:i] + argv[i + 2:]


def _with_epochs(argv: list, epochs: int) -> list:
    i = argv.index("-e")
    return argv[:i + 1] + [str(epochs)] + argv[i + 2:]


def lpips_bound(shape) -> tuple:
    """(bound_ms, bound_by) of per-slice LPIPS of an [S, H, W] pair: the
    float32 operations of the two VGG16 stacks (2 per multiply-add of
    each 3x3 conv) at the float32 peak, against the pair read once and
    [S] written once at the memory rate. No hand-written kernel runs
    here: cuDNN float32 convolutions with TF32 off."""
    from superresolution_aniso_mri_tpu_torch.ops.lpips import _VGG_PLAN

    s, h, w = shape
    ops, cin = 0, 3
    for cout, pool_before in _VGG_PLAN:
        if pool_before:
            h, w = h // 2, w // 2
        ops += 2 * 9 * cin * cout * h * w
        cin = cout
    t_ops = 2 * s * ops / F32_FLOPS_PER_S * 1e3
    t_bytes = (2 * s * shape[1] * shape[2] * 4 + s * 4) / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def check_perceptual(tmp: str, seed: int, card: str, dev, mse_ms: float,
                     profile_path=None) -> dict:
    """Phase 9 (see the module docstring): the perceptual and SSIM
    training losses, LPIPS scoring and the conventional baselines on the
    card, from phase 8's trees in ``tmp``; returns the SSIM launches of
    its scoring paths and the phase's numbers."""
    import warnings

    import torch

    from superresolution_aniso_mri_tpu_torch.cli import entry
    from superresolution_aniso_mri_tpu_torch.config import load_settings
    from superresolution_aniso_mri_tpu_torch.data.datasets import (
        get_datasets)
    from superresolution_aniso_mri_tpu_torch.evaluate import (
        FILTER_BENCH, create_hr_images)
    from superresolution_aniso_mri_tpu_torch.evaluate.metrics_driver import (
        LPIPS_CHUNK_BYTES, lpips_volume)
    from superresolution_aniso_mri_tpu_torch.models import (AEConfig,
                                                            VanillaACAI)
    from superresolution_aniso_mri_tpu_torch.ops import (cuda_kernels,
                                                         get_lpips_params)
    from superresolution_aniso_mri_tpu_torch.train import (
        LossConfig, create_train_state, get_trainer, make_train_step)

    out: dict = {}
    # 1. train-brain -d OASIS with the recipe's flags but the mix loss:
    # the ae_combined default, perceptual (VGG LPIPS)
    percept_argv = _without_mix_loss(OASIS_ARGV)
    exper = os.path.join(tmp, "oasis_percept")
    res = _train_timed(entry.train_brain, percept_argv + [
        "-o", tmp, "-id", "oasis_percept"], exper)
    settings = load_settings(os.path.join(exper, "settings.yaml"))
    log("percept train-brain OASIS (perceptual default): " + json.dumps(
        {k: v for k, v in res.items() if k not in ("trainer",
                                                   "step_loss_ae")})
        + f"; mix loss "
        f"{settings['image_mix_loss_func']}, lpips_mode "
        f"{settings.get('lpips_mode')}")
    if settings["image_mix_loss_func"] != "perceptual" \
            or settings.get("lpips_mode") != "lin_converted_vgg_random":
        raise AssertionError("the default OASIS run did not train the "
                             "perceptual mix loss with the shipped lins")
    first, last = (float(np.mean(res["step_loss_ae"][sl]))
                   for sl in (slice(0, 5), slice(-5, None)))
    log(f"percept: loss_ae, mean of the first 5 steps {first:.6f} → of the "
        f"last 5 {last:.6f}; by epoch {res['loss_ae']}")
    if not last < first:
        raise AssertionError(f"perceptual training did not lower loss_ae: "
                             f"{first} → {last}")
    for k in ("ms_per_step", "ms_per_step_min", "s_per_epoch", "cli_s",
              "steps"):
        out[f"oasis_percept_{k}"] = res[k]
    out["oasis_mse_ms_per_step"] = mse_ms
    log(f"percept: OASIS ms/step perceptual {res['ms_per_step']:.3f} vs MSE "
        f"{mse_ms:.3f} (phase 8, same call) [{card}]")
    if profile_path:
        profile_disk_steps(res["trainer"], dev,
                           profile_path + ".percept.txt")

    # 2. one epoch each of the other losses and of bf16 cardiac
    runs = {
        "oasis_percept_enc": (entry.train_brain, _with_epochs(
            percept_argv, 1) + ["--image_mix_loss_func", "perceptual_enc"],
            "encoder_backbone"),
        "oasis_ssim": (entry.train_brain, _with_epochs(OASIS_ARGV, 1)
                       + ["--use_ssim_loss"], None),
        "acdc_percept_bf16": (entry.train_cardiac, _without_mix_loss(
            ACDC_ARGV) + ["--compute_dtype", "bfloat16"],
            "lin_converted_vgg_random"),
    }
    for name, (fn, argv, mode) in runs.items():
        exper = os.path.join(tmp, name)
        r = _train_timed(fn, argv + ["-o", tmp, "-id", name], exper)
        kept = load_settings(os.path.join(exper, "settings.yaml"))
        log(f"percept {name}: " + json.dumps(
            {k: v for k, v in r.items() if k not in ("trainer",
                                                     "step_loss_ae")})
            + f"; lpips_mode {kept.get('lpips_mode')} [{card}]")
        if kept.get("lpips_mode") != mode or r["steps"] < 1:
            raise AssertionError(f"{name}: lpips_mode "
                                 f"{kept.get('lpips_mode')}, expected {mode}")
        out[f"{name}_ms_per_step"] = r["ms_per_step"]
        out[f"{name}_cli_s"] = r["cli_s"]

    # 3. card against CPU: 3 small-config perceptual steps
    small = AEConfig(**SMALL_CFG)
    loss_cfg = LossConfig(model="ae_combined",
                          image_mix_loss_func="perceptual")
    _, small_batches, _ = train_data(seed + 2, SMALL_CFG["width"], 4, 3, dev)
    lr = 1e-5
    states, steps = [], []
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for d in (dev, torch.device("cpu")):
            model = VanillaACAI(small)
            model.reset_parameters(torch.Generator().manual_seed(seed + 2))
            states.append(create_train_state(model.to(d), lr))
            steps.append(make_train_step(loss_cfg, get_lpips_params(
                device=d)))
    worst = 0.0
    for sb in small_batches:
        _, cm = steps[0](states[0], sb, 0.3)
        _, hm = steps[1](states[1], {k: v.cpu() for k, v in sb.items()}, 0.3)
        for k in hm:
            worst = max(worst, abs(float(cm[k]) - float(hm[k]))
                        / max(abs(float(hm[k])), 1e-12))
    drift = max(float((p.detach().cpu() - q.detach()).abs().max())
                for p, q in zip(states[0].model.parameters(),
                                states[1].model.parameters()))
    bound = 2 * lr * len(small_batches)
    out["percept_card_vs_cpu_rel"] = worst
    log(f"percept: card vs CPU, {len(small_batches)} perceptual steps of "
        f"{SMALL_CFG}: max rel loss diff {worst:.3e} (limit 1e-4), max "
        f"param diff {drift:.3e} (limit 2·lr·steps = {bound:.1e})")
    if not worst <= 1e-4 or not drift <= bound:
        raise AssertionError("card and CPU perceptual training differ")

    # 4. LPIPS scoring of the perceptual run's checkpoint over the
    # validation volume, SSIM launches counted and held against the
    # plain version on the pairs scored
    trainer = get_trainer(os.path.join(tmp, "oasis_percept"), "caisr")
    val = get_datasets(trainer.args)[1][:1]
    scored, restore = _kept_ssim_pairs()
    try:
        cuda_kernels.reset_launch_counts()
        t0 = time.perf_counter()
        model_res = create_hr_images(trainer, val, OASIS_DS,
                                     compute_percept_metrics=True)
        torch.cuda.synchronize()
        out["percept_create_hr_images_s"] = time.perf_counter() - t0
        out["percept_create_hr_images_launches"] = \
            cuda_kernels.LAUNCHES["ssim_slice"]
        rows = {"model": {k: model_res["aggregate"][k][0]
                          for k in ("ssim", "psnr", "vif", "lpips")}}
        rows["model"]["s_per_volume"] = out["percept_create_hr_images_s"]
        # 5. the conventional baselines on the same volume
        for method in FILTER_BENCH:
            cuda_kernels.reset_launch_counts()
            t0 = time.perf_counter()
            base = create_hr_images(None, val, OASIS_DS,
                                    interpol_method=method, device=dev)
            torch.cuda.synchronize()
            rows[method] = {k: base["aggregate"][k][0]
                            for k in ("ssim", "psnr", "vif")}
            rows[method]["s_per_volume"] = time.perf_counter() - t0
            rows[method]["launches"] = cuda_kernels.LAUNCHES["ssim_slice"]
    finally:
        restore()
    out["percept_kernel_err"] = check_kept_pairs(scored, "phase 9 scoring")
    for name, row in rows.items():
        log(f"percept score {name:8s} [{card}]: " + json.dumps(row))
    out["baselines"] = rows
    if model_res.get("lpips_mode") != "lin_converted_vgg_random" \
            or out["percept_create_hr_images_launches"] != 1 \
            or any(rows[m]["launches"] != 1 for m in FILTER_BENCH) \
            or not all(np.isfinite(v) for row in rows.values()
                       for v in row.values()):
        raise AssertionError(f"phase 9 scoring: {rows}, "
                             f"lpips_mode {model_res.get('lpips_mode')}")

    # 6. LPIPS of a full [175, 220, 220] pair: CUDA events, peak memory;
    # card against CPU on 4 slices
    a = torch.from_numpy(phantom(seed + 40)).to(dev)
    b = (a + 0.05 * torch.rand(a.shape, device=dev,
                               generator=torch.Generator(device=dev)
                               .manual_seed(seed))).clamp(0, 1)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        params = get_lpips_params(device=dev)
        cpu_params = get_lpips_params(device="cpu")
    lpips_volume(params, b, a)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base_mem = torch.cuda.memory_allocated()
    ms = cuda_ms(lambda: lpips_volume(params, b, a), 3)
    out["lpips_volume_ms"] = ms
    out["lpips_volume_peak_gib"] = (torch.cuda.max_memory_allocated()
                                    - base_mem) / 2 ** 30
    out["lpips_volume_bound_ms"], out["lpips_volume_bound_by"] = \
        lpips_bound(tuple(a.shape))
    out["lpips_chunk_bytes"] = LPIPS_CHUNK_BYTES
    got = lpips_volume(params, b[:4], a[:4]).cpu()
    want = lpips_volume(cpu_params, b[:4].cpu(), a[:4].cpu())
    out["lpips_card_vs_cpu_rel"] = float((got - want).abs().max()
                                         / want.abs().max())
    log(f"percept LPIPS {tuple(a.shape)} [{card}]: {ms:.2f} ms, peak "
        f"{out['lpips_volume_peak_gib']:.2f} GiB over the inputs, bound "
        f"{out['lpips_volume_bound_ms']:.2f} ms "
        f"({out['lpips_volume_bound_by']}); card vs CPU on 4 slices rel "
        f"{out['lpips_card_vs_cpu_rel']:.3e} (limit {LPIPS_CARD_RTOL})")
    if not out["lpips_card_vs_cpu_rel"] <= LPIPS_CARD_RTOL:
        raise AssertionError("LPIPS on the card differs from the CPU")
    log(f"percept timings [{card}]: " + json.dumps(
        {k: v for k, v in out.items() if k != "baselines"}))
    return out


def _clone_state(state):
    """A TrainState of the same values in tensors of its own (the ACAI
    family's optimizer state is one AdamState per group)."""
    import copy

    from superresolution_aniso_mri_tpu_torch.train import TrainState

    def clone(st):
        return dataclasses.replace(st, mu={k: v.clone()
                                           for k, v in st.mu.items()},
                                   nu={k: v.clone() for k, v in st.nu.items()})

    opt = state.opt_state
    opt = ({g: clone(st) for g, st in opt.items()} if isinstance(opt, dict)
           else clone(opt))
    return TrainState(copy.deepcopy(state.model), state.tx, opt, state.step)


def graph_vs_eager(trainer, dev, steps: int = SPD) -> dict:
    """``steps`` replays of a train step captured for ``trainer``'s state
    against as many eager steps from a copy of that state, on the same
    recipe batches, each with its step's noise drawn once by the trainer
    (``Trainer.draw_noise``) and given to both: the largest relative
    loss difference and the parameters' max |Δ|. cuDNN's default
    backward algorithms may sum with atomics (two eager runs differ in
    the last bits), so the capture and both runs use
    ``cudnn.deterministic``: what is compared is the dispatch, not
    cuDNN's summation order. The capture's warm-up steps run first, on
    the trainer's state."""
    import torch

    from superresolution_aniso_mri_tpu_torch.train import (
        make_multi_train_step, make_train_step, steps as steps_mod)

    mix = trainer._mix_weight()
    batches = _recipe_batches(trainer, dev, epoch=7)
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    replays, replay = [], steps_mod._CapturedStep.replay

    def counted(self, *a):
        replays.append(1)
        return replay(self, *a)

    steps_mod._CapturedStep.replay = counted
    try:
        multi = make_multi_train_step(trainer.loss_config,
                                      trainer.lpips_params, device=dev)
        multi(trainer.state, [trainer.draw_noise(next(batches)) for _ in
                              range(steps_mod.WARMUP_STEPS + 1)], mix)
        run = [trainer.draw_noise(next(batches)) for _ in range(steps)]
        eager_state = _clone_state(trainer.state)
        del replays[:]
        _, got = multi(trainer.state, run, mix)
        if len(replays) != steps:
            raise AssertionError(f"{len(replays)} replays for {steps} "
                                 f"steps: the captured step was not reused")
        step = make_train_step(trainer.loss_config, trainer.lpips_params)
        wants = [step(eager_state, b, mix)[1] for b in run]
    finally:
        steps_mod._CapturedStep.replay = replay
        torch.backends.cudnn.deterministic = deterministic
    loss_rel = 0.0
    for i, want in enumerate(wants):
        for k, v in want.items():
            w, g = float(v), float(got[k][i])
            loss_rel = max(loss_rel, abs(g - w) / max(abs(w), 1e-30))
    param_abs = param_rel = 0.0
    eager_sd = eager_state.model.state_dict()
    for k, p in trainer.model.state_dict().items():
        d = float((p - eager_sd[k]).abs().max())
        param_abs = max(param_abs, d)
        param_rel = max(param_rel, d / max(float(eager_sd[k].abs().max()),
                                           1e-30))
    return {"graph_vs_eager_loss_rel": loss_rel,
            "graph_vs_eager_param_abs": param_abs,
            "graph_vs_eager_param_rel": param_rel}


def check_train_options(tmp: str, seed: int, card: str, dev, mse_ms: float,
                        percept_ms: float, profile_path=None) -> dict:
    """Phase 10 (see the module docstring), on phase 8's trees and
    experiments in ``tmp``; returns the SSIM launches of the fitted
    table's scoring and the phase's numbers."""
    import shutil
    import warnings

    import torch

    from superresolution_aniso_mri_tpu_torch.cli import entry
    from superresolution_aniso_mri_tpu_torch.data.datasets import (
        get_datasets)
    from superresolution_aniso_mri_tpu_torch.evaluate import create_hr_images
    from superresolution_aniso_mri_tpu_torch.infer import create_super_volume
    from superresolution_aniso_mri_tpu_torch.ops import cuda_kernels
    from superresolution_aniso_mri_tpu_torch.train import get_trainer
    from superresolution_aniso_mri_tpu_torch.train.import_torch import (
        is_torch_checkpoint)

    out: dict = {}
    spd = ["--steps_per_dispatch", str(SPD)]
    # 1. --steps_per_dispatch 8: the OASIS recipe (MSE, cache on) and the
    # perceptual default, beside phases 8 and 9's eager ms/step
    runs = (("oasis_spd8", OASIS_ARGV, mse_ms),
            ("oasis_percept_spd8", _without_mix_loss(OASIS_ARGV), percept_ms))
    trainers = {}
    for name, argv, eager_ms in runs:
        exper = os.path.join(tmp, name)
        res = _train_timed(entry.train_brain, argv + spd + [
            "-o", tmp, "-id", name, "--device_data_cache", "auto"], exper)
        trainers[name] = res["trainer"]
        log(f"options {name}: " + json.dumps(
            {k: v for k, v in res.items() if k not in ("trainer",
                                                       "step_loss_ae")}))
        if res["steps"] != res["trainer"].iters - 1 \
                or not res["dispatches"] < res["steps"]:
            raise AssertionError(f"{name}: {res['steps']} steps in "
                                 f"{res['dispatches']} dispatches")
        for k in ("ms_per_step", "ms_per_step_min", "s_per_epoch", "cli_s"):
            out[f"{name}_{k}"] = res[k]
        out[f"{name}_eager_ms_per_step"] = eager_ms
        first, last = (float(np.mean(res["step_loss_ae"][sl]))
                       for sl in (slice(0, 5), slice(-5, None)))
        log(f"options: {name}_ms_per_step {res['ms_per_step']:.3f} beside "
            f"the eager {eager_ms:.3f} of the same call "
            f"({eager_ms / res['ms_per_step']:.2f}x) [{card}]; loss_ae, mean "
            f"of the first 5 steps {first:.6f} → of the last 5 {last:.6f}")
    if profile_path:
        profile_disk_steps(trainers["oasis_spd8"], dev,
                           profile_path + ".spd8.txt", steps=2 * SPD, spd=SPD)

    # 2. 8 replays of the full-width recipe's captured step against 8
    # eager steps from the same state and batches (after the profile:
    # it takes the trainer's state further)
    graph = graph_vs_eager(trainers["oasis_spd8"], dev)
    out.update(graph)
    log(f"options: graph vs eager, {SPD} steps of the OASIS recipe: max rel "
        f"loss diff {graph['graph_vs_eager_loss_rel']:.3e}, max |Δ| of the "
        f"parameters {graph['graph_vs_eager_param_abs']:.3e} (rel "
        f"{graph['graph_vs_eager_param_rel']:.3e}; limit {GRAPH_RTOL} "
        f"relative)")
    if not (graph["graph_vs_eager_loss_rel"] <= GRAPH_RTOL
            and graph["graph_vs_eager_param_rel"] <= GRAPH_RTOL):
        raise AssertionError("the replayed step differs from the eager one")

    # 3. one epoch with the EMA, the profiler trace and TensorBoard
    name = "oasis_ema"
    exper = os.path.join(tmp, name)
    prof_dir = os.path.join(tmp, "prof")
    res = _train_timed(entry.train_brain, _with_epochs(OASIS_ARGV, 1) + [
        "-o", tmp, "-id", name, "--ema_decay", "0.999", "--profile_dir",
        prof_dir, "--log_tensorboard"], exper)
    ema = get_trainer(exper, model_nbr="ema")
    live = res["trainer"]
    with torch.no_grad():
        ema_err = max(float((p - live.ema_params[k]).abs().max())
                      for k, p in ema.state.params().items())
        gap = max(float((p - live.state.params()[k]).abs().max())
                  for k, p in ema.state.params().items())
    traces = [os.path.join(prof_dir, f) for f in os.listdir(prof_dir)]
    out["profile_trace_mb"] = sum(os.path.getsize(f) for f in traces) / 2**20
    try:
        import tensorboardX  # noqa: F401
        tb_files = os.listdir(os.path.join(exper, "tb"))
        tb = f"tb/ holds {tb_files}"
    except ImportError as exc:
        tb_files, tb = None, f"tensorboardX is not installed ({exc})"
    log(f"options {name}: ema.models loads through get_trainer('ema'), max "
        f"|Δ| to the trainer's EMA {ema_err:.3e}, to the live weights "
        f"{gap:.3e}; trace {traces} ({out['profile_trace_mb']:.1f} MB); "
        f"{tb}; {res['cli_s']:.1f} s")
    if ema_err != 0.0 or not gap > 0.0 or len(traces) != 1 \
            or not out["profile_trace_mb"] > 0 \
            or (tb_files is not None and not any(
                f.startswith("events.out.tfevents") for f in tb_files)):
        raise AssertionError("EMA checkpoint, profiler trace or TensorBoard "
                             "log missing")

    # 4. fit-latent-taps on phase 8's experiment, then the fitted table
    # scored on the validation volume, SSIM launches counted and held
    # against the plain version on the pairs scored
    exper = os.path.join(tmp, "oasis_cache")
    t0 = time.perf_counter()
    fit = entry.fit_latent_taps(["--exper_dir", exper, "--model_nbr",
                                 "caisr", "--steps", str(FIT_STEPS)])
    torch.cuda.synchronize()
    out["fit_s"] = time.perf_counter() - t0
    out.update(fit_loss_init=fit["loss_init"],
               fit_loss_final=fit["loss_final"], fit_n_pairs=fit["n_pairs"])
    table = os.path.join(exper, "models", "latent_taps.npz")
    trainer = get_trainer(exper, "caisr")
    val = get_datasets(trainer.args)[1][:1]
    scored, restore = _kept_ssim_pairs()
    try:
        cuda_kernels.reset_launch_counts()
        t0 = time.perf_counter()
        fitted = create_hr_images(trainer, val, OASIS_DS,
                                  latent_interp=f"fitted:{table}")
        torch.cuda.synchronize()
        out["fitted_create_hr_images_s"] = time.perf_counter() - t0
        out["fitted_launches"] = cuda_kernels.LAUNCHES["ssim_slice"]
    finally:
        restore()
    out["fitted_kernel_err"] = check_kept_pairs(scored, "phase 10 fitted")
    lanczos = create_hr_images(trainer, val, OASIS_DS,
                               latent_interp="lanczos3")
    rows = {m: {k: r["aggregate"][k][0] for k in ("ssim", "psnr")}
            for m, r in (("fitted", fitted), ("lanczos3", lanczos))}
    log(f"options fit-latent-taps: {fit['n_pairs']} pairs, holdout MSE "
        f"{fit['loss_init']:.6f} → {fit['loss_final']:.6f} in "
        f"{out['fit_s']:.2f} s; create_hr_images fitted "
        f"{out['fitted_create_hr_images_s']:.3f} s, "
        f"{out['fitted_launches']} SSIM launch; scores "
        f"{json.dumps(rows)} [{card}]")
    if not (np.isfinite(fit["loss_final"])
            and fit["loss_final"] <= fit["loss_init"]
            and out["fitted_launches"] == 1
            and all(np.isfinite(v) for r in rows.values()
                    for v in r.values())):
        raise AssertionError("fit-latent-taps or its scoring failed")

    # 5. phase 8's caisr.models exported to the reference format,
    # converted back, and all three served on the card
    ref, conv = os.path.join(tmp, "ref_exper"), os.path.join(tmp, "conv")
    os.makedirs(os.path.join(ref, "models"))
    shutil.copy2(os.path.join(exper, "settings.yaml"), ref)
    entry.export_reference_checkpoint([
        "--exper_dir", exper, "--model_nbr", "caisr", "--out",
        os.path.join(ref, "models", "caisr.models")])
    entry.convert_reference_checkpoint(["--exper_dir", ref, "--output_dir",
                                        conv])
    if not is_torch_checkpoint(os.path.join(ref, "models", "caisr.models")) \
            or is_torch_checkpoint(os.path.join(conv, "models",
                                                "caisr.models")):
        raise AssertionError("the reference export or the conversion did "
                             "not write its format")
    vol = np.asarray(val[0].image, np.float32)
    serve = dict(alpha_range=np.linspace(0, 1, OASIS_DS + 1)[1:-1],
                 downsample_steps=OASIS_DS, use_original=False,
                 generate_inbetween_slices=True)
    served = {}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")   # the stem-geometry note
        for name, src in (("original", exper), ("reference", ref),
                          ("converted", conv)):
            served[name] = create_super_volume(
                get_trainer(src, "caisr"), vol, **serve)["upsampled_image"]
    out["reference_roundtrip_max_abs"] = max(
        float(np.abs(served[k] - served["original"]).max())
        for k in ("reference", "converted"))
    log(f"options reference checkpoints: caisr.models → reference torch → "
        f"SRTPU1, served {served['original'].shape} on the card: max |Δ| "
        f"{out['reference_roundtrip_max_abs']:.3e} (limit 1e-6)")
    if not out["reference_roundtrip_max_abs"] <= 1e-6:
        raise AssertionError("the converted checkpoints serve differently")
    log(f"options timings [{card}]: " + json.dumps(out))
    return out


def _as_family(argv: list, model: str, *extra: str) -> list:
    """``argv`` training ``-m model``, with ``extra`` flags appended."""
    i = argv.index("-m")
    return argv[:i + 1] + [model] + argv[i + 2:] + list(extra)


def _with_threshold(argv: list, threshold: int) -> list:
    i = argv.index("--epoch_threshold")
    return argv[:i + 1] + [str(threshold)] + argv[i + 2:]


def _counted_scoring(fn, what: str) -> tuple:
    """Run ``fn`` with the kernel launch counts set to 0 just before and
    every pair the SSIM kernel scores kept; returns (its result, the
    ssim_slice launches, the kernel's largest error against the plain
    version on those pairs, the seconds)."""
    import torch

    from superresolution_aniso_mri_tpu_torch.ops import cuda_kernels

    scored, restore = _kept_ssim_pairs()
    try:
        cuda_kernels.reset_launch_counts()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = cuda_kernels.LAUNCHES["ssim_slice"]
    finally:
        restore()
    if len(scored) != launches or launches < 1:
        raise AssertionError(f"{what}: {launches} SSIM launches, "
                             f"{len(scored)} pairs kept")
    return res, launches, check_kept_pairs(scored, what), secs


def _fingerprint(model) -> dict:
    """Per-tensor float64 sums of a state dict (device reductions)."""
    return {k: float(v.double().sum()) for k, v in
            model.state_dict().items()}


def _free_cuda() -> None:
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()


def families_card_vs_cpu(seed: int, dev) -> float:
    """3 small-config steps of each comparison family on the card against
    the CPU from the same weights and the same draws (the card trainer's
    ``draw_noise``, copied to the CPU): the largest relative metric
    difference; raises past 1e-4 or when the parameters drift past
    2·lr·steps."""
    import torch

    from superresolution_aniso_mri_tpu_torch.train import Trainer

    lr = 1e-5
    _, small_batches, _ = train_data(seed + 3, SMALL_CFG["width"], 4, 3, dev)
    worst = 0.0
    for model, ae_class in (("acai_combined", "VanillaACAI"),
                            ("vae_combined", "VanillaACAI"),
                            ("vae2", "VanillaACAI"),
                            ("ae_combined", "LargerAE"),
                            ("ae_combined", "VanillaACAIStrided")):
        args = dict(model=model, ae_class=ae_class, lr=lr, vae_beta=1.0,
                    image_mix_loss_func="mse", dataset="OASIS", seed=seed,
                    **SMALL_CFG)
        card, cpu = Trainer(args, device=dev), Trainer(args, device="cpu")
        # the Dense heads are drawn on each trainer's device
        cpu.model.load_state_dict({k: v.cpu() for k, v in
                                   card.model.state_dict().items()})
        rel = 0.0
        for sb in small_batches:
            nb = card.draw_noise(sb)
            _, cm = card.train_step(card.state, nb, 0.3)
            _, hm = cpu.train_step(cpu.state, {k: v.cpu()
                                               for k, v in nb.items()}, 0.3)
            for k in hm:
                rel = max(rel, abs(float(cm[k]) - float(hm[k]))
                          / max(abs(float(hm[k])), 1e-12))
        drift = max(float((p.detach().cpu() - q.detach()).abs().max())
                    for p, q in zip(card.model.parameters(),
                                    cpu.model.parameters()))
        bound = 2 * lr * len(small_batches)
        log(f"families: card vs CPU, {len(small_batches)} steps of {model} "
            f"{ae_class} {SMALL_CFG}: max rel metric diff {rel:.3e} (limit "
            f"1e-4), max param diff {drift:.3e} (limit 2·lr·steps = "
            f"{bound:.1e})")
        if not rel <= 1e-4 or not drift <= bound:
            raise AssertionError(f"card and CPU {model} {ae_class} training "
                                 f"differ")
        worst = max(worst, rel)
    return worst


def check_families(tmp: str, seed: int, card: str, dev, mse_ms: float,
                   profile_path=None) -> dict:
    """Phase 11 (see the module docstring), on phase 8's trees in
    ``tmp``; returns the SSIM launches of its scoring paths, the
    kernel's largest error on the pairs they scored and the phase's
    numbers."""
    import torch

    from superresolution_aniso_mri_tpu_torch.cli import entry
    from superresolution_aniso_mri_tpu_torch.data.datasets import (
        get_datasets)
    from superresolution_aniso_mri_tpu_torch.evaluate import (
        compute_volume_metrics, create_hr_images)
    from superresolution_aniso_mri_tpu_torch.infer import create_super_volume
    from superresolution_aniso_mri_tpu_torch.models import (
        VAE, AEConfig, reset_parameters)
    from superresolution_aniso_mri_tpu_torch.train import get_trainer

    _free_cuda()
    out: dict = {"launches": {}, "kernel_err": 0.0}

    def scored(name, fn):
        res, n, err, secs = _counted_scoring(fn, f"phase 11 {name}")
        out["launches"][name] = n
        out["kernel_err"] = max(out["kernel_err"], err)
        out[f"{name}_s"] = secs
        return res

    # 1. acai_combined, 2 epochs eager and with --steps_per_dispatch 8;
    # 8 replays against 8 eager steps with the same draws; find-best
    acai = {}
    for name, extra in (("acai", ()), ("acai_spd8", ("--steps_per_dispatch",
                                                     str(SPD)))):
        exper = os.path.join(tmp, name)
        res = _train_timed(entry.train_brain, _as_family(
            OASIS_ARGV, "acai_combined", *extra) + ["-o", tmp, "-id", name],
            exper)
        acai[name] = res
        for k in ("ms_per_step", "ms_per_step_min", "s_per_epoch", "cli_s",
                  "steps"):
            out[f"{name}_{k}"] = res[k]
        log(f"families {name}: " + json.dumps(
            {k: v for k, v in res.items() if k not in ("trainer",
                                                       "step_loss_ae")}))
    if not acai["acai_spd8"]["dispatches"] < acai["acai_spd8"]["steps"]:
        raise AssertionError("acai_spd8 did not dispatch several steps")
    log(f"families: acai_combined ms/step eager "
        f"{out['acai_ms_per_step']:.3f}, --steps_per_dispatch {SPD} "
        f"{out['acai_spd8_ms_per_step']:.3f}; ae_combined (phase 8, same "
        f"call) {mse_ms:.3f} [{card}]")
    graph = graph_vs_eager(acai["acai_spd8"]["trainer"], dev)
    out.update({f"acai_{k}": v for k, v in graph.items()})
    log(f"families: graph vs eager, {SPD} acai_combined steps of the OASIS "
        f"recipe with the same draws: max rel loss diff "
        f"{graph['graph_vs_eager_loss_rel']:.3e}, max |Δ| of the parameters "
        f"{graph['graph_vs_eager_param_abs']:.3e} (rel "
        f"{graph['graph_vs_eager_param_rel']:.3e}; limit {GRAPH_RTOL} "
        f"relative)")
    if not (graph["graph_vs_eager_loss_rel"] <= GRAPH_RTOL
            and graph["graph_vs_eager_param_rel"] <= GRAPH_RTOL):
        raise AssertionError("the replayed acai step differs from the eager")
    if profile_path:
        profile_disk_steps(acai["acai"]["trainer"], dev,
                           profile_path + ".acai.txt")
    del acai
    _free_cuda()
    best = scored("acai_find_best", lambda: entry.find_best_model(
        ["--exper_dir", os.path.join(tmp, "acai")]))
    log(f"families acai find-best: epochs {best['epochs']}, SSIM "
        f"{best['history']['ssim']}, {out['launches']['acai_find_best']} "
        f"launches")
    if best["epochs"] != [0, 1] or out["launches"]["acai_find_best"] != 2 \
            or not np.isfinite(best["history"]["ssim"]).all():
        raise AssertionError("acai find-best did not score both checkpoints")

    # 2. vae_combined and vae2, 1 epoch each at the recipe's widths: peak
    # memory, the checkpoint read back, a [175, 64, 64] crop served and
    # scored. vae_combined writes only last.models: its 8 GiB of heads
    # with their Adam moments make a 24 GiB checkpoint
    # the recipe's --width (64): the VAE heads fix the in-plane size
    width = int(OASIS_ARGV[OASIS_ARGV.index("--width") + 1])
    lo = HW // 2 - width // 2
    crop = phantom(seed + 11)[:, lo:lo + width, lo:lo + width].copy()
    serve = dict(alpha_range=np.linspace(0, 1, DS + 1)[1:-1],
                 downsample_steps=DS, use_original=False,
                 generate_inbetween_slices=True)
    # the recipe VAE's initialisation: its Dense heads (2 × 1.07 G
    # weights) are drawn on the card
    cfg = AEConfig(width=width, latent_width=16, depth=32, latent=128,
                   use_batchnorm=True, use_sigmoid=True)
    with torch.device(dev):
        vae = VAE(cfg)
    t0 = time.perf_counter()
    reset_parameters(vae, torch.Generator().manual_seed(seed))
    torch.cuda.synchronize()
    out["vae_init_s"] = time.perf_counter() - t0
    log(f"families: VAE {tuple(vae.encoder_mu.weight.shape)} heads "
        f"initialised on the card in {out['vae_init_s']:.2f} s")
    del vae
    for name, model in (("vae", "vae_combined"), ("vae2", "vae2")):
        exper = os.path.join(tmp, name)
        argv = _with_threshold(_with_epochs(_as_family(OASIS_ARGV, model), 1),
                               0 if name == "vae" else -1)
        _free_cuda()
        torch.cuda.reset_peak_memory_stats()
        res = _train_timed(entry.train_brain, argv + ["-o", tmp, "-id", name],
                           exper)
        out[f"{name}_peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
        for k in ("ms_per_step", "ms_per_step_min", "cli_s", "steps"):
            out[f"{name}_{k}"] = res[k]
        trained = res.pop("trainer")
        heads = trained._ae_model().encoder_mu.weight.shape
        want = _fingerprint(trained.model)
        del trained, res
        _free_cuda()
        ckpt = os.path.join(exper, "models", "last.models")
        out[f"{name}_checkpoint_gib"] = os.path.getsize(ckpt) / 2 ** 30
        t0 = time.perf_counter()
        back = get_trainer(exper, "last")
        torch.cuda.synchronize()
        out[f"{name}_read_back_s"] = time.perf_counter() - t0
        got = _fingerprint(back.model)
        if got != want:
            bad = [k for k in want if got.get(k) != want[k]][:5]
            raise AssertionError(f"{name}: the checkpoint reads back "
                                 f"differently: {bad}")
        def serve_score(back=back):
            r = create_super_volume(back, crop, **serve)
            return r["upsampled_image"], compute_volume_metrics(
                crop, r["upsampled_image"], downsample_steps=DS)

        served, scores = scored(f"{name}_serve_score", serve_score)
        if served.shape != crop.shape or not all(
                np.isfinite(v) for v in scores.values()):
            raise AssertionError(f"{name}: served {served.shape}, scores "
                                 f"{scores}")
        log(f"families {name}: heads {tuple(heads)}, {out[f'{name}_steps']} "
            f"steps, ms/step {out[f'{name}_ms_per_step']:.3f}, peak "
            f"{out[f'{name}_peak_gib']:.2f} GiB, checkpoint "
            f"{out[f'{name}_checkpoint_gib']:.2f} GiB read back in "
            f"{out[f'{name}_read_back_s']:.1f} s (equal), {crop.shape} crop "
            f"served and scored {json.dumps(scores)} [{card}]")
        del back, serve_score    # its default argument holds the trainer
        _free_cuda()

    # 3. ae_combined on LargerAE and VanillaACAIStrided, 1 epoch each,
    # served and scored on the validation patient
    for name, ae_class in (("larger", "LargerAE"),
                           ("strided", "VanillaACAIStrided")):
        exper = os.path.join(tmp, name)
        res = _train_timed(entry.train_brain, _with_epochs(
            OASIS_ARGV, 1) + ["--ae_class", ae_class, "-o", tmp, "-id", name],
            exper)
        for k in ("ms_per_step", "cli_s", "steps"):
            out[f"{name}_{k}"] = res[k]
        del res
        trainer = get_trainer(exper, "caisr")
        if type(trainer._ae_model()).__name__ != ae_class:
            raise AssertionError(f"{name}: served a "
                                 f"{type(trainer._ae_model()).__name__}")
        val = get_datasets(trainer.args)[1][:1]
        hr_res = scored(f"{name}_create_hr_images",
                        lambda: create_hr_images(trainer, val, OASIS_DS))
        agg = {k: hr_res["aggregate"][k][0] for k in ("ssim", "psnr")}
        log(f"families {name} ({ae_class}): ms/step "
            f"{out[f'{name}_ms_per_step']:.3f}, validation patient "
            f"{json.dumps(agg)} [{card}]")
        if not all(np.isfinite(v) for v in agg.values()):
            raise AssertionError(f"{name}: scores {agg}")
        del trainer
        _free_cuda()

    # 4. card against CPU, 3 small-config steps of each family
    out["card_vs_cpu_rel"] = families_card_vs_cpu(seed, dev)
    log(f"families timings [{card}]: " + json.dumps(out))
    return out


def make_labeled_frames(root: str, seed: int) -> list:
    """Phase 12's labeled ACDC tree beside phase 8's cines under
    ``root``: ``LABELED_PATIENTS`` patients' ED/ES frames
    (``patientXXX_frameYY.nii.gz`` of ``LABELED_SHAPE`` at ACDC's native
    spacing) with phantom ``_gt`` maps in {0, 1, 2, 3} (the phantom's
    intensity quantiles: spatially coherent like RV/MYO/LV masks), and
    the patients that phase 8's ACDC split file does not list added to
    its training split (phase 8's patients keep theirs). Returns the
    split."""
    from superresolution_aniso_mri_tpu_torch.config import (
        load_string_lists, save_string_lists)

    pids = [f"patient{i + 1:03d}" for i in range(LABELED_PATIENTS)]
    jobs = []
    for i, pid in enumerate(pids):
        for fr in (1, 12):
            img = phantom(seed + 500 + 10 * i + fr, *LABELED_SHAPE)
            lbl = np.digitize(img, np.percentile(img, (60, 80, 92)))
            d = os.path.join(root, "ACDC", "all_cardiac_phases", pid)
            jobs.append((os.path.join(d, f"{pid}_frame{fr:02d}.nii.gz"),
                         img * 400.0, ACDC_SPACING))
            jobs.append((os.path.join(d, f"{pid}_frame{fr:02d}_gt.nii.gz"),
                         lbl.astype(np.float32), ACDC_SPACING))
    _write_volumes(jobs)
    path = os.path.join(root, "ACDC", "train_val_test_split_sr.yaml")
    split = load_string_lists(path)
    listed = {p for ids in split.values() for p in ids}
    split["training"] = list(split["training"]) + [p for p in pids
                                                   if p not in listed]
    save_string_lists(split, path)
    return split


def labeled_card_vs_cpu(seed: int, dev) -> float:
    """3 small-config steps of ``multichannel_combined`` (with a loss
    mask in the batch) on the card against the CPU from the same weights
    and batches: the largest relative metric difference; raises past
    ``LABELED_CARD_RTOL`` or when the parameters drift past
    2·lr·steps."""
    import torch

    from superresolution_aniso_mri_tpu_torch.train import Trainer

    lr, steps = 1e-5, 3
    args = dict(model="ae_combined", dataset="ACDCLBL", lr=lr,
                image_mix_loss_func="mse", seed=seed,
                **dict(SMALL_CFG, colors=2))
    card, cpu = Trainer(args, device=dev), Trainer(args, device="cpu")
    rng = np.random.RandomState(seed + 12)
    w = SMALL_CFG["width"]
    rel = 0.0
    for _ in range(steps):
        def planes(n):
            return torch.from_numpy(np.concatenate(
                [rng.rand(n, 1, w, w), rng.randint(0, 4, (n, 1, w, w))],
                axis=1).astype(np.float32))
        batch = {"image": planes(8), "slice_between": planes(4),
                 "alpha_from": torch.full((4,), 0.5),
                 "alpha_to": torch.full((4,), 0.5),
                 "loss_mask": torch.from_numpy(
                     (rng.rand(4, 1, w, w) > 0.3).astype(np.float32))}
        _, cm = card.train_step(card.state, {k: v.to(dev) for k, v in
                                             batch.items()}, 0.3)
        _, hm = cpu.train_step(cpu.state, batch, 0.3)
        for k in hm:
            rel = max(rel, abs(float(cm[k]) - float(hm[k]))
                      / max(abs(float(hm[k])), 1e-12))
    drift = max(float((p.detach().cpu() - q.detach()).abs().max())
                for p, q in zip(card.model.parameters(),
                                cpu.model.parameters()))
    log(f"labeled: card vs CPU, {steps} steps of multichannel_combined "
        f"{dict(SMALL_CFG, colors=2)}: max rel metric diff {rel:.3e} (limit "
        f"{LABELED_CARD_RTOL}), max param diff {drift:.3e} (limit "
        f"2·lr·steps = {2 * lr * steps:.1e})")
    if not rel <= LABELED_CARD_RTOL or not drift <= 2 * lr * steps:
        raise AssertionError("card and CPU multichannel training differ")
    return rel


def replay_ms(trainer, dev, steps: int = SPD) -> float:
    """ms/step of ``steps`` replays of the train step that ``trainer``'s
    ``--steps_per_dispatch`` run captured: one ``train_many`` over ready
    recipe batches (``_recipe_batches``) after one untimed, CUDA events
    around the second."""
    import torch

    batches = _recipe_batches(trainer, dev, epoch=5)
    trainer.train_many([next(batches) for _ in range(steps)])
    run = [next(batches) for _ in range(steps)]
    t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0.record()
    trainer.train_many(run)
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / steps


def check_labeled(tmp: str, seed: int, card: str, dev,
                  profile_path=None) -> dict:
    """Phase 12 (see the module docstring), on phase 8's data root in
    ``tmp``; returns the SSIM launches of its scoring paths, the
    kernel's largest error on the pairs they scored and the phase's
    numbers. With ``profile_path``: 10 traced eager steps and 16
    replayed ones (``profile_path + ".labeled.txt"`` and
    ``".labeled_spd8.txt"``)."""
    import torch

    from superresolution_aniso_mri_tpu_torch.cli import entry
    from superresolution_aniso_mri_tpu_torch.data.datasets import (
        load_acdc_labeled_volumes, load_acdc_volumes)
    from superresolution_aniso_mri_tpu_torch.evaluate import create_hr_images
    from superresolution_aniso_mri_tpu_torch.infer import (ServingModel,
                                                           create_super_volume)
    from superresolution_aniso_mri_tpu_torch.train import get_trainer
    from superresolution_aniso_mri_tpu_torch.utils import (read_image,
                                                           write_image)

    _free_cuda()
    out: dict = {"launches": {}, "kernel_err": 0.0}
    root = os.environ["SR_DATA_ROOT"]

    def scored(name, fn):
        res, n, err, secs = _counted_scoring(fn, f"phase 12 {name}")
        out["launches"][name] = n
        out["kernel_err"] = max(out["kernel_err"], err)
        out[f"{name}_s"] = secs
        return res

    # 1. the labeled frames beside phase 8's cines, which must not change
    cines = load_acdc_volumes("validation")
    t0 = time.perf_counter()
    split = make_labeled_frames(root, seed)
    out["labeled_fabricate_s"] = time.perf_counter() - t0
    again = load_acdc_volumes("validation")
    if [v.patient_id for v in again] != [v.patient_id for v in cines] or \
            not all(np.array_equal(a.image, b.image)
                    for a, b in zip(again, cines)):
        raise AssertionError("the labeled frames changed phase 8's ACDC "
                             "cines")
    log(f"labeled: {LABELED_PATIENTS} patients x ED/ES {LABELED_SHAPE} "
        f"with _gt maps written in {out['labeled_fabricate_s']:.1f} s, "
        f"split {json.dumps(split)}; phase 8's "
        f"{len(cines)} validation cine frames read back unchanged")

    # 2. train-cardiac -d ACDCLBL (the cardiac recipe's flags): eager 2
    # epochs, --get_masks, --steps_per_dispatch 8. An epoch holds one
    # dispatch of 8 and 5 eager steps, so the spd 8 run's step gaps
    # (first dispatch left out) time eager steps: its ms/step is timed
    # below on 8 replays of the step its run captured
    runs = {}
    for name, extra in (("lbl", ["-e", "2"]), ("lbl_masks", ["--get_masks"]),
                        ("lbl_spd8", ["--steps_per_dispatch", str(SPD)])):
        exper = os.path.join(tmp, name)
        _free_cuda()
        torch.cuda.reset_peak_memory_stats()
        argv = LABELED_ARGV + extra + ["-o", tmp, "-id", name]
        res = _train_timed(entry.train_cardiac, argv, exper)
        out[f"{name}_peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
        trainer = res["trainer"]
        if (trainer.family, trainer.args["ae_class"]) != (
                "multichannel_combined", "MultiChannelAE"):
            raise AssertionError(f"{name}: trained {trainer.family} "
                                 f"{trainer.args['ae_class']}")
        for k in (("cli_s", "steps", "dispatches") if name == "lbl_spd8"
                  else ("ms_per_step", "ms_per_step_min", "cli_s", "steps",
                        "dispatches")):
            out[f"{name}_{k}"] = res[k]
        losses = np.load(os.path.join(exper, "losses_train.npz"))
        if not all(np.isfinite(losses[k]).all() for k in (
                "loss_label", "loss_ae_extra", "loss_ae_dist_labels")):
            raise AssertionError(f"{name}: label losses not finite")
        hidden = ("trainer", "step_loss_ae") + (
            ("ms_per_step", "ms_per_step_min") if name == "lbl_spd8" else ())
        log(f"labeled {name}: " + json.dumps(
            {k: v for k, v in res.items() if k not in hidden})
            + f", peak {out[f'{name}_peak_gib']:.2f} GiB [{card}]")
        runs[name] = res
    if not runs["lbl_spd8"]["dispatches"] < runs["lbl_spd8"]["steps"]:
        raise AssertionError("lbl_spd8 did not dispatch several steps")
    out["lbl_spd8_ms_per_step"] = replay_ms(runs["lbl_spd8"]["trainer"], dev)
    log(f"labeled: ms/step eager {out['lbl_ms_per_step']:.3f}, "
        f"--get_masks {out['lbl_masks_ms_per_step']:.3f}, "
        f"--steps_per_dispatch {SPD} {out['lbl_spd8_ms_per_step']:.3f} "
        f"[{card}]")
    if profile_path:
        profile_disk_steps(runs["lbl"]["trainer"], dev,
                           profile_path + ".labeled.txt")
        profile_disk_steps(runs["lbl_spd8"]["trainer"], dev,
                           profile_path + ".labeled_spd8.txt", steps=2 * SPD,
                           spd=SPD)
    graph = graph_vs_eager(runs["lbl_spd8"]["trainer"], dev)
    out.update({f"lbl_{k}": v for k, v in graph.items()})
    log(f"labeled: graph vs eager, {SPD} multichannel_combined steps: max "
        f"rel loss diff {graph['graph_vs_eager_loss_rel']:.3e}, max |Δ| of "
        f"the parameters {graph['graph_vs_eager_param_abs']:.3e} (rel "
        f"{graph['graph_vs_eager_param_rel']:.3e}; limit {GRAPH_RTOL} "
        f"relative)")
    if not (graph["graph_vs_eager_loss_rel"] <= GRAPH_RTOL
            and graph["graph_vs_eager_param_rel"] <= GRAPH_RTOL):
        raise AssertionError("the replayed multichannel step differs from "
                             "the eager")

    del runs
    _free_cuda()

    # 3. card against CPU
    out["card_vs_cpu_rel"] = labeled_card_vs_cpu(seed, dev)

    # 4. generate with the validation patient's frame and its _gt map:
    # decoded labels on the output grid; bf16 against f32 serving
    exper = os.path.join(tmp, "lbl")
    val_pid = split["validation"][0]
    src = os.path.join(root, "ACDC", "all_cardiac_phases", val_pid)
    inputs, gen_out = os.path.join(tmp, "lbl_in"), os.path.join(tmp,
                                                                 "lbl_out")
    os.makedirs(inputs, exist_ok=True)
    for suffix in ("", "_gt"):
        arr, spacing, _ = read_image(os.path.join(
            src, f"{val_pid}_frame01{suffix}.nii.gz"))
        write_image(os.path.join(inputs, f"{val_pid}{suffix}.nii.gz"), arr,
                    spacing=spacing)
    t0 = time.perf_counter()
    entry.generate_hr_volumes(["--exper_dir", exper, "--data_input_dir",
                               inputs, "--output_dir", gen_out,
                               "--num_interpolations", "1"])
    out["generate_s_per_volume"] = time.perf_counter() - t0
    img = read_image(os.path.join(gen_out, f"{val_pid}_ni01.nii.gz"))[0]
    lbl = read_image(os.path.join(gen_out, f"{val_pid}_ni01_gt.nii.gz"))[0]
    grid = (2 * LABELED_SHAPE[0] - 1,) + LABELED_SHAPE[1:]
    uniq = sorted(int(v) for v in np.unique(lbl))
    log(f"labeled generate: image {img.shape}, labels {lbl.shape} "
        f"{lbl.dtype} ids {uniq}, {out['generate_s_per_volume']:.2f} s "
        f"[{card}]")
    if img.shape != grid or lbl.shape != grid or not set(uniq) <= {
            0, 1, 2, 3} or not np.isfinite(img).all():
        raise AssertionError("generate did not write decoded labels on the "
                             "output grid")
    trainer = get_trainer(exper, "caisr")
    val = load_acdc_labeled_volumes("validation")
    vol = val[0]
    serve = dict(alpha_range=[0.5], downsample_steps=2,
                 generate_inbetween_slices=True, labels=vol.labels)
    f32 = create_super_volume(trainer, vol.image, **serve)
    cfg16 = dataclasses.replace(trainer.model_config,
                                compute_dtype="bfloat16")
    bf16 = create_super_volume(
        ServingModel(cfg16, trainer.model.state_dict(), device=dev,
                     ae_class="MultiChannelAE"), vol.image, **serve)
    same = float(np.mean(bf16["upsampled_labels"] == f32["upsampled_labels"]))
    out["bf16_label_agreement"] = same
    out["bf16_image_max_abs_diff"] = float(np.abs(
        bf16["upsampled_image"] - f32["upsampled_image"]).max())
    log(f"labeled serve {vol.image.shape}: bf16 decoded labels equal the "
        f"float32 ones on {same:.4f} of the voxels (limit "
        f"{LABELED_BF16_AGREEMENT}), image max |Δ| "
        f"{out['bf16_image_max_abs_diff']:.3e}")
    if not same >= LABELED_BF16_AGREEMENT:
        raise AssertionError("bf16 labels disagree with the float32 ones")

    # 5. create_hr_images and find-best on the validation patient, SSIM
    # counted and held against the plain version
    hr_res = scored("labeled_create_hr_images",
                    lambda: create_hr_images(trainer, val, 2))
    agg = {k: hr_res["aggregate"][k][0] for k in ("ssim", "psnr")}
    out["create_hr_images_s_per_volume"] = (
        out["labeled_create_hr_images_s"] / len(val))
    best = scored("labeled_find_best", lambda: entry.find_best_model(
        ["--exper_dir", exper]))
    log(f"labeled create_hr_images on {len(val)} validation frames "
        f"{vol.image.shape}: {json.dumps(agg)}, "
        f"{out['create_hr_images_s_per_volume']:.2f} s/volume; find-best "
        f"epochs {best['epochs']}, SSIM {best['history']['ssim']}; launches "
        f"{json.dumps(out['launches'])} [{card}]")
    if out["launches"]["labeled_create_hr_images"] != len(val) \
            or best["epochs"] != [0, 1] \
            or out["launches"]["labeled_find_best"] != 2 * len(val) \
            or not all(np.isfinite(v) for v in agg.values()):
        raise AssertionError("phase 12 scoring did not score every "
                             "validation frame through the SSIM kernel")
    del trainer
    _free_cuda()
    log(f"labeled timings [{card}]: " + json.dumps(out))
    return out


def alpha_card_vs_cpu(seed: int, dev) -> float:
    """3 small-config steps of each alpha family (the probe's BatchNorm,
    the synthesis loss masked) on the card against the CPU from the same
    weights and batches: the largest relative metric difference; raises
    past ``ALPHA_CARD_RTOL``, when the parameters' movement θ − θ0
    agrees within 0.1 of its largest entry for less than 99.5 % of the
    entries (Adam's first steps are near-sign steps: an entry whose update
    changed sign moves 2·lr·steps the other way), or when alpha_only's
    autoencoder moved."""
    import torch

    from superresolution_aniso_mri_tpu_torch.train import Trainer

    lr = 1e-5
    raw, small_batches, _ = train_data(seed + 13, SMALL_CFG["width"], 4, 3,
                                       dev)
    rng = np.random.RandomState(seed + 13)
    batches = [{**b, "alpha_features": torch.from_numpy(
        r["alpha_features"]).to(dev), "loss_mask": torch.from_numpy(
            (rng.rand(*b["slice_between"].shape) > 0.3).astype(
                np.float32)).to(dev)}
        for r, b in zip(raw, small_batches)]
    worst = 0.0
    for model, alpha_class in (("alpha", "AlphaProbe"),
                               ("alpha_end_to_end", "AlphaProbe256v1"),
                               ("alpha_only", "AlphaProbe16Convex"),
                               ("alpha_combined", "AlphaProbe16v1")):
        args = dict(model=model, alpha_class=alpha_class, dataset="ACDC",
                    lr=lr, get_masks=True, use_batchnorm_probe=True,
                    seed=seed, **SMALL_CFG)
        card, cpu = Trainer(args, device=dev), Trainer(args, device="cpu")
        # the Dense layers are drawn on each trainer's device
        cpu.model.load_state_dict({k: v.cpu() for k, v in
                                   card.model.state_dict().items()})
        ae0 = {k: v.clone() for k, v in card.model["ae"].state_dict().items()}
        theta0 = [p.detach().cpu().clone() for p in cpu.model.parameters()]
        rel = 0.0
        for b in batches:
            _, cm = card.train_step(card.state, b, 0.3)
            _, hm = cpu.train_step(cpu.state, {k: v.cpu()
                                               for k, v in b.items()}, 0.3)
            for k in hm:
                rel = max(rel, abs(float(cm[k]) - float(hm[k]))
                          / max(abs(float(hm[k])), 1e-12))
        moves = [(p.detach().cpu() - p0, q.detach() - p0) for p, q, p0 in
                 zip(card.model.parameters(), cpu.model.parameters(), theta0)]
        top = max(float(b.abs().max()) for _, b in moves)
        gap = torch.cat([(a - b).abs().reshape(-1) for a, b in moves])
        agree = float((gap <= 0.1 * top).double().mean())
        moved = model == "alpha_only" and not all(
            torch.equal(v, card.model["ae"].state_dict()[k])
            for k, v in ae0.items())
        log(f"alpha: card vs CPU, {len(batches)} steps of {model} "
            f"{alpha_class} {SMALL_CFG}: max rel metric diff {rel:.3e} "
            f"(limit {ALPHA_CARD_RTOL}), θ − θ0 within 0.1 of its largest "
            f"entry {top:.3e} for {agree:.4%} of the entries (limit 99.5%), "
            f"max |Δ| {float(gap.max()):.3e}")
        if not rel <= ALPHA_CARD_RTOL or not agree >= 0.995 or moved:
            raise AssertionError(f"card and CPU {model} training differ")
        worst = max(worst, rel)
    return worst


def legacy_card_vs_cpu(seed: int, dev) -> float:
    """A forward of each legacy model (their default widths, the spatial
    critic at 128²) on a [4, 1, 128, 128] batch on the card, float32
    with TF32 off, against the CPU's float32 forward and its float64
    forward (the witness of which side rounds): the largest |Δ| relative
    to the output's largest entry. Returns the largest held difference:
    from the CPU, DiscriminatorSpatial's from float64 (see
    ``LEGACY_CARD_RTOL``); raises past the limit."""
    import copy

    import torch

    from superresolution_aniso_mri_tpu_torch.device import f32_exact
    from superresolution_aniso_mri_tpu_torch.models import (
        DiscriminatorFakeReal, DiscriminatorSpatial, LegacyAE, LegacyAEAdv,
        reset_parameters)

    def rel(a, b):
        return float((a.double() - b.double()).abs().max()) / max(
            float(b.abs().max()), 1e-30)

    x = torch.from_numpy(np.random.RandomState(seed + 14).rand(
        4, 1, 128, 128).astype(np.float32))
    worst = 0.0
    for model in (LegacyAE(), LegacyAEAdv(), DiscriminatorSpatial(width=128),
                  DiscriminatorFakeReal()):
        name = type(model).__name__
        reset_parameters(model, torch.Generator().manual_seed(seed))
        model.eval()
        with torch.no_grad(), f32_exact():
            want = model(x)
            # DiscriminatorFakeReal casts its input to float32, so its
            # witness is its float32 forward
            exact = copy.deepcopy(model).double()(x.double())
            card = model.to(dev)
            t0 = time.perf_counter()
            got = card(x.to(dev)).cpu()
            secs = time.perf_counter() - t0
        vs_cpu, card64, cpu64 = rel(got, want), rel(got, exact), rel(want,
                                                                    exact)
        spatial = name == "DiscriminatorSpatial"
        held = card64 if spatial else vs_cpu
        log(f"legacy {name}: {tuple(x.shape)} → {tuple(got.shape)}, max rel "
            f"diff card vs CPU {vs_cpu:.3e}, from float64 card {card64:.3e} "
            f"CPU {cpu64:.3e} (limit {LEGACY_CARD_RTOL} from "
            + ("float64" if spatial else "the CPU")
            + f"), {secs * 1e3:.1f} ms on the card (first call)")
        if not held <= LEGACY_CARD_RTOL or not torch.isfinite(got).all():
            raise AssertionError(f"legacy {name} differs on the card")
        worst = max(worst, held)
    return worst


def check_alpha(tmp: str, seed: int, card: str, dev,
                profile_path=None) -> dict:
    """Phase 13 (see the module docstring), on phase 8's data root in
    ``tmp``; returns the SSIM launches of its scoring paths, the
    kernel's largest error on the pairs they scored and the phase's
    numbers. With ``profile_path``: 10 traced eager steps and 16
    replayed ones (``profile_path + ".alpha.txt"`` and
    ``".alpha_spd8.txt"``)."""
    import torch

    from superresolution_aniso_mri_tpu_torch.cli import entry
    from superresolution_aniso_mri_tpu_torch.data.datasets import (
        load_acdc_volumes)
    from superresolution_aniso_mri_tpu_torch.evaluate import create_hr_images
    from superresolution_aniso_mri_tpu_torch.infer import (
        latent_space_interp_pred_alpha, reconstruct_in_patches)
    from superresolution_aniso_mri_tpu_torch.ops import cuda_kernels
    from superresolution_aniso_mri_tpu_torch.train import Trainer, get_trainer

    _free_cuda()
    t_phase = time.perf_counter()
    out: dict = {"launches": {}, "kernel_err": 0.0}

    def scored(name, fn):
        res, n, err, secs = _counted_scoring(fn, f"phase 13 {name}")
        out["launches"][name] = n
        out["kernel_err"] = max(out["kernel_err"], err)
        out[f"{name}_s"] = secs
        return res

    def train(name, argv):
        exper = os.path.join(tmp, name)
        _free_cuda()
        torch.cuda.reset_peak_memory_stats()
        res = _train_timed(entry.train_cardiac, argv + ["-o", tmp, "-id",
                                                        name], exper)
        out[f"{name}_peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
        trainer = res["trainer"]
        if trainer.family != "alpha" or trainer.loss_config.model != \
                trainer.args["model"]:
            raise AssertionError(f"{name}: trained {trainer.family}")
        losses = np.load(os.path.join(exper, "losses_train.npz"))
        if not all(np.isfinite(losses[k]).all() for k in (
                "loss_latent_1", "loss_latent_2", "pred_alpha_mean",
                "loss_ae_dist_extra")):
            raise AssertionError(f"{name}: alpha losses not finite")
        spd = "--steps_per_dispatch" in argv
        for k in (("cli_s", "steps", "dispatches") if spd
                  else ("ms_per_step", "ms_per_step_min", "cli_s", "steps")):
            out[f"{name}_{k}"] = res[k]
        hidden = ("trainer", "step_loss_ae") + (
            ("ms_per_step", "ms_per_step_min") if spd else ())
        log(f"alpha {name}: " + json.dumps(
            {k: v for k, v in res.items() if k not in hidden})
            + f", peak {out[f'{name}_peak_gib']:.2f} GiB, probe "
            f"{type(trainer.model['probe']).__name__} of "
            f"{trainer.args.get('alpha_class') or 'AlphaProbe16v1'}, "
            f"{trainer.num_alphas} coefficients "
            f"({trainer.loss_config.alpha_scheme}) [{card}]")
        return res

    # 1. alpha_end_to_end (the recipe's flags): 2 epochs eager and 1 with
    # --steps_per_dispatch 8, whose ms/step comes from 8 replays of the
    # step its run captured; 8 replays against 8 eager steps
    runs = {"alpha_e2e": train("alpha_e2e", _with_epochs(ALPHA_ARGV, 2)),
            "alpha_e2e_spd8": train("alpha_e2e_spd8", ALPHA_ARGV + [
                "--steps_per_dispatch", str(SPD)])}
    spd8 = runs["alpha_e2e_spd8"]
    if not spd8["dispatches"] < spd8["steps"]:
        raise AssertionError("alpha_e2e_spd8 did not dispatch several steps")
    out["alpha_e2e_spd8_ms_per_step"] = replay_ms(spd8["trainer"], dev)
    log(f"alpha: alpha_end_to_end ms/step eager "
        f"{out['alpha_e2e_ms_per_step']:.3f}, --steps_per_dispatch {SPD} "
        f"{out['alpha_e2e_spd8_ms_per_step']:.3f} [{card}]")
    if profile_path:
        profile_disk_steps(runs["alpha_e2e"]["trainer"], dev,
                           profile_path + ".alpha.txt")
        profile_disk_steps(spd8["trainer"], dev,
                           profile_path + ".alpha_spd8.txt", steps=2 * SPD,
                           spd=SPD)
    graph = graph_vs_eager(spd8["trainer"], dev)
    out.update({f"alpha_e2e_{k}": v for k, v in graph.items()})
    log(f"alpha: graph vs eager, {SPD} alpha_end_to_end steps: max rel "
        f"loss diff {graph['graph_vs_eager_loss_rel']:.3e}, max |Δ| of the "
        f"parameters {graph['graph_vs_eager_param_abs']:.3e} (rel "
        f"{graph['graph_vs_eager_param_rel']:.3e}; limit {GRAPH_RTOL} "
        f"relative)")
    if not (graph["graph_vs_eager_loss_rel"] <= GRAPH_RTOL
            and graph["graph_vs_eager_param_rel"] <= GRAPH_RTOL):
        raise AssertionError("the replayed alpha step differs from the "
                             "eager")
    del runs, spd8
    _free_cuda()

    # 2. the other variants and the spatial probe, 1 epoch each
    for name, model, extra in (
            ("alpha", "alpha", ()), ("alpha_only", "alpha_only", ()),
            ("alpha_combined", "alpha_combined", ()),
            ("alpha_256", "alpha_end_to_end",
             ("--alpha_class", "AlphaProbe256v1"))):
        trainer = train(name, _as_family(ALPHA_ARGV, model, *extra))["trainer"]
        if name == "alpha_only":
            fresh = Trainer(dict(trainer.args), device=dev)
            same = all(torch.equal(v, trainer.model["ae"].state_dict()[k])
                       for k, v in fresh.model["ae"].state_dict().items())
            log(f"alpha alpha_only: the autoencoder after "
                f"{out['alpha_only_steps']} steps equals its initial "
                f"weights and statistics bitwise: {same}")
            if not same:
                raise AssertionError("alpha_only moved the autoencoder")
            del fresh
        if name == "alpha_combined" and "decoder_mix" not in trainer.model:
            raise AssertionError("alpha_combined has no decoder_mix")
        if name == "alpha_256":
            lw = trainer.model_config.latent_width
            first = tuple(trainer.model["probe"].dense[0].weight.shape)
            log(f"alpha alpha_256: AlphaProbe256v1's first Dense {first} "
                f"(flax [in, out] {first[::-1]})")
            if first[1] != lw * lw * (lw // 2) + 5:
                raise AssertionError(f"AlphaProbe256v1 flattens to {first}")
        del trainer
        _free_cuda()

    # 3. card against CPU
    out["card_vs_cpu_rel"] = alpha_card_vs_cpu(seed, dev)

    # 4. create_hr_images and find-best over the alpha_end_to_end
    # checkpoints on the validation frames (served through the ae)
    exper = os.path.join(tmp, "alpha_e2e")
    trainer = get_trainer(exper, "caisr")
    val = load_acdc_volumes("validation")
    hr_res = scored("alpha_create_hr_images",
                    lambda: create_hr_images(trainer, val, 2))
    agg = {k: hr_res["aggregate"][k][0] for k in ("ssim", "psnr")}
    out["create_hr_images_s_per_volume"] = (
        out["alpha_create_hr_images_s"] / len(val))
    best = scored("alpha_find_best", lambda: entry.find_best_model(
        ["--exper_dir", exper]))
    out["find_best_s_per_checkpoint"] = (out["alpha_find_best_s"]
                                         / len(best["epochs"]))
    log(f"alpha create_hr_images on {len(val)} validation frames "
        f"{val[0].image.shape}: {json.dumps(agg)}, "
        f"{out['create_hr_images_s_per_volume']:.3f} s/volume; find-best "
        f"epochs {best['epochs']}, "
        f"{out['find_best_s_per_checkpoint']:.3f} s/checkpoint; launches "
        f"{json.dumps(out['launches'])} [{card}]")
    if out["launches"]["alpha_create_hr_images"] != len(val) \
            or best["epochs"] != [0, 1] \
            or out["launches"]["alpha_find_best"] != 2 * len(val) \
            or not all(np.isfinite(v) for v in agg.values()):
        raise AssertionError("phase 13 scoring did not score every "
                             "validation frame through the SSIM kernel")

    # 5. probe-predicted mixes of the first validation frame's kept slices
    # (its center crop at the training width: the probe's Dense layers
    # fix the latent grid), scored against the held-out slices
    vol = val[0]
    w = int(trainer.args["width"])
    h0, w0 = ((n - w) // 2 for n in vol.image.shape[1:])
    crop = vol.image[:, h0:h0 + w, w0:w0 + w]
    kept, held = crop[::2], crop[1:-1:2]
    n_pairs = min(len(kept) - 1, len(held))
    fd = {"anatomy": "cardiac",
          "norm_frame_id": (vol.frame_id + 1.0) / vol.num_frames,
          "orig_num_slices": crop.shape[0], "spacing": float(vol.spacing[0])}

    def interp():
        dec, alphas = latent_space_interp_pred_alpha(
            trainer, kept[:n_pairs, None], kept[1:n_pairs + 1, None], 2, fd)
        ref = torch.from_numpy(np.ascontiguousarray(held[:n_pairs])).to(dev)
        return dec, alphas, cuda_kernels.ssim_volume_fused(
            ref, dec[:, 0].contiguous())

    dec, alphas, ssim = scored("alpha_pred_interp", interp)
    out["pred_alpha_mean"] = float(alphas.mean())
    out["pred_alpha_min"] = float(alphas.min())
    out["pred_alpha_max"] = float(alphas.max())
    out["pred_interp_ssim"] = [float(v) for v in ssim.cpu()]
    log(f"alpha latent_space_interp_pred_alpha: {n_pairs} pairs of "
        f"{crop.shape[1:]} → {tuple(dec.shape)}, predicted alphas "
        f"{alphas.shape} mean {out['pred_alpha_mean']:.4f} range "
        f"[{out['pred_alpha_min']:.4f}, {out['pred_alpha_max']:.4f}], SSIM "
        f"against the held-out slices {out['pred_interp_ssim']}")
    if tuple(dec.shape) != (n_pairs, 1, w, w) or not bool(
            torch.isfinite(dec).all()) or not np.isfinite(alphas).all():
        raise AssertionError("probe-predicted interpolation failed")

    # 6. patch-tiled reconstruction on the card against the CPU
    cpu_trainer = get_trainer(exper, "caisr", device="cpu")
    got = reconstruct_in_patches(trainer, crop, 32)
    want = reconstruct_in_patches(cpu_trainer, crop, 32)
    out["patches_card_vs_cpu"] = float(np.abs(got - want).max())
    log(f"alpha reconstruct_in_patches {crop.shape} in 32² tiles: card vs "
        f"CPU max |Δ| {out['patches_card_vs_cpu']:.3e} (limit 1e-4)")
    if not out["patches_card_vs_cpu"] <= 1e-4:
        raise AssertionError("patch-tiled reconstruction differs on the card")
    del trainer, cpu_trainer
    _free_cuda()

    # 7. the legacy models
    out["legacy_card_vs_cpu_rel"] = legacy_card_vs_cpu(seed, dev)
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"alpha timings [{card}]: " + json.dumps(out))
    return out


def _lax_grid(sax_shape, spacing) -> tuple:
    """A long-axis plane through the middle of a [z, y, x] short-axis
    stack: rows along the stack's z at its in-plane spacing, columns
    along x; returns (the LAX [1, rows, x] shape, its normalised SAX
    sampling grid)."""
    from superresolution_aniso_mri_tpu_torch.evaluate import (
        make_lax_identity_grid, make_transform)

    z, y, x = sax_shape
    dz, dy, dx = spacing
    lax_shape = (1, int(round(z * dz / dx)), x)
    scale_lax = np.diag([dx, dx, dx, 1.0])
    swap_yz = np.array([[1.0, 0, 0, 0], [0, 0, 1, 0], [0, 1, 0, 0],
                        [0, 0, 0, 1]])
    shift = np.eye(4)
    shift[1, 3] = y * dy / 2
    scale_sax = np.diag([dx, dy, dz, 1.0])
    grid = make_transform(make_lax_identity_grid(lax_shape), lax_shape,
                          sax_shape, scale_lax, swap_yz, shift, scale_sax,
                          np.eye(4), np.eye(4))
    return lax_shape, grid.astype(np.float32)


def check_eval(tmp: str, seed: int, card: str, dev) -> dict:
    """Phase 14 (see the module docstring), on phase 8's trees in
    ``tmp`` and the checkpoints of phases 8, 10 and 11; returns the SSIM
    launches of its scoring paths, the kernel's largest error on the
    pairs they scored and the phase's numbers."""
    import warnings

    import torch

    from superresolution_aniso_mri_tpu_torch.cli import entry
    from superresolution_aniso_mri_tpu_torch.data.datasets import (
        get_datasets, load_brain_volumes)
    from superresolution_aniso_mri_tpu_torch.evaluate import (
        combine_volumes, compare_quantitative, compute_ppl,
        create_brain_volumes, create_hr_images,
        evaluate_model_reconstruction, resample_sax_to_lax,
        test_interpolation_with_rigid_transformations)
    from superresolution_aniso_mri_tpu_torch.infer import create_super_volume
    from superresolution_aniso_mri_tpu_torch.train import get_trainer
    from superresolution_aniso_mri_tpu_torch.utils import (read_image,
                                                          write_image)

    _free_cuda()
    t_phase = time.perf_counter()
    out: dict = {"launches": {}, "kernel_err": 0.0}

    def scored(name, fn):
        res, n, err, secs = _counted_scoring(fn, f"phase 14 {name}")
        out["launches"][name] = n
        out["kernel_err"] = max(out["kernel_err"], err)
        out[f"{name}_s"] = secs
        return res

    # 1. the primary: -m ae, one epoch of the OASIS recipe, from another
    # seed than the SR models (the same seed and data would leave the two
    # a step of lr apart)
    exper = os.path.join(tmp, "eval_ae")
    t0 = time.perf_counter()
    entry.train_brain(_with_epochs(_as_family(OASIS_ARGV, "ae"), 1)
                      + ["-o", tmp, "-id", "eval_ae", "--seed",
                         str(seed + 14)])
    out["ae_train_s"] = time.perf_counter() - t0
    primary = get_trainer(exper, "last")
    val = get_datasets(primary.args)[1][:1]
    test = load_brain_volumes("OASIS", OASIS_DS, "test",
                              include_hr_images=True)
    vol = np.asarray(test[0].image, np.float32)
    serve = dict(alpha_range=np.linspace(0, 1, OASIS_DS + 1)[1:-1],
                 downsample_steps=OASIS_DS, use_original=False,
                 generate_inbetween_slices=True)
    synth = np.ones(vol.shape[0], bool)
    synth[::OASIS_DS] = False
    synth[((vol.shape[0] - 1) // OASIS_DS) * OASIS_DS:] = False
    ae_only = create_super_volume(primary, vol, **serve)["upsampled_image"]
    # the reconstructed (kept) slices of the combo are the primary's
    # predict of the kept stack, clamped as serving clamps
    kept = torch.from_numpy(np.ascontiguousarray(
        vol[:((vol.shape[0] - 1) // OASIS_DS) * OASIS_DS + 1:OASIS_DS,
            None]))
    recon = primary.predict(kept)[:, 0].clamp(0, 1).cpu().numpy()

    # 2. the combo with each SR checkpoint: served, scored, checked
    results = os.path.join(tmp, "eval_results")
    sources = {"caisr": os.path.join(tmp, "oasis_cache"),
               "acai": os.path.join(tmp, "acai"),
               "reference_torch": os.path.join(tmp, "ref_exper")}
    combo_files = {}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")   # the stem-geometry note
        for name, src in sources.items():
            sr_own = create_super_volume(get_trainer(src, "caisr"), vol,
                                         **serve)["upsampled_image"]
            primary.load_caisr(os.path.join(src, "models", "caisr.models"))
            t0 = time.perf_counter()
            combo = create_super_volume(primary, vol,
                                        **serve)["upsampled_image"]
            torch.cuda.synchronize()
            out[f"combo_{name}_serve_s"] = time.perf_counter() - t0
            synth_vs_sr = float(np.abs(combo[synth] - sr_own[synth]).max())
            synth_vs_ae = float(np.abs(combo[synth] - ae_only[synth]).max())
            recon_err = float(np.abs(combo[:len(recon) * OASIS_DS:OASIS_DS]
                                     - recon).max())
            out[f"combo_{name}_synth_vs_sr"] = synth_vs_sr
            out[f"combo_{name}_synth_vs_ae"] = synth_vs_ae
            out[f"combo_{name}_recon_vs_predict"] = recon_err
            # phase 8's SR model's volume is written for section 3
            res = scored(f"eval_combo_{name}_create_hr_images",
                         lambda: create_hr_images(
                             primary, test[:1], OASIS_DS,
                             output_dir=os.path.join(results, name),
                             save_volumes=name == "caisr"))
            combo_files[name] = os.path.join(
                results, name, test[0].patient_id,
                f"{test[0].patient_id}_ae_{OASIS_DS}x.nii.gz")
            log(f"eval combo ({name} SR model, {vol.shape} → "
                f"{combo.shape}): synthesized slices vs the SR model's own "
                f"{synth_vs_sr:.3e} (limit {COMBO_ATOL}), vs AE-only "
                f"{synth_vs_ae:.3e} (must differ), reconstructed slices vs "
                f"the AE's predict {recon_err:.3e} (limit 1e-6); serve "
                f"{out[f'combo_{name}_serve_s']:.3f} s/volume, "
                f"create_hr_images "
                f"{out[f'eval_combo_{name}_create_hr_images_s']:.3f} s/volume, "
                f"SSIM {res['aggregate']['ssim'][0]:.4f} [{card}]")
            if not (synth_vs_sr <= COMBO_ATOL and synth_vs_ae > 1e-4
                    and recon_err <= 1e-6
                    and np.isfinite(res["aggregate"]["ssim"][0])):
                raise AssertionError(f"the AE+CAISR combo with {name} "
                                     f"serves wrongly")

        # card against the CPU on a crop, phase 8's caisr as SR model
        cpu = get_trainer(exper, "last", device="cpu")
        for t in (primary, cpu):
            t.load_caisr(os.path.join(sources["caisr"], "models",
                                      "caisr.models"))
    h0, w0 = (max(0, (n - 64) // 2) for n in vol.shape[1:])
    crop = vol[:37, h0:h0 + 64, w0:w0 + 64].copy()
    got = create_super_volume(primary, crop, **serve)["upsampled_image"]
    want = create_super_volume(cpu, crop, **serve)["upsampled_image"]
    out["combo_card_vs_cpu"] = float(np.abs(got - want).max())
    log(f"eval combo card vs CPU {crop.shape}: max |Δ| "
        f"{out['combo_card_vs_cpu']:.3e} (limit 1e-4)")
    if not out["combo_card_vs_cpu"] <= 1e-4:
        raise AssertionError("the combo serves differently on the card")

    # 3. the AE-only volume written, merged with the SR model's, and the
    # saved volumes compared against the reference
    primary.params_sr = cpu.params_sr = None
    scored("eval_ae_create_hr_images", lambda: create_hr_images(
        primary, test[:1], OASIS_DS, output_dir=os.path.join(results, "ae"),
        save_volumes=True))
    ae_file = os.path.join(results, "ae", test[0].patient_id,
                           f"{test[0].patient_id}_ae_{OASIS_DS}x.nii.gz")
    ae_vol, caisr_vol = (read_image(f)[0] for f in
                         (ae_file, combo_files["caisr"]))
    merged = combine_volumes(ae_vol, caisr_vol, OASIS_DS)
    out["combine_vs_combo"] = float(np.abs(merged - caisr_vol).max())
    ref_file = os.path.join(results, "reference.nii.gz")
    write_image(ref_file, vol)
    quant = {}
    for name, path in (("ae", ae_file), ("combo", combo_files["caisr"])):
        quant[name] = scored(
            f"eval_quantitative_{name}", lambda path=path:
            compare_quantitative([ref_file], [path], OASIS_DS,
                                 output_file=os.path.join(
                                     results, f"quant_{name}.npz")))
    log(f"eval combine_volumes: the merged AE + CAISR files vs the combo's "
        f"{out['combine_vs_combo']:.3e} (limit {COMBO_ATOL}); "
        f"compare_quantitative "
        + json.dumps({k: {m: v[0] for m, v in r["aggregate"].items()}
                      for k, r in quant.items()}))
    if not out["combine_vs_combo"] <= COMBO_ATOL or not all(
            np.isfinite(r["aggregate"]["ssim_synth"][0])
            for r in quant.values()):
        raise AssertionError("combine_volumes or compare_quantitative failed")

    # 4. reconstruction-only scores, the rigid-transform table
    recon_res = scored("eval_reconstruction", lambda:
                       evaluate_model_reconstruction(primary, val + test))
    rigid = scored("eval_rigid", lambda:
                   test_interpolation_with_rigid_transformations(
                       primary, test[0], OASIS_DS, angles=(0, 10)))
    log(f"eval reconstruction: SSIM {recon_res['aggregate']['ssim'][0]:.4f} "
        f"over {len(val + test)} volumes in "
        f"{out['eval_reconstruction_s']:.3f} s; rigid table SSIM "
        + json.dumps({a: r["ssim"][0] for a, r in rigid.items()})
        + f" in {out['eval_rigid_s']:.3f} s")
    if sorted(rigid) != [0, 10] or not np.isfinite(
            recon_res["aggregate"]["ssim"][0]):
        raise AssertionError("reconstruction scores or rigid table failed")

    # 5. perceptual path length: 64 pairs on the card, 4 against the CPU
    pool = np.ascontiguousarray(vol)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")   # the random-VGG LPIPS note
        compute_ppl(primary, pool, num_pairs=4)   # resolves LPIPS once
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out["ppl_64"] = compute_ppl(primary, pool, num_pairs=64)
        torch.cuda.synchronize()
        out["ppl_64_s"] = time.perf_counter() - t0
        got = compute_ppl(primary, pool, num_pairs=4, epsilon=1e-2)
        want = compute_ppl(cpu, pool, num_pairs=4, epsilon=1e-2)
    out["ppl_card_vs_cpu_rel"] = abs(got - want) / abs(want)
    log(f"eval compute_ppl: 64 pairs of {pool.shape[1:]} = "
        f"{out['ppl_64']:.6g} in {out['ppl_64_s']:.3f} s; 4 pairs at "
        f"epsilon 1e-2 card {got:.6g} vs CPU {want:.6g}: rel "
        f"{out['ppl_card_vs_cpu_rel']:.3e} (limit 1e-3) [{card}]")
    if not (np.isfinite(out["ppl_64"])
            and out["ppl_card_vs_cpu_rel"] <= 1e-3):
        raise AssertionError("compute_ppl failed or differs on the card")
    del cpu
    _free_cuda()

    # 6. SAX → LAX of one of phase 8's ACDC cines
    cine_path = os.path.join(tmp, "data", "ACDC", "all_cardiac_phases",
                             "patient001", "patient001_4d.nii.gz")
    cine, spacing, _ = read_image(cine_path)
    cine = np.asarray(cine, np.float32) / float(cine.max())
    lax_shape, grid = _lax_grid(cine.shape[1:], ACDC_SPACING)
    target = (cine.shape[0],) + lax_shape
    resample_sax_to_lax(cine, target, grid, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lax = resample_sax_to_lax(cine, target, grid, device=dev)
    out["sax_to_lax_s"] = time.perf_counter() - t0
    lax_cpu = resample_sax_to_lax(cine, target, grid, device="cpu")
    out["sax_to_lax_card_vs_cpu"] = float(np.abs(lax - lax_cpu).max())
    log(f"eval resample_sax_to_lax {cine.shape} → {lax.shape} in "
        f"{out['sax_to_lax_s']:.3f} s: card vs CPU max |Δ| "
        f"{out['sax_to_lax_card_vs_cpu']:.3e} (limit 1e-6), mean "
        f"{float(lax.mean()):.4f} [{card}]")
    if not (out["sax_to_lax_card_vs_cpu"] <= 1e-6 and lax.max() > 0):
        raise AssertionError("SAX → LAX resampling failed on the card")

    # 7. MNISTRoto through the CLI, then the brain driver
    roto = os.path.join(tmp, "roto")
    t0 = time.perf_counter()
    trainer = entry.train_brain(ROTO_ARGV + ["-o", tmp, "-id", "roto"])
    out["roto_train_s"] = time.perf_counter() - t0
    out["roto_steps"] = trainer.iters - 1
    loss = np.load(os.path.join(roto, "losses_train.npz"))["loss_ae"]
    brain = scored("eval_roto_create_brain_volumes", lambda:
                   create_brain_volumes(trainer, "MNISTRoto", OASIS_DS,
                                        width=int(trainer.args["width"]),
                                        save_volumes=False))
    log(f"eval train-brain -d MNISTRoto: {out['roto_steps']} steps in "
        f"{out['roto_train_s']:.2f} s, loss_ae {loss.tolist()}; "
        f"create_brain_volumes SSIM {brain['aggregate']['ssim'][0]:.4f} in "
        f"{out['eval_roto_create_brain_volumes_s']:.3f} s [{card}]")
    if not (np.isfinite(loss).all() and out["roto_steps"] >= 1
            and np.isfinite(brain["aggregate"]["ssim"][0])):
        raise AssertionError("MNISTRoto did not train or score")
    del trainer, primary
    _free_cuda()
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"eval timings [{card}]: " + json.dumps(out))
    return out


def _torchvision_vgg16(seed: int) -> tuple:
    """A seeded torchvision-shaped VGG16 state dict (``features.{i}``
    convs, a classifier entry) and an LPIPS v0.1 lin state dict
    (``lin{k}.model.1.weight``), as torch tensors."""
    import torch

    from superresolution_aniso_mri_tpu_torch.ops.lpips import (_VGG_PLAN,
                                                               LPIPS_CHANNELS)
    from superresolution_aniso_mri_tpu_torch.tools.convert_lpips_weights \
        import _VGG16_CONV_IDX

    rng = np.random.RandomState(seed)
    vgg, cin = {}, 3
    for idx, (cout, _) in zip(_VGG16_CONV_IDX, _VGG_PLAN):
        vgg[f"features.{idx}.weight"] = torch.from_numpy(
            (rng.randn(cout, cin, 3, 3) * np.sqrt(2.0 / (9 * cin)))
            .astype(np.float32))
        vgg[f"features.{idx}.bias"] = torch.from_numpy(
            (rng.randn(cout) * 0.01).astype(np.float32))
        cin = cout
    vgg["classifier.0.bias"] = torch.zeros(4096)
    lin = {f"lin{k}.model.1.weight": torch.from_numpy(
        (np.abs(rng.randn(1, c, 1, 1)) / c).astype(np.float32))
        for k, c in enumerate(LPIPS_CHANNELS)}
    return vgg, lin


def check_prep(tmp: str, seed: int, card: str, dev) -> dict:
    """Phase 15 (see the module docstring), on phase 8's data root in
    ``tmp`` with phase 8's ``oasis_cache`` and ``acdc`` and phase 12's
    ``lbl`` experiments and labeled frames; returns the SSIM launches of
    its scoring path, the kernel's largest error on the pairs it scored
    and the phase's numbers."""
    import torch

    from superresolution_aniso_mri_tpu_torch.data import (
        create_centered_dataset, create_masi_cropped_dataset,
        create_masi_lr_dataset, get_acdc_fold_patient_ids)
    from superresolution_aniso_mri_tpu_torch.data.datasets import (
        create_dhcp_dataset, create_lr_dataset, create_split_file,
        get_datasets, load_acdc_volumes)
    from superresolution_aniso_mri_tpu_torch.data.volume import \
        rescale_intensities
    from superresolution_aniso_mri_tpu_torch.evaluate import (
        create_hr_images, evaluate_sr_segmentation)
    from superresolution_aniso_mri_tpu_torch.infer import create_super_volume
    from superresolution_aniso_mri_tpu_torch.ops import lpips
    from superresolution_aniso_mri_tpu_torch.ops.perceptual import (
        enc_perceptual_params, uniform_lins)
    from superresolution_aniso_mri_tpu_torch.tools import (
        convert_lpips_weights, fit_perceptual_head, lpips_gap_study)
    from superresolution_aniso_mri_tpu_torch.train import get_trainer
    from superresolution_aniso_mri_tpu_torch.utils import (read_image,
                                                           write_image)

    _free_cuda()
    t_phase = time.perf_counter()
    out: dict = {"launches": {}, "kernel_err": 0.0}
    root = os.environ["SR_DATA_ROOT"]

    def timed(fn):
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0

    def volumes_ok(vols, n, what):
        if len(vols) != n or not all(
                np.isfinite(v.image).all() and 0.0 <= v.image.min()
                and v.image.max() <= 1.0 for v in vols):
            raise AssertionError(f"{what}: {len(vols)} volumes read back "
                                 f"(expected {n}, finite, in [0, 1])")

    # 1. dHCP: raw subjects at the T2 grid → create_dhcp_dataset (the
    # brain box, background zeroed, padded to 256) → the 4x LR files →
    # get_datasets -d dHCP
    raw = os.path.join(tmp, "dhcp_raw")
    subjects = [f"sub-CC{i + 1:05d}" for i in range(DHCP_SUBJECTS)]
    _, out["dhcp_fabricate_s"] = timed(lambda: _write_volumes([(
        os.path.join(raw, sub, "ses-1", "anat",
                     f"{sub}_ses-1_desc-restore_T2w.nii.gz"),
        phantom(seed + 600 + i, *DHCP_SHAPE) * 1000.0, DHCP_SPACING)
        for i, sub in enumerate(subjects)]))
    dhcp_root = os.path.join(root, "dHCP_cropped_256")
    written, secs = timed(lambda: create_dhcp_dataset(raw, dhcp_root,
                                                      patch_size=256))
    out["dhcp_prepare_s_per_volume"] = secs / len(written)
    lr, secs = timed(lambda: create_lr_dataset("dHCP", DHCP_DS))
    out["dhcp_lr_s_per_volume"] = secs / len(lr)
    create_split_file(dhcp_root, subjects, (1, 0, 1))
    (train, val), out["dhcp_get_datasets_s"] = timed(lambda: get_datasets(
        {"dataset": "dHCP", "downsample_steps": DHCP_DS}))
    volumes_ok(train + val, DHCP_SUBJECTS, "dHCP")
    shapes = [tuple(v.image.shape) for v in train + val]
    log(f"prep dHCP: {DHCP_SUBJECTS} x {DHCP_SHAPE} at {DHCP_SPACING} mm "
        f"(written in {out['dhcp_fabricate_s']:.1f} s) → "
        f"{[os.path.basename(f) for f in written]} "
        f"{out['dhcp_prepare_s_per_volume']:.2f} s/volume, LR "
        f"{out['dhcp_lr_s_per_volume']:.2f} s/volume, get_datasets "
        f"{out['dhcp_get_datasets_s']:.2f} s, shapes {shapes} [{card}]")
    if not all(s[1] >= 256 and s[2] >= 256 and s[0] <= DHCP_SHAPE[0]
               for s in shapes):
        raise AssertionError(f"dHCP crops {shapes} not padded to 256")

    # 2. brainMASI: images + 6-class references → the brain crop and its
    # split → the thick-slice LR set → get_datasets -d brainMASI
    mraw = os.path.join(tmp, "masi_raw")
    jobs = []
    for i in range(MASI_PATIENTS):
        img = phantom(seed + 700 + i, *MASI_SHAPE)
        lbl = np.digitize(img, (0.05, 0.3, 0.45, 0.6, 0.75, 0.85))
        jobs.append((os.path.join(mraw, "images", f"{1000 + i}.nii.gz"),
                     img * 1000.0, (1.0, 1.0, 1.0)))
        jobs.append((os.path.join(mraw, "manual_references", "6classes",
                                  f"{1000 + i}.nii.gz"),
                     lbl.astype(np.float32), (1.0, 1.0, 1.0)))
    _write_volumes(jobs)
    cropped_dir = os.path.join(tmp, "masi_cropped")
    cropped, secs = timed(lambda: create_masi_cropped_dataset(
        mraw, cropped_dir, patch_size=MASI_PATCH))
    out["masi_crop_s_per_volume"] = secs / len(cropped)
    lr, secs = timed(lambda: create_masi_lr_dataset(
        cropped_dir, os.path.join(root, "BrainMASI_LR_co")))
    out["masi_lr_s_per_volume"] = secs / len(lr)
    train, val = get_datasets({"dataset": "brainMASI",
                               "downsample_steps": MASI_DS})
    volumes_ok(train, 15, "brainMASI training")
    volumes_ok(val, MASI_PATIENTS - 15, "brainMASI test")
    log(f"prep brainMASI: {MASI_PATIENTS} x {MASI_SHAPE} → crop "
        f"{out['masi_crop_s_per_volume']:.3f} s/volume "
        f"{tuple(train[0].image.shape)}, LR "
        f"{out['masi_lr_s_per_volume']:.3f} s/volume; get_datasets "
        f"{len(train)} training / {len(val)} test [{card}]")

    # 3. ACDC centering of phase 12's patients (a 2-frame ED/ES cine
    # where phase 8 wrote none), read back by load_acdc_volumes; phase
    # 8's ACDC model serves and scores a centered validation frame
    src = os.path.join(root, "ACDC", "all_cardiac_phases")
    pids = [f"patient{i + 1:03d}" for i in range(LABELED_PATIENTS)]
    jobs = []
    for pid in pids:
        d = os.path.join(src, pid)
        if not os.path.isfile(os.path.join(d, f"{pid}_frame01_gt.nii.gz")):
            raise AssertionError(f"{pid}: phase 12 wrote no frame01_gt")
        if not os.path.isfile(os.path.join(d, f"{pid}_4d.nii.gz")):
            cine = np.stack([read_image(os.path.join(
                d, f"{pid}_frame{fr:02d}.nii.gz"))[0] for fr in (1, 12)])
            jobs.append((os.path.join(d, f"{pid}_4d.nii.gz"), cine,
                         ACDC_SPACING))
    _write_volumes(jobs)
    cdir = os.path.join(tmp, "acdc_centered")
    centered, secs = timed(lambda: create_centered_dataset(src, cdir, pids))
    out["center_s_per_volume"] = secs / len(centered)
    moved = read_image(centered[0])[0]
    orig = read_image(os.path.join(src, pids[0], f"{pids[0]}_4d.nii.gz"))[0]
    if moved.shape != orig.shape or np.array_equal(moved, orig):
        raise AssertionError("centering left the cine as it was")
    val = load_acdc_volumes("validation", src_path=cdir)[:1]
    trainer = get_trainer(os.path.join(tmp, "acdc"), "last", device=dev)
    res, n, err, secs = _counted_scoring(
        lambda: create_hr_images(trainer, val, 2), "phase 15 centered ACDC")
    out["launches"]["prep_centered_create_hr_images"] = n
    out["kernel_err"] = max(out["kernel_err"], err)
    out["centered_create_hr_images_s_per_volume"] = secs
    agg = {k: res["aggregate"][k][0] for k in ("ssim", "psnr")}
    log(f"prep ACDC centering: {len(centered)} cines "
        f"{out['center_s_per_volume']:.2f} s/volume; centered validation "
        f"frame {val[0].image.shape} served and scored: {json.dumps(agg)}, "
        f"{secs:.3f} s, {n} SSIM launch [{card}]")
    if n != 1 or not all(np.isfinite(v) for v in agg.values()):
        raise AssertionError("the centered frame was not scored")
    del trainer
    _free_cuda()

    # 4. SR segmentation: phase 12's ED/ES frames and _gt maps as the
    # SR-seg set of fold-0 validation ids, the MultiChannelAE's decoded
    # labels as the predictions; the references scored against
    # themselves as the self-check
    lbl_trainer = get_trainer(os.path.join(tmp, "lbl"), "caisr", device=dev)
    sr_root = os.path.join(tmp, "sr_seg")
    fold = get_acdc_fold_patient_ids(0, "validation")[:SR_SEG_PATIENTS]
    for num, src_pid in zip(fold, pids):
        pid = f"patient{num:03d}"
        imgs, refs = [], []
        for phase, fr in (("ED", 1), ("ES", 12)):
            stem = os.path.join(src, src_pid, f"{src_pid}_frame{fr:02d}")
            img = read_image(stem + ".nii.gz")[0]
            gt = read_image(stem + "_gt.nii.gz")[0].astype(np.int32)
            pred = create_super_volume(
                lbl_trainer, rescale_intensities(img, percs=(1, 99)),
                alpha_range=[0.5], downsample_steps=2,
                generate_inbetween_slices=True,
                labels=gt)["upsampled_labels"]
            if pred.shape != gt.shape:
                raise AssertionError(f"decoded labels {pred.shape} vs "
                                     f"{gt.shape}")
            for sub, arr in (("sr_seg_pred", pred), ("sr_seg_self", gt)):
                d = os.path.join(tmp, sub, "pred_labels")
                os.makedirs(d, exist_ok=True)
                write_image(os.path.join(d, f"{pid}_{phase}.nii.gz"), arr,
                            spacing=ACDC_SPACING, dtype=np.int32)
            imgs.append(img)
            refs.append(gt)
        for sub, arr, dt in (("images_sr", np.stack(imgs), None),
                             ("ref_labels", np.stack(refs), np.int32)):
            os.makedirs(os.path.join(sr_root, sub), exist_ok=True)
            write_image(os.path.join(sr_root, sub, f"{pid}.nii.gz"), arr,
                        spacing=ACDC_SPACING, dtype=dt)
    del lbl_trainer
    _free_cuda()
    res, out["sr_seg_s"] = timed(lambda: evaluate_sr_segmentation(
        os.path.join(tmp, "sr_seg_pred"), sr_root, fold=0,
        limited_load=True))
    selfres = evaluate_sr_segmentation(os.path.join(tmp, "sr_seg_self"),
                                       sr_root, fold=0, limited_load=True)
    table = {s: {m: round(v[0], 4) for m, v in ms.items()}
             for s, ms in res["aggregate"].items()}
    out["sr_seg"] = table
    log(f"prep SR segmentation: {len(res['per_case'])} cases "
        f"({SR_SEG_PATIENTS} patients x ED/ES {LABELED_SHAPE}) in "
        f"{out['sr_seg_s']:.2f} s; mean Dice / HD95 / ASSD (mm) "
        f"{json.dumps(table)} [{card}]")
    self_ok = all(c[s]["dice"] == 1.0 and c[s]["hd95"] == 0.0
                  and c[s]["assd"] == 0.0
                  for c in selfres["per_case"].values() for s in c)
    if len(res["per_case"]) != 2 * SR_SEG_PATIENTS or not self_ok:
        raise AssertionError("SR segmentation scoring failed its "
                             "self-check (references against themselves)")

    # 5. the perceptual tools: fit the encoder artifact on phase 8's
    # OASIS experiment, gate it with the distortion study, convert
    # torchvision-layout VGG16 + lin weights
    exper = os.path.join(tmp, "oasis_cache")
    enc_npz = os.path.join(tmp, "perceptual_enc.npz")
    (meta, lins), out["fit_s"] = timed(lambda: fit_perceptual_head.main(
        ["--exper_dir", exper, "--out", enc_npz] + PERCEPT_ARGV))
    out["rank_accuracy"] = meta["fit"]["rank_accuracy"]
    gap, out["gap_s"] = timed(lambda: lpips_gap_study.main(
        ["--enc_npz", enc_npz, "--json_out", os.path.join(tmp, "gap.json")]
        + PERCEPT_ARGV))
    out["spearman"] = {k: v["mean"] for k, v in gap["spearman"].items()}
    log(f"prep perceptual tools: fit_s {out['fit_s']:.2f}, rank accuracy "
        f"{out['rank_accuracy']:.4f} over {meta['fit']['pairs']} pairs, "
        f"gap_s {out['gap_s']:.2f}, Spearman {json.dumps(out['spearman'])}"
        f" [{card}]")
    if not (all(np.isfinite(lw).all() and (lw >= 0).all() for lw in lins)
            and all(np.isfinite(v) for v in out["spearman"].values())):
        raise AssertionError("the fitted lins or the gap study's table "
                             "are not finite")

    # card against CPU: the lins fitted on one fit set, the distortion
    # study's per-pair distances of the same slices
    cfg, variables, _ = fit_perceptual_head.harvest_encoder(exper, "caisr",
                                                            dev)
    data = fit_perceptual_head.build_fit_set(2, 64, device="cpu")
    fitted = [fit_perceptual_head.fit_lins(enc_perceptual_params(
        cfg, variables, uniform_lins(cfg), device=d), data)[0]
        for d in (dev, "cpu")]
    out["fit_card_vs_cpu_rel"] = float(np.abs(fitted[0] - fitted[1]).max()
                                       / np.abs(fitted[1]).max())
    suite = lpips_gap_study.distortion_suite(np.random.RandomState(seed))
    weights = [(d, lpips.get_lpips_params(device=d),
                lpips_gap_study.load_enc_perceptual(enc_npz, d))
               for d in (dev, "cpu")]
    pair_rel = 0.0
    for sl in lpips_gap_study.reference_slices(2, 64):
        dists = lpips_gap_study.distorted(sl, suite)
        rows = [lpips_gap_study.score_suite(
            sl, dists, params, enc, lpips_gap_study.msssim_levels(64), d)
            for d, params, enc in weights]
        for k, want in rows[1].items():
            want = np.asarray(want)
            pair_rel = max(pair_rel, float(np.abs(
                np.asarray(rows[0][k]) - want).max() / np.abs(want).max()))
    out["gap_card_vs_cpu_rel"] = pair_rel
    log(f"prep perceptual tools card vs CPU: fitted lins rel "
        f"{out['fit_card_vs_cpu_rel']:.3e} (limit {TOOLS_FIT_RTOL}), "
        f"gap-study per-pair distances rel {pair_rel:.3e} (limit "
        f"{LPIPS_CARD_RTOL})")
    if not (out["fit_card_vs_cpu_rel"] <= TOOLS_FIT_RTOL
            and pair_rel <= LPIPS_CARD_RTOL):
        raise AssertionError("the perceptual tools differ on the card")

    vgg, lin = _torchvision_vgg16(seed + 15)
    paths = {k: os.path.join(tmp, f"{k}.pth") for k in ("vgg16", "lin")}
    torch.save(vgg, paths["vgg16"])
    torch.save(lin, paths["lin"])
    converted = os.path.join(tmp, "lpips_vgg.npz")
    _, out["convert_s"] = timed(lambda: convert_lpips_weights.main(
        ["--vgg16", paths["vgg16"], "--lin", paths["lin"], "--out",
         converted]))
    resolved = lpips.get_lpips_params(converted, device=dev)
    mode = lpips.lpips_weights_info()["mode"]
    direct = lpips._device({
        "convs": [{"kernel": vgg[f"features.{i}.weight"].numpy().transpose(
            2, 3, 1, 0), "bias": vgg[f"features.{i}.bias"].numpy()}
            for i in convert_lpips_weights._VGG16_CONV_IDX],
        "lins": [{"kernel": lin[f"lin{k}.model.1.weight"].numpy()
                  .transpose(2, 3, 1, 0)} for k in range(len(lin))]}, dev)
    pair = torch.from_numpy(phantom(seed + 16, 8, 128, 128)).to(dev)[:, None]
    got = lpips.lpips_distance(resolved, pair[:4], pair[4:])
    want = lpips.lpips_distance(direct, pair[:4], pair[4:])
    out["convert_lpips_max_abs_diff"] = float((got - want).abs().max())
    log(f"prep convert-lpips-weights: {out['convert_s']:.2f} s, mode "
        f"{mode}; lpips_distance with the converted params against the "
        f"same arrays passed directly: max |Δ| "
        f"{out['convert_lpips_max_abs_diff']:.3e} (limit 0)")
    if mode != "converted" or out["convert_lpips_max_abs_diff"] != 0.0:
        raise AssertionError("the converted LPIPS weights differ")

    out["phase_s"] = time.perf_counter() - t_phase
    log(f"prep timings [{card}]: " + json.dumps(out))
    return out


# ---------------------------------------------------------------------------
# phase 16: data-parallel training and sharded serving (parallel/), the
# packed decoder
# ---------------------------------------------------------------------------

def _dp_spec() -> dict:
    """What phase 16's ranks build (passed to them: a spawned rank
    imports this module afresh)."""
    return dict(args=DP_ARGS, hw=HW, slices=HR_SLICES, patch=TRAIN_PATCH,
                ds=TRAIN_DS, steps=DP_STEPS)


def _sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _dp_batches(seed: int, steps: int, device, spec: dict) -> list:
    """Phase 16's global batches: the OASIS recipe's 16 pairs of 64²
    crops (phase 5's data) as septets for ``lanczos3``, the same on
    every rank that builds them."""
    from superresolution_aniso_mri_tpu_torch.data import (
        AugmentConfig, TripletSampler, Volume, device_batch)

    hw = spec["hw"]
    vols = [Volume(image=phantom(seed + 100 + i, spec["slices"], hw, hw),
                   spacing=np.array([1.0, 1.0, 1.0])) for i in range(4)]
    sampler = TripletSampler(vols, spec["ds"], "adjacent_plus", pad_size=hw,
                             seed=seed, latent_taps=6)
    aug = AugmentConfig(patch_size=spec["patch"], aug_patch_size=hw,
                        random_crop=False, rot90=False, intensity=False)
    return [device_batch(sampler.sample_batch(spec["args"]["batch_size"]),
                         aug, device, latent_taps=6) for _ in range(steps)]


def _permuted(batch: dict, perm) -> dict:
    """``batch`` with its pairs in the order ``perm`` (both halves of a
    ``[2B]`` leaf): the same step, other float32 reduction orders."""
    import torch

    b = batch["slice_between"].shape[0]
    return {k: v[perm] if v.shape[0] == b
            else torch.cat([v[:b][perm], v[b:][perm]])
            for k, v in batch.items()}


def _record_steps(trainer, batches) -> dict:
    """``trainer.train`` on each batch: loss_ae per step, the gradient
    that reaches the optimizer at step 1 (all-reduced on a rank), θ0 and
    θ after the last step, the mean host ms per step (synchronised) and
    the mean of the steps after the first (``warm_ms``: the first builds
    cuDNN's plans and the lazily made state)."""
    tx, seen = trainer.state.tx, {}
    apply = tx.apply

    def recording(params, grads, state, scalars):
        if not seen:
            seen.update({k: g.detach().cpu().numpy()
                         for k, g in grads.items()})
        return apply(params, grads, state, scalars)

    # a copy: on the CPU ``.cpu().numpy()`` shares the parameter's memory
    theta0 = {k: p.detach().cpu().numpy().copy()
              for k, p in trainer.state.params().items()}
    tx.apply = recording
    losses = []
    try:
        _sync(trainer.device)
        t0 = time.perf_counter()
        for i, b in enumerate(batches):
            losses.append(trainer.train(b)["loss_ae"])
            if i == 0:
                _sync(trainer.device)
                t1 = time.perf_counter()
        _sync(trainer.device)
        t2 = time.perf_counter()
    finally:
        tx.apply = apply
    n = len(batches)
    out = {"loss": np.array([float(v) for v in losses]),
           "ms": np.float64((t2 - t0) * 1e3 / n),
           "warm_ms": np.float64((t2 - t1) * 1e3 / max(n - 1, 1))}
    for k, p in trainer.state.params().items():
        out[f"theta0/{k}"] = theta0[k]
        out[f"theta/{k}"] = p.detach().cpu().numpy()
        out[f"grad/{k}"] = seen[k]
    return out


def _dp_rank(out_dir: str, seed: int, device: str, spec: dict) -> None:
    """Phase 16c on one rank: the data-parallel ``Trainer`` on the global
    batches, its experiment in ``exper_r<rank>`` (only rank 0's may
    exist afterwards); rank 0 keeps the trajectory."""
    import torch

    from superresolution_aniso_mri_tpu_torch.parallel import (process_count,
                                                              process_index)
    from superresolution_aniso_mri_tpu_torch.train import Trainer

    # the same convolution algorithms as the single-process runs it is
    # held against (``_single_and_noise``)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    rank = process_index()
    trainer = Trainer(dict(spec["args"], num_devices=process_count(),
                           output_dir=os.path.join(out_dir,
                                                   f"exper_r{rank}"),
                           seed=seed, epochs=1, epoch_threshold=0),
                      device=device)
    batches = _dp_batches(seed, spec["steps"], trainer.device, spec)
    trainer.prepare_run()
    rec = _record_steps(trainer, batches)
    trainer.validate(batches[0])
    trainer.show_loss_on_tensorboard("train")
    trainer.show_loss_on_tensorboard("test")
    trainer.end_epoch_processing()
    if rank == 0:
        np.savez(os.path.join(out_dir, "dp.npz"), **rec)


def _nccl_rank(out_dir: str, seed: int, device: str, spec: dict) -> None:
    """Phase 16d on a one-rank NCCL group: one ``make_sharded_train_step``
    step against ``make_train_step`` from the same weights and batch."""
    from superresolution_aniso_mri_tpu_torch.parallel import (
        create_mesh, make_sharded_train_step)
    from superresolution_aniso_mri_tpu_torch.train import Trainer

    import torch

    # the same convolution algorithms in both runs: cuDNN's default ones
    # differ between two runs of one step by up to 1.5e-6 of a leaf's
    # largest gradient on the card (measured), more than this check's
    # limit
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    batch = _dp_batches(seed, 1, create_mesh()[0], spec)
    recs = []
    for sharded in (True, False):
        trainer = Trainer(dict(spec["args"], seed=seed), device=device)
        if sharded:
            trainer.train_step = make_sharded_train_step(
                trainer.loss_config, None, create_mesh())
        recs.append(_record_steps(trainer, batch))
    np.savez(os.path.join(out_dir, "nccl.npz"),
             **{f"{tag}/{k}": v for tag, rec in zip(("sharded", "single"),
                                                     recs)
                for k, v in rec.items()})


def _leaf_gap(got: dict, want: dict, prefix: str, mask=None) -> float:
    """The largest over the leaves of max |got − want| / max |want|
    (``mask(leaf)``: the entries to compare)."""
    worst = 0.0
    for k in want:
        if not k.startswith(prefix):
            continue
        a, b = got[k], want[k]
        sel = np.ones(b.shape, bool) if mask is None else mask(k[len(prefix):])
        if sel.any():
            worst = max(worst, float(np.abs(a - b)[sel].max()
                                     / max(np.abs(b).max(), 1e-30)))
    return worst


def _trajectory_gaps(run: dict, single: dict) -> dict:
    """The largest relative gaps of a ``_record_steps`` run to the single
    process's: the loss of every step, the step-1 gradient, θ − θ0
    after the last (N-th) step as ``thetaN`` (all entries, and those
    whose step-1 gradient is resolved: at least 1e-3 of its leaf's
    largest)."""
    theta_key = f"theta{len(single['loss'])}"
    resolved = {k[len("grad/"):]: np.abs(v) >= 1e-3 * np.abs(v).max()
                for k, v in single.items() if k.startswith("grad/")}
    steps = {k: run[k] - run["theta0/" + k[len("theta/"):]]
             for k in run if k.startswith("theta/")}
    steps_1 = {k: single[k] - single["theta0/" + k[len("theta/"):]]
               for k in single if k.startswith("theta/")}
    return {"loss": float(np.max(np.abs(run["loss"] - single["loss"])
                                 / np.abs(single["loss"]))),
            "grad1": _leaf_gap(run, single, "grad/"),
            theta_key: _leaf_gap(steps, steps_1, "theta/"),
            f"{theta_key}_resolved": _leaf_gap(steps, steps_1, "theta/",
                                               resolved.get)}


def _single_and_noise(batches, seed: int, dev) -> tuple:
    """Phase 16's recipe (``DP_ARGS``) in one process on ``batches``,
    and the float32 reordering noise: the largest gaps to that run
    (``_trajectory_gaps``) over ``MESH2D_PERMUTATIONS`` runs on the
    batches with their pairs permuted (seeds ``seed + i``). Every run
    with cuDNN's deterministic algorithms. Phases 16c and 17a gate their
    multi-rank trajectories on it (``_beyond_noise``): the loss after a
    few Adam steps moves by chance, and one permuted run is too small a
    sample of it."""
    import torch

    from superresolution_aniso_mri_tpu_torch.train import Trainer

    def trajectory(bs):
        return _record_steps(Trainer(dict(DP_ARGS, seed=seed), device=dev),
                             bs)

    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        single = trajectory(batches)
        shuffled = [trajectory([_permuted(b, torch.randperm(
            DP_ARGS["batch_size"], generator=torch.Generator().manual_seed(
                seed + i)).to(dev)) for b in batches])
            for i in range(MESH2D_PERMUTATIONS)]
    finally:
        torch.backends.cudnn.deterministic = deterministic
    gaps = [_trajectory_gaps(r, single) for r in shuffled]
    return single, {k: max(g[k] for g in gaps) for k in gaps[0]}


def _beyond_noise(gap: dict, noise: dict) -> list:
    """The gaps above 3× the permuted run's (θ after the Adam steps: an
    entry near a zero gradient moves by ±lr a step with the sign of that
    noise, hence the wider margin), and a step-1 gradient above 1e-2."""
    bad = [k for k in gap if not gap[k] <= 3 * noise[k] + (
        0.05 if k.startswith("theta") else 1e-6)]
    if not gap["grad1"] <= 1e-2:
        bad.append("grad1")
    return bad


def check_parallel(seed: int, card: str, dev) -> dict:
    """Phase 16 (see the module docstring): the numbers of the
    ``parallel`` line and the SSIM launches of the sharded serve →
    score path."""
    import tempfile

    import torch

    from superresolution_aniso_mri_tpu_torch import parallel
    from superresolution_aniso_mri_tpu_torch.cli import entry
    from superresolution_aniso_mri_tpu_torch.device import f32_exact
    from superresolution_aniso_mri_tpu_torch.evaluate import (
        compute_volume_metrics)
    from superresolution_aniso_mri_tpu_torch.infer import (
        ServingModel, create_super_volume)
    from superresolution_aniso_mri_tpu_torch.infer import super_volume as sv
    from superresolution_aniso_mri_tpu_torch.infer.packed_decoder import (
        make_packed_decoder)
    from superresolution_aniso_mri_tpu_torch.models import AEConfig

    t_phase = time.perf_counter()
    out: dict = {"launches": {}, "kernel_err": 0.0}
    mesh = parallel.create_mesh([dev, dev])
    alphas = np.linspace(0, 1, DS + 1)[1:-1].astype(np.float32)
    alphas_t = torch.from_numpy(alphas).to(dev)
    hr = phantom(seed + 16, s=(DP_KEPT - 1) * DS + 1)
    f32 = ServingModel(AEConfig(**BENCH_CFG, compute_dtype="float32"),
                       device=dev,
                       generator=torch.Generator().manual_seed(seed + 16))
    models = {"float32": f32, "bfloat16": ServingModel(
        AEConfig(**BENCH_CFG, compute_dtype="bfloat16"),
        f32._ae_model().state_dict(), device=dev)}

    # a. the slice axis over [cuda:0, cuda:0]: 29 kept slices padded to 30
    for dtype, model in models.items():
        for interp in ("linear", "lanczos3"):
            kept = sv._pad_kept(hr[::DS, None], DP_KEPT + 1, interp)
            kept_t = torch.from_numpy(kept).to(dev)
            got = parallel.make_sharded_synthesizer(
                model._ae_model(), mesh, decode_batch=32,
                latent_interp=interp)(kept_t, alphas_t)
            want = sv.make_synthesis_core(model._ae_model(), 32,
                                          latent_interp=interp)(kept_t,
                                                                alphas_t)
            gap = max(float((got[k][:DP_KEPT - (k == "interp")]
                             - want[k][:DP_KEPT - (k == "interp")])
                            .abs().max()) for k in ("recon", "interp"))
            out[f"slice_sharded_{interp}_{dtype}_max_abs_diff"] = gap
            limit = 1e-4 if dtype == "float32" else 1.0 / 64
            if not gap <= limit:
                raise AssertionError(f"slice-sharded serving ({interp}, "
                                     f"{dtype}) differs by {gap}")
            if dtype == "float32" and interp == "lanczos3":
                vol = sv.interleave_volume(got["recon"][:DP_KEPT],
                                           got["interp"][:DP_KEPT - 1])
                vol = vol.clamp(0, 1)[:, 0].cpu().numpy()

                def score(vol=vol):
                    return compute_volume_metrics(hr, vol,
                                                  downsample_steps=DS)
                scores, n, err, _ = _counted_scoring(score, "phase 16 sharded")
                _finite(scores, "phase 16 sharded scores")
                if not err <= PARALLEL_SSIM_ATOL:
                    raise AssertionError(f"phase 16 SSIM pair: {err}")
                out["launches"]["parallel_sharded_serve_score"] = n
                out["kernel_err"] = max(out["kernel_err"], err)
                out["sharded_scores"] = scores
    log(f"parallel a: slice-sharded vs unsharded [{card}]: " + json.dumps(
        {k: v for k, v in out.items() if k.startswith("slice_")}))

    # b. the volume axis: 3 volumes, the last repeated to 4
    model = models["float32"]
    kept = np.stack([sv._pad_kept(phantom(seed + 17 + i)[::DS, None], 30,
                                  "linear") for i in range(3)])
    stack = torch.from_numpy(np.concatenate([kept, kept[-1:]])).to(dev)
    got = parallel.make_sharded_batched_synthesizer(
        model._ae_model(), mesh, decode_batch=32)(stack, alphas_t)
    want = sv.make_batched_synthesizer(model._ae_model(), 32)(stack,
                                                              alphas_t)
    out["volume_sharded_max_abs_diff"] = float((got[:3] - want[:3])
                                               .abs().max())
    n_dev = torch.cuda.device_count() if dev.type == "cuda" else 2
    pub = create_super_volume(model, hr, alpha_range=alphas,
                              downsample_steps=DS, num_devices=n_dev,
                              generate_inbetween_slices=True)
    if not np.isfinite(pub["upsampled_image"]).all():
        raise AssertionError("create_super_volume(num_devices) non-finite")
    if dev.type == "cuda":
        try:
            create_super_volume(model, hr, downsample_steps=DS,
                                num_devices=n_dev + 1)
        except ValueError as exc:
            log(f"parallel b: num_devices={n_dev + 1} raises: {exc}")
        else:
            raise AssertionError(f"num_devices={n_dev + 1} did not raise")
    if not out["volume_sharded_max_abs_diff"] <= 1e-4:
        raise AssertionError("volume-sharded serving differs: "
                             f"{out['volume_sharded_max_abs_diff']}")
    log(f"parallel b: volume-sharded (3 → 4 volumes) vs unsharded "
        f"max_abs_diff={out['volume_sharded_max_abs_diff']:.3e}")

    with tempfile.TemporaryDirectory() as tmp:
        # c. two ranks on cuda:0 over gloo, through the CLI's launcher
        t0 = time.perf_counter()
        parallel.launch(_dp_rank, (tmp, seed, dev.type, _dp_spec()), mesh,
                        "gloo", timeout_s=300, join_timeout_s=600)
        out["dp_launch_s"] = time.perf_counter() - t0
        with np.load(os.path.join(tmp, "dp.npz")) as f:
            dp = dict(f)
        if os.path.exists(os.path.join(tmp, "exper_r1")):
            raise AssertionError("rank 1 wrote into its experiment "
                                 "directory")
        if "last.models" not in os.listdir(os.path.join(tmp, "exper_r0",
                                                        "models")):
            raise AssertionError("rank 0 wrote no last.models")
        # the single-process trajectory on the same global batches, and
        # the float32 reordering noise of this network on the card (the
        # 2-rank run's halves sum in another order), all runs with
        # cuDNN's deterministic algorithms
        batches = _dp_batches(seed, DP_STEPS, dev, _dp_spec())
        single, noise = _single_and_noise(batches, seed, dev)
        dp_gap = _trajectory_gaps(dp, single)
        out.update(
            dp_loss=dp["loss"].tolist(), single_loss=single["loss"].tolist(),
            **{f"dp_{k}_max_rel_gap": v for k, v in dp_gap.items()},
            **{f"permuted_{k}_max_rel_gap": v for k, v in noise.items()},
            dp_ms_per_step_two_ranks_one_card_gloo=float(dp["ms"]),
            single_ms_per_step=float(single["ms"]))
        log(f"parallel c: 2 ranks on cuda:0 (gloo) vs 1 process, "
            f"{DP_STEPS} steps [{card}]: max rel gaps {json.dumps(dp_gap)}; "
            f"the single process on the pairs permuted "
            f"{MESH2D_PERMUTATIONS} ways {json.dumps(noise)}; cuDNN "
            f"deterministic; losses {dp['loss'].round(6).tolist()}")
        bad = _beyond_noise(dp_gap, noise)
        if bad:
            raise AssertionError(f"the 2-rank trajectory differs from the "
                                 f"single-process one beyond the reordering "
                                 f"noise: {bad}")

        # d. a one-rank NCCL group; the CLI's --num_devices 1 path
        parallel.launch(_nccl_rank, (tmp, seed, dev.type, _dp_spec()),
                        mesh[:1], "nccl" if dev.type == "cuda" else "gloo",
                        timeout_s=300, join_timeout_s=300)
        with np.load(os.path.join(tmp, "nccl.npz")) as f:
            nc = dict(f)
        sh = {k[len("sharded/"):]: v for k, v in nc.items()
              if k.startswith("sharded/")}
        sg = {k[len("single/"):]: v for k, v in nc.items()
              if k.startswith("single/")}
        out["nccl_one_rank_grad_max_rel_gap"] = _leaf_gap(sh, sg, "grad/")
        out["nccl_one_rank_loss_rel_gap"] = float(
            abs(sh["loss"][0] - sg["loss"][0]) / abs(sg["loss"][0]))
        log(f"parallel d: one-rank NCCL sharded step vs make_train_step: "
            f"grad {out['nccl_one_rank_grad_max_rel_gap']:.3e}, loss "
            f"{out['nccl_one_rank_loss_rel_gap']:.3e}")
        if not (out["nccl_one_rank_grad_max_rel_gap"] <= 1e-6
                and out["nccl_one_rank_loss_rel_gap"] <= 1e-6):
            raise AssertionError("the one-rank NCCL step differs")
        tr = entry.train_brain(_cli_train_argv(
            tmp, "nd1", SMALL_CFG, 1, ("--num_devices", "1",
                                       "--downsample_steps", "2")))
        if tr.epoch != 1 or tr.mesh is not None:
            raise AssertionError("train-brain --num_devices 1")

    # e. packed against unpacked decode at the bench config
    z = None
    for dtype, model in models.items():
        ae = model._ae_model()
        with torch.inference_mode(), f32_exact():
            if z is None:
                x = torch.from_numpy(hr[:DP_DECODE, None].copy()).to(dev)
                z = ae.encode(x)
            packed = make_packed_decoder(ae)
            times = {"plain": [], "packed": []}
            for i in range(21):
                for name, fn in (("plain", ae.decode), ("packed", packed)):
                    start = torch.cuda.Event(enable_timing=True)
                    end = torch.cuda.Event(enable_timing=True)
                    start.record()
                    y = fn(z)
                    end.record()
                    end.synchronize()
                    if i:
                        times[name].append(start.elapsed_time(end))
            gap = float((packed(z) - ae.decode(z)).abs().max())
        out[f"packed_{dtype}_max_abs_diff"] = gap
        out[f"decode_{dtype}_ms"] = float(np.median(times["plain"]))
        out[f"packed_decode_{dtype}_ms"] = float(np.median(times["packed"]))
        del y
        if not gap <= (1e-4 if dtype == "float32" else 1.0 / 64):
            raise AssertionError(f"packed decode ({dtype}) differs: {gap}")
    log(f"parallel e: decode of {DP_DECODE} latents at the bench config "
        f"(medians of 20) [{card}]: " + json.dumps(
            {k: v for k, v in out.items() if "decode" in k or "packed" in k}))
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"parallel: phase 16 {out['phase_s']:.1f} s")
    return out


def _mesh2d_rank(out_dir: str, seed: int, device: str, spec: dict) -> None:
    """Phase 17a on one rank of a dp 1 × mp N group: phase 16's recipe
    through ``make_sharded_train_step_2d``; rank 0 keeps the trajectory
    with the whole step-1 gradient and θ gathered from the shards, and
    the shapes of its shards."""
    import torch

    from superresolution_aniso_mri_tpu_torch import parallel
    from superresolution_aniso_mri_tpu_torch.parallel import distributed
    from superresolution_aniso_mri_tpu_torch.train import Trainer

    # the same convolution algorithms in every run (as phase 16d): the
    # gaps to the single process are then those of the split alone
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    mesh = parallel.create_mesh_2d(dp=1, mp=parallel.process_count())
    trainer = Trainer(dict(spec["args"], seed=seed), device=device)
    theta0 = {k: p.detach().cpu().numpy().copy()
              for k, p in trainer.state.params().items()}
    rule = parallel.state_sharding_2d(mesh, trainer.state)
    parallel.shard_state_2d(mesh, trainer.state)
    trainer.train_step = parallel.make_sharded_train_step_2d(
        trainer.loss_config, None, mesh)
    batches = _dp_batches(seed, spec["steps"], trainer.device, spec)
    rec = _record_steps(trainer, batches)
    _, group = distributed.mesh_groups(mesh.dp, mesh.mp)
    full = parallel.gather_state_2d(mesh, trainer.state)
    out = {"loss": rec["loss"], "ms": rec["ms"], "warm_ms": rec["warm_ms"]}
    for k, dim in rule.items():
        g = rec[f"grad/{k}"]
        if dim is not None:
            out[f"shard/{k}"] = np.array(g.shape)
            g = distributed.gather_shards(
                torch.from_numpy(g).to(trainer.device), dim,
                group).cpu().numpy()
        out[f"grad/{k}"] = g
        out[f"theta0/{k}"] = theta0[k]
        out[f"theta/{k}"] = full.params()[k].detach().cpu().numpy()
        out[f"split/{k}"] = np.int64(-1 if dim is None else dim)
    # every rank's replicated parameters and BatchNorm statistics, which
    # must be the same bits on every rank of the model group
    own = {f"replicated/{k}": p.detach().cpu().numpy()
           for k, p in trainer.state.params().items() if rule[k] is None}
    own.update({f"buffer/{k}": v.cpu().numpy()
                for k, v in trainer.state.model.named_buffers()})
    rank = parallel.process_index()
    np.savez(os.path.join(out_dir, f"replicas.r{rank}.npz"), **own)
    if rank == 0:
        np.savez(os.path.join(out_dir, "mesh2d.npz"), **out)


def check_mesh2d(seed: int, card: str, dev) -> dict:
    """Phase 17a (see the module docstring): the 2-D step on
    ``[cuda:0, cuda:0]`` against the single process."""
    import tempfile

    from superresolution_aniso_mri_tpu_torch import parallel

    spec = dict(_dp_spec(), steps=MESH2D_STEPS)
    out: dict = {}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        parallel.launch(_mesh2d_rank, (tmp, seed, dev.type, spec),
                        [dev, dev], "gloo", timeout_s=300,
                        join_timeout_s=600)
        out["mesh2d_launch_s"] = time.perf_counter() - t0
        with np.load(os.path.join(tmp, "mesh2d.npz")) as f:
            run = dict(f)
        replicas = []
        for r in range(2):
            with np.load(os.path.join(tmp, f"replicas.r{r}.npz")) as f:
                replicas.append(dict(f))
    if sorted(replicas[0]) != sorted(replicas[1]) or any(
            not np.array_equal(v, replicas[1][k])
            for k, v in replicas[0].items()):
        raise AssertionError("the model ranks' replicated parameters or "
                             "BatchNorm statistics differ after the steps")
    out["mesh2d_replicas_bit_equal"] = len(replicas[0])
    single, noise = _single_and_noise(
        _dp_batches(seed, MESH2D_STEPS, dev, spec), seed, dev)
    split = {k[len("split/"):]: int(v) for k, v in run.items()
             if k.startswith("split/")}
    for k, dim in split.items():
        if dim >= 0 and not (run[f"shard/{k}"][dim] * 2
                             == run[f"grad/{k}"].shape[dim]):
            raise AssertionError(f"{k}: the shard is not half the channels")
    gap = _trajectory_gaps(run, single)
    out.update(
        mesh2d_split_leaves=sum(d >= 0 for d in split.values()),
        mesh2d_replicated_leaves=sum(d < 0 for d in split.values()),
        mesh2d_loss=run["loss"].tolist(), single_loss=single["loss"].tolist(),
        **{f"mesh2d_{k}_max_rel_gap": v for k, v in gap.items()},
        **{f"permuted_{k}_max_rel_gap": v for k, v in noise.items()},
        mesh2d_ms_per_step_mp2_one_card_gloo=float(run["warm_ms"]),
        single_ms_per_step=float(single["warm_ms"]),
        mesh2d_first_step_ms=float(run["ms"] * MESH2D_STEPS
                                   - run["warm_ms"] * (MESH2D_STEPS - 1)))
    log(f"mesh2d a: dp 1 x mp 2 on [{dev}, {dev}] (gloo) vs 1 process, "
        f"{MESH2D_STEPS} steps [{card}]: max rel gaps {json.dumps(gap)}; "
        f"the single process on the pairs permuted "
        f"{MESH2D_PERMUTATIONS} ways {json.dumps(noise)}; "
        f"{out['mesh2d_split_leaves']} kernels split, "
        f"{out['mesh2d_replicated_leaves']} leaves replicated, "
        f"{out['mesh2d_replicas_bit_equal']} replicated tensors the same "
        f"bits on both ranks; cuDNN deterministic; ms/step "
        f"after the first {run['warm_ms']:.1f} (2-D) vs "
        f"{single['warm_ms']:.1f} (one process)")
    bad = _beyond_noise(gap, noise)
    if bad:
        raise AssertionError(f"the 2-D trajectory differs from the "
                             f"single-process one beyond the reordering "
                             f"noise: {bad}")
    return out


@contextlib.contextmanager
def _loader(mode: str):
    """``SRL_DISABLE_NATIVE`` set inside the block when ``mode`` is
    ``numpy``, unset when it is ``native``."""
    os.environ.pop("SRL_DISABLE_NATIVE", None)
    if mode == "numpy":
        os.environ["SRL_DISABLE_NATIVE"] = "1"
    try:
        yield
    finally:
        os.environ.pop("SRL_DISABLE_NATIVE", None)


def check_native_loader(tmp: str, seed: int, card: str) -> dict:
    """Phase 17b (see the module docstring), on phase 8's OASIS tree."""
    import glob

    from superresolution_aniso_mri_tpu_torch.cli import entry
    from superresolution_aniso_mri_tpu_torch.data import (TripletSampler,
                                                          native_loader)
    from superresolution_aniso_mri_tpu_torch.data.datasets import (
        _read_images_parallel, load_brain_volumes)
    from superresolution_aniso_mri_tpu_torch.tools.loader_bench import host
    from superresolution_aniso_mri_tpu_torch.utils import read_image

    t_phase = time.perf_counter()
    turns = ("numpy", "native", "native", "numpy")
    out: dict = {"host": host()}
    t0 = time.perf_counter()
    if not native_loader.available():
        raise AssertionError("the native loader did not build")
    out["native_build_s"] = time.perf_counter() - t0

    # decode and directory ingest: every OASIS file, bit for bit
    paths = sorted(glob.glob(os.path.join(
        os.environ["SR_DATA_ROOT"], "OASIS", "nifti", "*", "*.nii.gz")))
    for p, (arr, spacing, affine) in zip(
            paths, native_loader.read_nifti_many(paths)):
        want = read_image(p)
        if not (np.array_equal(arr, want[0].astype(np.float32))
                and np.array_equal(spacing, want[1])
                and (affine is None) == (want[2] is None)
                and (affine is None or np.array_equal(affine, want[2]))):
            raise AssertionError(f"native decode of {p} differs")
    out["decoded_files"] = len(paths)
    # the native ingest against the loaders' Python thread pool
    ingest = {"native": [], "numpy": []}
    readers = {"native": native_loader.read_nifti_many,
               "numpy": _read_images_parallel}
    for mode in turns:
        t0 = time.perf_counter()
        readers[mode](paths)
        ingest[mode].append(time.perf_counter() - t0)

    # the gather: the recipe's batches, bit for bit; host ms a batch
    vols = load_brain_volumes("OASIS", OASIS_DS, "training")
    batch = int(OASIS_ARGV[OASIS_ARGV.index("-b") + 1])
    samplers, batches = {}, {}
    for mode in ("native", "numpy"):
        with _loader(mode):
            samplers[mode] = TripletSampler(vols, OASIS_DS, pad_size=220,
                                            seed=seed)
            batches[mode] = [samplers[mode].sample_batch(batch)
                             for _ in range(3)]
    for a, b in zip(batches["native"], batches["numpy"]):
        for k in b:
            if not np.array_equal(a[k], b[k]):
                raise AssertionError(f"native gather: batch key {k} differs")
    assembly = {"native": [], "numpy": []}
    for mode in turns:
        with _loader(mode):
            for _ in range(20):
                t0 = time.perf_counter()
                samplers[mode].sample_batch(batch)
                assembly[mode].append((time.perf_counter() - t0) * 1e3)

    # the uncached OASIS recipe, one epoch a run
    steps = {"native": [], "numpy": []}
    for i, mode in enumerate(turns):
        exper = f"oasis_loader_{i}"
        with _loader(mode):
            res = _train_timed(entry.train_brain, _with_epochs(
                OASIS_ARGV, 1) + ["-o", tmp, "-id", exper,
                                  "--device_data_cache", "0"],
                os.path.join(tmp, exper))
        if set(res["samplers"]) != {"TripletSampler"}:
            raise AssertionError(f"the uncached recipe ran {res['samplers']}")
        steps[mode].append(res["ms_per_step"])
    for name, book in (("ingest_s", ingest), ("assembly_ms", assembly),
                       ("uncached_ms_per_step", steps)):
        for mode, v in book.items():
            out[f"{name}_{mode}"] = float(np.median(v))
    out["uncached_ms_per_step_runs"] = steps
    out["loader_phase_s"] = time.perf_counter() - t_phase
    log(f"native loader b [{card}; host {out['host']}]: {len(paths)} OASIS "
        f"files decoded bit for bit, gather bit for bit; medians native / "
        f"numpy: ingest s {out['ingest_s_native']:.3f} / "
        f"{out['ingest_s_numpy']:.3f}, batch assembly ms "
        f"{out['assembly_ms_native']:.3f} / {out['assembly_ms_numpy']:.3f}, "
        f"uncached recipe ms/step {out['uncached_ms_per_step_native']:.3f} / "
        f"{out['uncached_ms_per_step_numpy']:.3f}")
    return out


def _figure_pages(fig_dir: str, dev) -> list:
    """Draw every public figure function of the port once into
    ``fig_dir`` from small seeded inputs; the files written."""
    from superresolution_aniso_mri_tpu_torch.evaluate import (
        journal2, plots, spie2021)
    from superresolution_aniso_mri_tpu_torch.utils import loss_curves

    rng = np.random.RandomState(0)
    vol = rng.rand(8, 24, 24).astype(np.float32)
    vol2 = np.clip(vol + 0.1 * rng.randn(*vol.shape), 0, 1).astype(np.float32)
    v4d = rng.rand(2, 8, 24, 24).astype(np.float32)
    metrics = ("ssim", "psnr", "vif")
    res = {m: {f"{k}{s}": rng.rand(5) for k in metrics
               for s in ("", "_synth")} for m in ("linear", "ours")}
    keys = ("loss_ae_dist", "loss_ae_dist_extra", "loss_latent_1")
    exper = os.path.join(fig_dir, "exper")
    os.makedirs(exper)
    np.savez(os.path.join(exper, "loss_iters.npz"), loss_iters=np.arange(6))
    for split in ("train", "test"):
        np.savez(os.path.join(exper, f"losses_{split}.npz"),
                 **{k: rng.rand(6) for k in keys})

    def path(name):
        return os.path.join(fig_dir, name + ".png")

    plots.metric_boxplots(res, save_path=path("boxplots"))
    plots.qualitative_comparison_figure(vol, {"ours": vol2}, [1, 4],
                                        save_path=path("qualitative"))
    plots.long_axis_strip(vol, save_path=path("lax_strip"))
    plots.bland_altman_plot(rng.rand(8), rng.rand(8),
                            save_path=path("bland_altman"))
    plots.upsample_factor_compare({"ours": {2: rng.rand(4), 4: rng.rand(4)}},
                                  save_path=path("factors"))
    plots.interpolation_sequence_figure(vol[0], vol[1:4], vol[4], vol[1:4],
                                        save_path=path("sequence"))
    plots.compare_methods_slices(vol[2], {"ours": vol2[2]},
                                 save_path=path("methods_slices"))
    plots.reconstructions_grid({"ours": vol2}, [0, 3],
                               save_path=path("recon_grid"))
    plots.orthogonal_views_figure(vol, save_path=path("orthogonal"))
    plots.lax_views_compare({"ours": vol2}, save_path=path("lax_compare"))
    plots.label_overlay_figure(vol[3], rng.randint(0, 4, (24, 24)),
                               acdc=True, save_path=path("overlay"))
    plots.animate_volume(vol[:3], os.path.join(fig_dir, "scroll.gif"))
    journal2.upsample_factor_page(
        {k: {f"{m}_synth": rng.rand(4) for m in metrics} for k in (2, 4)},
        save_path=path("j2_factors"))
    journal2.lambda_page({v: res["ours"] for v in (0.01, 0.1)},
                         save_path=path("j2_lambda"))
    journal2.methods_comparison_page(vol, {"ours": vol2}, [2, 4],
                                     save_path=path("j2_methods"))
    journal2.interpol_sequence_page(vol[0], vol[1:4], vol[4], (2, 12, 2, 12),
                                    save_path=path("j2_sequence"))
    journal2.reconstruction_page(vol, {"ours": vol2}, [1, 2],
                                 save_path=path("j2_recon"))
    journal2.boxplot_page(res, save_path=path("j2_boxplots"))
    journal2.cardiac_lax_page({"reference": v4d, "ours": v4d}, 1,
                              save_path=path("j2_cardiac_lax"))
    spie2021.spie_boxplot_page({k: [rng.rand(5), rng.rand(5)]
                                for k in metrics}, ["linear", "ours"],
                               save_path=path("spie_boxplots"))
    spie2021.lax_view_pages({m: {"p": {"image": v4d}}
                             for m in ("reference", "ours")}, "p", 5, 3,
                            frame_id=1, with_diff_image=True,
                            fig_dir=fig_dir)
    spie2021.methods_grid_page({"original": vol, "ours": vol2}, 2, 5,
                               save_path=path("spie_grid"))
    spie2021.interpol_example_page(rng.rand(5, 24, 24), vol[:3],
                                   save_path=path("spie_example"))
    spie2021.presentation_slice_pages({"reference": vol, "ours": vol2}, 3, 4,
                                      fig_dir=fig_dir)
    spie2021.two_method_slice_compare(vol, vol2, vol2, [2, 3],
                                      downsample_steps=2,
                                      save_path=path("spie_two"),
                                      device=dev)
    loss_curves.show_experiment_losses(exper, save_path=path("losses"))
    return sorted(f for f in os.listdir(fig_dir) if "." in f)


def check_figures(card: str, dev) -> dict:
    """Phase 17c (see the module docstring)."""
    import importlib.util
    import tempfile

    import superresolution_aniso_mri_tpu_torch.evaluate  # noqa: F401
    from superresolution_aniso_mri_tpu_torch.evaluate import plots

    if importlib.util.find_spec("matplotlib") is not None:
        with tempfile.TemporaryDirectory() as tmp:
            files = _figure_pages(tmp, dev)
        log(f"figures c: matplotlib imports; every page drawn: "
            f"{len(files)} files")
        return {"figures": "drawn", "figure_files": len(files)}
    try:
        plots.metric_boxplots({})
    except ModuleNotFoundError as exc:
        if exc.name != "matplotlib":
            raise
        log(f"figures c: no matplotlib on this machine; evaluate imports "
            f"and a figure call raises ModuleNotFoundError: {exc} [{card}]")
        return {"figures": "no matplotlib: evaluate imports, a figure "
                           "call raises ModuleNotFoundError"}
    raise AssertionError("a figure drew without matplotlib")


def _row_gaps(got: dict, want: dict) -> tuple:
    """(the largest relative gap of two rows' aggregates, the aggregates
    beyond ``QUALITY_CPU_RTOL`` relative plus one rounding step of the
    rows' 5 decimals)."""
    pairs = [(f"{k}.{m}", got[k][m], v) for k in ROW_METRICS if k in want
             for m, v in want[k].items()]
    return (max(abs(g - v) / max(abs(v), 1e-30) for _, g, v in pairs),
            [n for n, g, v in pairs
             if not abs(g - v) <= QUALITY_CPU_RTOL * abs(v) + 1e-5])


def check_quality(seed: int, card: str, dev) -> dict:
    """Phase 18 (see the module docstring): the port's
    ``real-pipeline-quality`` end to end on the card at a reduced depth,
    and ``quality-check``; the numbers of the ``phase18`` line and the
    SSIM launches of their scoring and find-best paths."""
    import glob
    import tempfile

    from superresolution_aniso_mri_tpu_torch.data.datasets import (
        load_acdc_volumes, load_brain_volumes)
    from superresolution_aniso_mri_tpu_torch.tools import (
        quality_check, real_pipeline_quality)

    t_phase = time.perf_counter()
    here = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(here, "docs", "quality_real_r4.jsonl")) as f:
        want_keys = (set(json.loads(f.readlines()[1]))
                     | set(JAX_ROW_LATER_KEYS))
    out: dict = {"launches": {}, "kernel_err": 0.0}
    old_root, old_tmp = os.environ.get("SR_DATA_ROOT"), tempfile.tempdir
    _free_cuda()
    with tempfile.TemporaryDirectory() as tmp:
        counts = os.path.join(tmp, "launches.jsonl")
        os.environ["SR_KERNEL_LAUNCHES_LOG"] = counts
        tempfile.tempdir = tmp   # the tool's work directories
        try:
            for name, argv in QUALITY_ROWS.items():
                open(counts, "w").close()
                before = set(glob.glob(os.path.join(tmp, "sr_rpq_*")))

                def run(argv=argv):
                    return real_pipeline_quality.main(
                        [*argv, "--keep", "--device", dev.type])
                row, n, err, secs = _counted_scoring(run,
                                                     f"phase 18 {name}")
                work, = set(glob.glob(os.path.join(tmp, "sr_rpq_*"))) - before
                with open(counts) as f:
                    children = [json.loads(line) for line in f]
                fb = sum(c["launches"]["ssim_slice"] for c in children
                         if c["command"] == "find-best-model")
                # predicted from the volumes: one SSIM launch a scored
                # volume and method (the model, linear, bspline,
                # lanczos; TTA flips average the model's four syntheses
                # before one scoring); find-best scores the validation
                # volumes with one launch a chunk for each numbered
                # checkpoint (the epochs after the threshold:
                # sweep_last - 1)
                os.environ["SR_DATA_ROOT"] = os.path.join(work, "data")
                test = (load_acdc_volumes("test")
                        if row["dataset_shape"] == "ACDC" else
                        load_brain_volumes(row["dataset_shape"],
                                           row["downsample_steps"],
                                           split="test",
                                           include_hr_images=True))
                extra = row["n_extra_test"] * (row["num_frames"] or 1)
                want_n = 4 * (len(test) + extra)
                sweep_last = int(argv[argv.index("--sweep_last") + 1])
                want_fb = (QUALITY_FIND_BEST_CHUNKS.get(name, 1)
                           * (sweep_last - 1))
                if n != want_n or fb != want_fb:
                    raise AssertionError(
                        f"phase 18 {name}: {n} scoring and {fb} find-best "
                        f"SSIM launches, predicted {want_n} and {want_fb}")
                if set(row) != want_keys:
                    raise AssertionError(
                        f"phase 18 {name}: row keys differ from JAX's: "
                        f"{sorted(set(row) ^ want_keys)}")
                for k in ROW_METRICS:
                    _finite(row[k], f"phase 18 {name} {k}")
                out["launches"][f"quality_{name}_score"] = n
                out["launches"][f"quality_{name}_find_best"] = fb
                out["kernel_err"] = max(out["kernel_err"], err)
                out[name] = {k: row[k] for k in (
                    "checkpoint", "compute_dtype", "tta", *ROW_METRICS,
                    "beats_all", "beats_all_extra")}
                out[name].update(test_volumes=len(test), extra_volumes=extra,
                                 tool_s=secs)
                if name in QUALITY_CPU_ROWS:
                    # the same kept checkpoint scored on the CPU
                    cpu = real_pipeline_quality.main(
                        ["--reuse", work, "--checkpoint", row["checkpoint"],
                         "--extra_test_volumes", str(row["n_extra_test"]),
                         "--latent_interp", row["latent_interp"],
                         *(["--tta", row["tta"]] if row["tta"] else []),
                         "--device", "cpu"])
                    gap, bad = _row_gaps(row, cpu)
                    out[f"{name}_card_vs_cpu_max_rel_gap"] = gap
                    log(f"quality {name}: card vs CPU on checkpoint "
                        f"{row['checkpoint']}: max rel gap {gap:.3e}")
                    if bad:
                        raise AssertionError(
                            f"phase 18: the card's and the CPU's scores of "
                            f"one checkpoint differ: {bad}")
                log(f"quality {name} [{card}]: " + json.dumps(out[name])
                    + f"; SSIM launches: scoring {n}, find-best {fb}")
            qc, n, err, secs = _counted_scoring(
                lambda: quality_check.main([*QUALITY_CHECK_ARGV,
                                            "--device", dev.type]),
                "phase 18 quality-check")
            if n != 4 * 3:
                raise AssertionError(f"quality-check: {n} SSIM launches, "
                                     f"predicted 12")
            _finite(qc["model"], "quality-check model")
            out["launches"]["quality_check_score"] = n
            out["kernel_err"] = max(out["kernel_err"], err)
            out["quality_check"] = dict(qc, tool_s=secs)
            log(f"quality-check [{card}]: {json.dumps(qc)}")
        finally:
            tempfile.tempdir = old_tmp
            os.environ.pop("SR_KERNEL_LAUNCHES_LOG", None)
            if old_root is None:
                os.environ.pop("SR_DATA_ROOT", None)
            else:
                os.environ["SR_DATA_ROOT"] = old_root
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"phase 18: {out['phase_s']:.1f} s")
    return out


def _measure_child(name: str, tmp: str, dev) -> tuple:
    """(stdout, kernel launches, seconds) of ``python -m
    superresolution_aniso_mri_tpu_torch.cli name MEASURE_ARGV[name]``
    (``--device`` but for the host-only loader-bench), its launches read
    from ``SR_KERNEL_LAUNCHES_LOG``."""
    here = os.path.dirname(os.path.abspath(__file__))
    counts = os.path.join(tmp, f"{name}.launches.jsonl")
    env = dict(os.environ, SR_KERNEL_LAUNCHES_LOG=counts,
               PYTHONPATH=os.pathsep.join(
                   p for p in (here, os.environ.get("PYTHONPATH")) if p))
    argv = list(MEASURE_ARGV[name])
    if name != "loader-bench":
        argv += ["--device", dev.type]
    if name in ("infer-roofline", "train-bench"):
        argv += ["--json_out", os.path.join(tmp, f"{name}.json")]
    cmd = [sys.executable, "-m", "superresolution_aniso_mri_tpu_torch.cli",
           name, *argv]
    t0 = time.perf_counter()
    r = subprocess.run(cmd, cwd=tmp, env=env, capture_output=True,
                       text=True, timeout=600)
    secs = time.perf_counter() - t0
    if r.returncode != 0:
        raise AssertionError(f"phase 19: {name} exited {r.returncode}:\n"
                             + r.stdout[-3000:] + r.stderr[-3000:])
    for line in r.stdout.splitlines():
        log(f"  [{name}] {line}")
    log(f"phase 19: {name} took {secs:.1f} s")
    with open(counts) as f:
        launches = [json.loads(line)["launches"] for line in f]
    return r.stdout, launches[-1], secs


def _over_limit(shares: dict) -> list:
    """The shares of ``shares`` above ``SHARE_LIMIT``, or not finite."""
    return [f"{k}={v}" for k, v in shares.items()
            if not (0.0 < v <= SHARE_LIMIT)]


def check_measurement(card: str, dev) -> dict:
    """Phase 19 (see the module docstring): the five measurement commands
    as children; their numbers, the SSIM launches of ``bench``, and
    their FLOP counts against the same functions counted on the meta
    device in this process (shapes only)."""
    import re
    import tempfile

    import torch

    from superresolution_aniso_mri_tpu_torch.models import AEConfig
    from superresolution_aniso_mri_tpu_torch.tools import (bench,
                                                           infer_roofline,
                                                           train_bench)

    t_phase = time.perf_counter()
    meta = torch.device("meta")
    out: dict = {"card": card, "command_s": {}}
    _free_cuda()
    with tempfile.TemporaryDirectory() as tmp:
        # bench: one JSON line, the SSIM kernel through its dispatch
        stdout, launches, out["command_s"]["bench"] = _measure_child(
            "bench", tmp, dev)
        line = json.loads(stdout.strip().splitlines()[-1])
        n = launches["ssim_slice"]
        if abs(line["ssim_selfcheck"] - 1.0) > 1e-3:
            raise AssertionError(f"bench: ssim_selfcheck "
                                 f"{line['ssim_selfcheck']}")
        want_path = "cuda" if dev.type == "cuda" else "plain"
        if line["ssim_kernel_path"] != want_path:
            raise AssertionError(f"bench: ssim_kernel_path "
                                 f"{line['ssim_kernel_path']!r}")
        if dev.type == "cuda" and n != BENCH_SSIM_LAUNCHES:
            raise AssertionError(f"bench: {n} SSIM launches, predicted "
                                 f"{BENCH_SSIM_LAUNCHES}")
        if not (np.isfinite(line["value"]) and line["value"] > 0):
            raise AssertionError(f"bench: value {line['value']}")
        out["bench"] = line
        out["launches"] = {"bench": n}

        # infer-roofline: the volume's count against the meta count
        _, _, out["command_s"]["infer-roofline"] = _measure_child(
            "infer-roofline", tmp, dev)
        with open(os.path.join(tmp, "infer-roofline.json")) as f:
            roof = json.load(f)
        net, kept, alphas = infer_roofline.volume_case(
            AEConfig(**bench.BENCH_CFG, compute_dtype="bfloat16"),
            infer_roofline.NUM_LR_SLICES, infer_roofline.HW,
            infer_roofline.DS, meta)
        want = infer_roofline.volume_flops(net, kept, alphas)
        if roof["flops_per_volume"] != want:
            raise AssertionError(f"infer-roofline: {roof['flops_per_volume']}"
                                 f" FLOPs a volume, {want} on the meta "
                                 f"device")
        shares = {"floor_share": roof["floor_share"],
                  "hbm_share": roof["hbm_share"],
                  **{f"{tag} {k}": v for tag, row in roof["batched"].items()
                     for k, v in row.items() if k.endswith("share")}}
        if "split" in roof:
            shares["decode_floor_share"] = roof["split"]["decode_floor_share"]
        bad = _over_limit(shares)
        if bad:
            raise AssertionError(f"infer-roofline: shares out of (0, 1]: "
                                 f"{bad}")
        out["infer_roofline"] = roof

        # train-bench: six rows, each count against the meta count
        _, _, out["command_s"]["train-bench"] = _measure_child(
            "train-bench", tmp, dev)
        with open(os.path.join(tmp, "train-bench.json")) as f:
            rows = json.load(f)
        by_name = {v[0]: v for v in train_bench.SHAPES.values()}
        argv = MEASURE_ARGV["train-bench"]
        configs = (argv[argv.index("--configs") + 1:] if "--configs" in argv
                   else train_bench.SHAPES)
        if len(rows) != len(train_bench.DTYPES) * len(configs):
            raise AssertionError(f"train-bench: {len(rows)} rows")
        for row in rows:
            _, w, lw, d, lat, b = by_name[row["name"]]
            want = train_bench.meta_step_flops(
                train_bench.trainer_args(w, lw, d, lat, b, row["dtype"]),
                w, b)
            if row["flops"] != want:
                raise AssertionError(f"train-bench {row['name']} "
                                     f"{row['dtype']}: {row['flops']} "
                                     f"FLOPs a step, {want} on the meta "
                                     f"device")
            bad = _over_limit({"mfu_vs_bf16_peak": row["mfu_vs_bf16_peak"],
                               "hbm_bw_fraction": row["hbm_bw_fraction"],
                               "floor_share": 1.0 / row["gap_to_floor"]})
            if bad:
                raise AssertionError(f"train-bench {row['name']} "
                                     f"{row['dtype']}: shares out of "
                                     f"(0, 1]: {bad}")
        out["train_bench"] = rows

        # pipeline-bench: the training CLI with the device cache off, on
        stdout, _, out["command_s"]["pipeline-bench"] = _measure_child(
            "pipeline-bench", tmp, dev)
        pipe = {m.group(1): {"first_epoch_s": float(m.group(2)),
                             "steady_epoch_s": float(m.group(3)),
                             "ms_per_step": float(m.group(4))}
                for m in re.finditer(
                    r"cache=\s*(\S+): first epoch\s+([\d.]+)s .*? steady"
                    r"\s+([\d.]+)s/epoch \(~\s*([\d.]+) ms/step", stdout)}
        if sorted(pipe) != ["0", "1"]:
            raise AssertionError(f"pipeline-bench: variants {sorted(pipe)}")
        out["pipeline_bench"] = pipe

        # loader-bench: host only
        stdout, _, out["command_s"]["loader-bench"] = _measure_child(
            "loader-bench", tmp, dev)
        ingest = re.search(r"python ([\d.]+)s, native ([\d.]+)s", stdout)
        gather = re.search(r"python ([\d.]+)ms, native ([\d.]+)ms", stdout)
        if not (ingest and gather):
            raise AssertionError("loader-bench: no ingest / gather line")
        out["loader_bench"] = {
            "ingest_python_s": float(ingest.group(1)),
            "ingest_native_s": float(ingest.group(2)),
            "gather_python_ms": float(gather.group(1)),
            "gather_native_ms": float(gather.group(2))}
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"phase 19 [{card}]: {out['phase_s']:.1f} s")
    return out


def _kernel_kind(name: str) -> str:
    """Bucket of a device event by its kernel name."""
    low = name.lower()
    if low.startswith(("memcpy", "memset")):
        return "copies"
    if "multi_tensor_apply" in low:
        return "optimizer"
    if "reduce_kernel" in low:
        return "reductions"
    if "pool" in low or "upsample" in low:
        return "pool_upsample"
    if "elementwise" in low or "cat" in low:
        return "elementwise"
    if any(t in low for t in ("xmma", "gemm", "fft", "dse::", "grad",
                              "conv", "cudnn", "nchw", "nhwc", "region_",
                              "complex")):
        return "convolutions"
    return "other"


def profile_train_step(one_step, wall_ms: float, path: str) -> None:
    """Trace one warm train step (upload included); print kernel time by
    kind, the convolutions split into forward and backward by their aten
    op, the device-side span of the BatchNorm forward calls (a range
    around each call: its kernels, which also sit in their kinds, and
    the gaps between them), and the device idle share against
    ``wall_ms``, the untraced median step. The table goes to
    ``path + ".train.txt"``."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from superresolution_aniso_mri_tpu_torch.models import acai

    forward = acai.BatchNorm.forward

    def traced(self, *a, **kw):
        with record_function("BatchNorm.forward"):
            return forward(self, *a, **kw)

    acai.BatchNorm.forward = traced
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            one_step()
            torch.cuda.synchronize()
    finally:
        acai.BatchNorm.forward = forward
    events = prof.key_averages()
    self_attr = ("self_device_time_total"
                 if hasattr(events[0], "self_device_time_total")
                 else "self_cuda_time_total")
    cuda = torch.autograd.DeviceType.CUDA

    def device_ms(match) -> float:
        return sum(getattr(e, self_attr) for e in events if match(e)) / 1e3

    # device rows that are not kernels: the profiler's own buffer, and
    # the device-side span of each BatchNorm range (idle gaps included)
    kernels = [e for e in events if e.device_type == cuda and e.key not in
               ("Activity Buffer Request", "BatchNorm.forward")]
    kinds: dict = {}
    for e in kernels:
        kind = _kernel_kind(e.key)
        kinds[kind] = kinds.get(kind, 0.0) + getattr(e, self_attr) / 1e3
    busy = sum(kinds.values())
    split = {"conv_fwd": device_ms(lambda e: e.key.startswith(
                 "aten::cudnn_convolution")),
             "conv_bwd": device_ms(lambda e: e.key ==
                                   "aten::convolution_backward"),
             "batchnorm_fwd_span": device_ms(
                 lambda e: e.key == "BatchNorm.forward"
                 and e.device_type == cuda)}
    table = events.table(sort_by=self_attr, row_limit=50)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path + ".train.txt", "w") as f:
        f.write(table)
    log("profile train step: device ms by kernel kind " + json.dumps(
        {k: round(v, 4) for k, v in sorted(kinds.items())})
        + "; by op " + json.dumps({k: round(v, 4) for k, v in split.items()})
        + f"; {sum(e.count for e in kernels)} device events, busy "
        f"{busy:.4f} ms of an untraced {wall_ms:.4f} ms step, idle share "
        f"{1 - busy / wall_ms:.3f}")
    for line in table.splitlines()[:30]:
        log(f"  {line[:160]}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", metavar="PATH",
                    help="trace one serve+score call with torch.profiler "
                         "and write its kernel table to PATH")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device — this script runs the port on "
              "the GPU only", file=sys.stderr)
        return 1
    from superresolution_aniso_mri_tpu_torch.evaluate import (
        compute_volume_metrics)
    from superresolution_aniso_mri_tpu_torch.infer import (
        ServingModel, create_super_volume, create_super_volumes)
    from superresolution_aniso_mri_tpu_torch.models import AEConfig
    from superresolution_aniso_mri_tpu_torch.ops import cuda_kernels
    from superresolution_aniso_mri_tpu_torch.ops.metrics import ssim_volume

    t_start = time.perf_counter()
    dev = torch.device("cuda")
    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python "
        f"{sys.version.split()[0]} device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()}")

    # ---- 2. kernels --------------------------------------------------
    kcheck = check_kernels(dev)

    # ---- 3. serve ----------------------------------------------------
    alphas = np.linspace(0, 1, DS + 1)[1:-1]
    serve_kw = dict(alpha_range=alphas, downsample_steps=DS,
                    use_original=False, generate_inbetween_slices=True)
    cfg = AEConfig(**BENCH_CFG, compute_dtype="bfloat16")
    model = ServingModel(cfg, device=dev,
                         generator=torch.Generator().manual_seed(args.seed))
    hr = phantom(args.seed)
    log(f"phantom: {hr.shape}, kept slices {hr[::DS].shape[0]}")

    # the main path, counted: serve (linear) → score
    cuda_kernels.reset_launch_counts()
    res = create_super_volume(model, hr, **serve_kw)
    metrics = compute_volume_metrics(hr, res["upsampled_image"],
                                     downsample_steps=DS)
    launches = dict(cuda_kernels.LAUNCHES)
    log(f"main path launches: {json.dumps(launches)}")
    check_volume(res["upsampled_image"], "serve linear")
    for name, count in launches.items():
        if count < 1:
            raise AssertionError(f"kernel {name} was not launched on the "
                                 f"main path")

    res_l3 = create_super_volume(model, hr, latent_interp="lanczos3",
                                 **serve_kw)
    check_volume(res_l3["upsampled_image"], "serve lanczos3")
    log(f"serve: linear and lanczos3 → {res['upsampled_image'].shape}, "
        f"finite, in [0, 1]")

    vols = [phantom(args.seed + 1 + i) for i in range(4)]
    batched = create_super_volumes(model, vols, **serve_kw)
    batch_err = 0.0
    for vol, got in zip(vols, batched):
        single = create_super_volume(model, vol, **serve_kw)
        check_volume(got["upsampled_image"], "serve batched")
        batch_err = max(batch_err, float(np.abs(
            got["upsampled_image"] - single["upsampled_image"]).max()))
    log(f"serve: batch of 4 vs 4 single calls: max_abs_diff={batch_err:.3e}")
    # bf16 convs may pick other cuDNN algorithms at another batch size
    if not batch_err <= 1.0 / 64:
        raise AssertionError(f"batched serving differs from single calls "
                             f"by {batch_err}")

    state = model._ae_model().state_dict()
    cfg32 = AEConfig(**BENCH_CFG, compute_dtype="float32")
    model32 = ServingModel(cfg32, state, device=dev)
    res32 = create_super_volume(model32, hr, **serve_kw)
    check_volume(res32["upsampled_image"], "serve f32")
    v16 = torch.from_numpy(res["upsampled_image"]).to(dev)
    v32 = torch.from_numpy(res32["upsampled_image"]).to(dev)
    bf16_delta = 1.0 - float(cuda_kernels.ssim_volume_fused(v16, v32).mean())
    log(f"serve: bf16_ssim_delta (1 - SSIM(bf16, f32)) = {bf16_delta:.6f}")

    # card against CPU on a small crop, float32 (TF32 off on both)
    crop = hr[:37, 60:124, 70:134].copy()
    small = dict(serve_kw, latent_interp="lanczos3")
    got = create_super_volume(model32, crop, **small)["upsampled_image"]
    cpu_model = ServingModel(cfg32, state, device="cpu")
    want = create_super_volume(cpu_model, crop, **small)["upsampled_image"]
    card_cpu_err = float(np.abs(got - want).max())
    log(f"serve: card vs CPU, f32 {crop.shape} → {got.shape}: "
        f"max_abs_diff={card_cpu_err:.3e}")
    if not card_cpu_err <= 1e-4:
        raise AssertionError(f"card and CPU serving differ: {card_cpu_err}")

    # ---- 4. score ----------------------------------------------------
    for key, val in metrics.items():
        if not np.isfinite(val):
            raise AssertionError(f"metric {key} is not finite: {val}")
    log("metrics: " + json.dumps(dict(metrics, ssim_kernel_path="cuda")))
    cpu_metrics = compute_volume_metrics(hr, res["upsampled_image"],
                                         downsample_steps=DS, device="cpu")
    metric_err = max(abs(metrics[k] - cpu_metrics[k])
                     / max(1.0, abs(cpu_metrics[k])) for k in metrics)
    log(f"metrics: card vs CPU max rel diff {metric_err:.3e}")
    if not metric_err <= 1e-4:
        raise AssertionError(f"card and CPU scores differ: {metric_err}")
    ref_v = v16[:8].contiguous()
    self_ssim = float(cuda_kernels.ssim_volume_fused(ref_v, ref_v).mean())
    log(f"ssim_selfcheck: {self_ssim:.6f}")
    if abs(self_ssim - 1.0) >= 1e-3:
        raise AssertionError(f"SSIM self-check failed: {self_ssim}")

    # ---- 5. train -----------------------------------------------------
    train = check_train(dev, args.seed, hr, serve_kw, card, args.profile)

    # ---- 6. timings --------------------------------------------------
    timings = {}
    for name, kw in (("linear", {}), ("lanczos3", {"latent_interp": "lanczos3"})):
        ts = call_times_s(lambda: create_super_volume(model, hr, **serve_kw,
                                                       **kw), 7)
        timings[f"serve_{name}_s_per_volume"] = float(np.median(ts))
        timings[f"serve_{name}_s_min"] = float(np.min(ts))
    tb = call_times_s(lambda: create_super_volumes(model, vols, **serve_kw), 3)
    timings["serve_batched4_s_per_volume"] = float(np.median(tb)) / 4
    ts = call_times_s(lambda: compute_volume_metrics(
        hr, res["upsampled_image"], downsample_steps=DS), 5)
    timings["score_s_per_volume"] = float(np.median(ts))

    a = torch.from_numpy(hr).to(dev)
    b = torch.from_numpy(res["upsampled_image"]).to(dev)
    kernel_ms = cuda_ms(lambda: cuda_kernels.ssim_volume_cuda(a, b, 1.0, 7), 50)
    kernel_cold_ms = cold_ms(
        lambda: cuda_kernels.ssim_volume_cuda(a, b, 1.0, 7), 30)
    plain_ms = cuda_ms(lambda: ssim_volume(a, b, 1.0, 7), 20)
    bound_ms, bound_by = ssim_bound(tuple(a.shape), 7)
    timings.update(ssim_kernel_us=kernel_ms * 1e3,
                   ssim_kernel_cold_us=kernel_cold_ms * 1e3,
                   ssim_plain_us=plain_ms * 1e3, ssim_bound_us=bound_ms * 1e3,
                   ssim_bound_share=bound_ms / kernel_ms,
                   ssim_bound_share_cold=bound_ms / kernel_cold_ms)
    log(f"timings [{card}]: " + json.dumps(timings))

    if args.profile:
        profile_main_path(model, hr, serve_kw,
                          timings["serve_linear_s_per_volume"]
                          + timings["score_s_per_volume"], args.profile)

    # ---- 7. experiment-directory CLIs --------------------------------
    cli = check_cli(args.seed, card)

    # ---- 8. production recipes from disk -----------------------------
    # ---- 9. perceptual and SSIM losses, LPIPS, baselines --------------
    # ---- 10. the training loop's options, fit-latent-taps, reference ---
    # ---- 11. the comparison families ----------------------------------
    with disk_trees(args.seed) as (tmp, fabricate_s):
        disk = check_disk_recipes(tmp, args.seed, card, dev, args.profile)
        disk["fabricate_s"] = fabricate_s
        percept = check_perceptual(tmp, args.seed, card, dev,
                                   disk["oasis_cache_ms_per_step"],
                                   args.profile)
        options = check_train_options(
            tmp, args.seed, card, dev, disk["oasis_cache_ms_per_step"],
            percept["oasis_percept_ms_per_step"], args.profile)
        families = check_families(tmp, args.seed, card, dev,
                                  disk["oasis_cache_ms_per_step"],
                                  args.profile)
        # ---- 12. the labeled cardiac path -----------------------------
        labeled = check_labeled(tmp, args.seed, card, dev, args.profile)
        # ---- 13. the alpha-probe families -----------------------------
        alpha = check_alpha(tmp, args.seed, card, dev, args.profile)
        # ---- 14. evaluation: the combo, the paper's scoring, MNISTRoto -
        evaluation = check_eval(tmp, args.seed, card, dev)
        # ---- 15. dataset preparation, SR segmentation, perceptual tools
        prep = check_prep(tmp, args.seed, card, dev)
        # ---- 17b. the native host loader on phase 8's OASIS tree -------
        loader = check_native_loader(tmp, args.seed, card)
    # ---- 16. data-parallel training, sharded serving, packed decode ----
    par = check_parallel(args.seed, card, dev)
    # ---- 17a, c. the 2-D data × model step; the figures ----------------
    t17 = time.perf_counter()
    mesh2d = check_mesh2d(args.seed, card, dev)
    figures = check_figures(card, dev)
    phase17_s = time.perf_counter() - t17 + loader["loader_phase_s"]
    log(f"phase 17: {phase17_s:.1f} s")
    # ---- 18. the production-pipeline quality harness -------------------
    quality = check_quality(args.seed, card, dev)
    # ---- 19. the measurement commands ----------------------------------
    measure = check_measurement(card, dev)

    log(f"total: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"parallel": {k: v for k, v in par.items()
                                   if k != "launches"}}), flush=True)
    print(json.dumps({"phase17": {**mesh2d, **loader, **figures,
                                  "phase_s": phase17_s, "card": card}}),
          flush=True)
    print(json.dumps({"phase18": {**{k: v for k, v in quality.items()
                                     if k != "launches"}, "card": card}}),
          flush=True)
    print(json.dumps({"phase19": {k: v for k, v in measure.items()
                                  if k != "launches"}}), flush=True)
    log(card)  # name and power limit, as nvidia-smi prints them
    print(json.dumps({"kernels": [{
        "name": "ssim_slice", "route": "cuda",
        "source": "superresolution_aniso_mri_tpu_torch/csrc/ssim.cu",
        "replaces": "superresolution_aniso_mri_tpu/ops/pallas_kernels.py:43",
        "launches": launches["ssim_slice"],
        "launches_by_path": {
            "serve_score": launches["ssim_slice"],
            "train_serve_score": train["launches"]["ssim_slice"],
            "cli_find_best": cli["find_best_plain_launches"],
            "cli_find_best_batched": cli["find_best_batched_launches"],
            "cli_oasis_find_best": disk["find_best_launches"],
            "percept_create_hr_images":
                percept["percept_create_hr_images_launches"],
            "baselines_create_hr_images": sum(
                row["launches"] for name, row in percept["baselines"].items()
                if name != "model"),
            "fitted_create_hr_images": options["fitted_launches"],
            **{f"families_{k}": v
               for k, v in families["launches"].items()},
            **labeled["launches"], **alpha["launches"],
            **evaluation["launches"], **prep["launches"],
            **par["launches"], **quality["launches"],
            **measure["launches"]},
        "max_abs_err": max(kcheck["max_abs_err"],
                           disk["find_best_kernel_err"],
                           percept["percept_kernel_err"],
                           options["fitted_kernel_err"],
                           families["kernel_err"],
                           labeled["kernel_err"],
                           alpha["kernel_err"],
                           evaluation["kernel_err"],
                           prep["kernel_err"], par["kernel_err"],
                           quality["kernel_err"]), "ok": True,
        "ms": kernel_ms, "ms_cold": kernel_cold_ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
        "bound_share": bound_ms / kernel_ms,
        "bound_share_cold": bound_ms / kernel_cold_ms,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def profile_main_path(model, hr, serve_kw, wall_s: float, path: str) -> None:
    """Trace one serve + score call (warm: the timings ran before); write
    the table to ``path`` and print device time by kind against
    ``wall_s``, the untraced serve + score time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from superresolution_aniso_mri_tpu_torch.evaluate import (
        compute_volume_metrics)
    from superresolution_aniso_mri_tpu_torch.infer import create_super_volume

    def step():
        out = create_super_volume(model, hr, **serve_kw)
        compute_volume_metrics(hr, out["upsampled_image"],
                               downsample_steps=DS)
        torch.cuda.synchronize()

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step()
    events = prof.key_averages()
    attr = ("self_device_time_total"
            if hasattr(events[0], "self_device_time_total")
            else "self_cuda_time_total")
    device = [e for e in events
              if e.device_type == torch.autograd.DeviceType.CUDA]
    copy_us = sum(getattr(e, attr) for e in device
                  if e.key.startswith("Memcpy"))
    kernel_us = sum(getattr(e, attr) for e in device) - copy_us
    table = events.table(sort_by=attr, row_limit=40)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        f.write(table)
    kernel_ms, copy_ms = kernel_us / 1e3, copy_us / 1e3
    log(f"profile: per serve+score {kernel_ms:.2f} ms in kernels, "
        f"{copy_ms:.2f} ms in copies, untraced wall {wall_s * 1e3:.2f} ms, "
        f"device idle share {1 - (kernel_ms + copy_ms) / (wall_s * 1e3):.3f}")
    for line in table.splitlines()[:25]:
        log(f"  {line[:160]}")


if __name__ == "__main__":
    sys.exit(main())
