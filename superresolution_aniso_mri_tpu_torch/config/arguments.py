"""CLI argument surface of the training commands.

A copy of ``superresolution_aniso_mri_tpu/config/arguments.py`` (the
reference's kwatsch/arguments.py:10-103 flags and post-parse rules:
ae_combined → perceptual mix loss, per-dataset aug_patch_size defaults,
VAE class routing, output-dir layout). One difference: ``--device``
defaults to ``cuda`` and takes ``cpu``; the JAX package's default is
``tpu``, and a ``device: tpu`` in a JAX experiment's settings is ignored
by ``train.get_trainer``.
"""
from __future__ import annotations

import argparse
import os


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        description="Train auto-encoder for SR (PyTorch/CUDA)")
    parser.add_argument("-d", "--dataset", type=str,
                        choices=["ACDC", "ACDCC", "ARVC", "dHCP", "ADNI",
                                 "OASIS", "brainMASI", "MNIST3D",
                                 "MNISTRoto", "ACDCLBL"],
                        default="ACDC")
    parser.add_argument("--downsample_steps", type=int, default=None)
    parser.add_argument("-ss", "--slice_selection", type=str,
                        choices=["adjacent_plus", "adjacent", "mix"],
                        default="adjacent_plus")
    parser.add_argument("-c", "--comment", type=str, default=None)
    parser.add_argument("-m", "--model", type=str,
                        choices=["ae", "ae_combined", "aesr", "aesr_combined",
                                 "vae", "vae_combined", "acai",
                                 "acai_combined", "vae2",
                                 # extension over the reference CLI: the
                                 # alpha-probe family (the reference
                                 # builds these trainers only via
                                 # get_trainer_dynamic, never its CLI —
                                 # kwatsch/arguments.py:21-27; exposing
                                 # them here keeps one production
                                 # entry point for every family)
                                 "alpha", "alpha_end_to_end",
                                 "alpha_only", "alpha_combined"],
                        default="ae")
    parser.add_argument("-id", "--exper_id", type=str, default="debug")
    parser.add_argument("-o", "--output_dir", type=str, default=None)
    parser.add_argument("--model_filename", type=str, default=None)
    parser.add_argument("-e", "--epochs", type=int, default=250)
    parser.add_argument("-l", "--lr", type=float, default=0.00001)
    parser.add_argument("-w", "--weight_decay", type=float, default=0.0)
    parser.add_argument("-b", "--batch_size", type=int, default=12)
    parser.add_argument("-bt", "--test_batch_size", type=int, default=16)
    parser.add_argument("--device", type=str, default="cuda",
                        choices=["cuda", "cpu"])
    parser.add_argument("--limited_load", action="store_true")
    parser.add_argument("-s", "--seed", type=int, default=892372)
    parser.add_argument("--number_of_workers", type=int, default=2)
    parser.add_argument("--validate_every", type=int, default=500)
    parser.add_argument("--alpha_loss_func", type=str, default=None,
                        choices=[None, "mse", "perceptual"])
    parser.add_argument("--use_percept_loss", action="store_true")
    parser.add_argument("--use_ssim_loss", action="store_true")
    parser.add_argument("--use_extra_latent_loss", action="store_true")
    parser.add_argument("--train_latent_interp", type=str,
                        default="linear",
                        choices=["linear", "cubic", "lanczos3"],
                        help="latent z-mixing for the TRAINING synthesis "
                             "loss (ae/ae_combined): 'cubic' samples "
                             "quintets and mixes 4 neighbouring latents "
                             "with the same Catmull-Rom spline the "
                             "cubic inference path decodes; 'lanczos3' "
                             "samples septets and mixes 6 with the "
                             "serving default's lanczos kernel — align "
                             "training with the --latent_interp scheme "
                             "served (extension; reference is linear)")
    parser.add_argument("--use_loss_annealing", action="store_true")
    parser.add_argument("--alpha_class", type=str, default=None)
    parser.add_argument("--width", type=int, default=128)
    parser.add_argument("--latent_width", type=int, default=16)
    parser.add_argument("--latent", type=int, default=16)
    parser.add_argument("--depth", type=int, default=32)
    parser.add_argument("--ae_class", type=str, default="VanillaACAI")
    parser.add_argument("--n_res_block", type=int, default=None,
                        help="residual blocks after the encoder head / "
                             "before the decoder stem (the reference's "
                             "ResBlock capacity knob, networks/"
                             "acai_vanilla.py:20-35,124-128; its CLI "
                             "never exposed it — None keeps the "
                             "architecture default)")
    parser.add_argument("--image_mix_loss_func", type=str, default=None)
    parser.add_argument("--ex_loss_weight1", type=float, default=0.001)
    parser.add_argument("--lamb_reg_acai", type=float, default=0.5)
    parser.add_argument("--vae_beta", type=float, default=None)
    parser.add_argument("--aug_patch_size", type=int, default=None)
    parser.add_argument("--get_masks", action="store_true")
    parser.add_argument("--log_tensorboard", action="store_true")
    # TPU-rebuild extensions: multi-batch validation + preview cadence
    parser.add_argument("--num_val_batches", type=int, default=4)
    parser.add_argument("--steps_per_dispatch", type=int, default=1,
                        help="optimizer steps per dispatch: the train "
                             "step is captured once in a CUDA graph and "
                             "replayed for each of the N batches (the "
                             "same trajectory as N single steps)")
    parser.add_argument("--device_data_cache", type=str, default="auto",
                        choices=["auto", "0", "1"],
                        help="keep the padded slice stacks resident in "
                             "HBM and gather training batches on device "
                             "(per-step host traffic drops to the index "
                             "scalars); 'auto' enables when they fit "
                             "SR_DEVICE_CACHE_MB, by default a quarter of "
                             "the card's free memory (512 MB on the CPU)")
    parser.add_argument("--auto_resume", action="store_true",
                        help="continue from the newest numbered checkpoint "
                             "in the experiment dir (elastic restarts)")
    parser.add_argument("--profile_dir", type=str, default=None,
                        help="record a torch.profiler trace (CPU, and "
                             "CUDA on a card) of the first epoch run into "
                             "this directory, as a Chrome trace file")
    parser.add_argument("--step_timeout_s", type=float, default=0,
                        help="stall watchdog: exit with status 75 "
                             "(EX_TEMPFAIL) when no train/val step "
                             "completes for this many seconds — a hung "
                             "device backend never raises, it just "
                             "blocks forever; pair with --auto_resume "
                             "under a supervisor loop (0 disables)")
    parser.add_argument("--first_step_timeout_s", type=float, default=0,
                        help="watchdog window before the FIRST completed "
                             "step (covers the start-up work of every "
                             "program; 0 = max(step_timeout_s, 600))")
    parser.add_argument("--volume_preview_interval", type=int, default=1,
                        help="epochs between synthesized-volume previews "
                             "(0 disables)")
    parser.add_argument("--image_dump_interval", type=int, default=1,
                        help="epochs between val-reconstruction grid "
                             "dumps (0 disables; the reference dumps "
                             "every epoch — raise for long runs where "
                             "thousands of PNGs and their device "
                             "fetches are dead weight)")
    parser.add_argument("--ema_decay", type=float, default=0.0,
                        help="maintain an exponential moving average of "
                             "the model weights (Polyak averaging) with "
                             "this per-step decay, saved as a rolling "
                             "models/ema.models every epoch — evaluate "
                             "it via model_nbr='ema'. 0 disables; "
                             "typical 0.999 (beyond-reference quality "
                             "lever: averaged weights usually score "
                             "better than the last/best iterate)")
    parser.add_argument("--epoch_threshold", type=int, default=100)
    # TPU-native extras
    parser.add_argument("--num_devices", type=int, default=1,
                        help="data-parallel training over the first N "
                             "attached devices (params replicated, batch "
                             "sharded over the mesh; batch_size must be a "
                             "multiple of N)")
    parser.add_argument("--use_lr_scheduler", action="store_true",
                        help="cosine LR annealing over --lr_iter_max "
                             "iterations (reference base_trainer.py:19-23)")
    parser.add_argument("--lr_iter_max", type=int, default=None)
    parser.add_argument("--lr_warmup_steps", type=int, default=0,
                        help="linear 0-to-lr warmup over N steps before "
                             "the constant/cosine schedule (beyond-"
                             "reference robustness lever: full LR from "
                             "step 0 can collapse the sigmoid output "
                             "head into exact-zero gradients when "
                             "--use_batchnorm 0)")
    parser.add_argument("--max_grad_norm", type=float, default=0.0,
                        help="global-norm gradient clipping (0 = off; "
                             "the reference trainers' max_grad_norm "
                             "argument, kwatsch/trainer_ae.py:18 via "
                             "acai_utils.clip_grad_norm). The "
                             "production guard against the bn=0 "
                             "sigmoid-collapse divergence, which "
                             "noise augmentation (--aug_noise) makes "
                             "more likely")
    parser.add_argument("--rotate_any", action="store_true",
                        help="opt-in any-angle (0-359) rotation "
                             "augmentation (the reference CLIs compose "
                             "rot90 only; this mirrors the dataset-"
                             "module RandomAnyRotation extra)")
    parser.add_argument("--aug_noise", action="store_true",
                        help="opt-in additive-gaussian noise "
                             "augmentation, sigma ~ U(0, 0.05) — "
                             "noise-aware training for noisy-GT "
                             "serving. Inspired by (not identical to) "
                             "the reference's uncomposed "
                             "AddRandomNoise, which is ~1/256-amplitude "
                             "dequantization dither")
    parser.add_argument("--aug_blur", action="store_true",
                        help="opt-in light random blur augmentation "
                             "(3x3 binomial, p=1/2). Inspired by the "
                             "reference's uncomposed fixed-sigma "
                             "BlurImage, with different "
                             "parameterisation")
    parser.add_argument("--mnist_path", type=str, default=None,
                        help="local MNIST idx3-ubyte[.gz]/.npz file: use "
                             "real digits for MNIST3D/MNISTRoto instead "
                             "of procedural phantoms (also env "
                             "SR_MNIST_PATH)")
    parser.add_argument("--coordinator_address", type=str, default=None,
                        help="multi-host: host:port of process 0's JAX "
                             "coordinator (also env SR_COORDINATOR_ADDRESS)")
    parser.add_argument("--num_processes", type=int, default=None,
                        help="multi-host: total process count "
                             "(also env SR_NUM_PROCESSES)")
    parser.add_argument("--process_id", type=int, default=None,
                        help="multi-host: this process's rank "
                             "(also env SR_PROCESS_ID)")
    parser.add_argument("--compute_dtype", type=str, default="float32",
                        choices=["float32", "bfloat16"])
    parser.add_argument("--use_batchnorm", type=int, default=None,
                        choices=[0, 1],
                        help="override the architecture default (the "
                             "reference hardcodes BN on in net_config; "
                             "0 trains without BN — an ablation knob "
                             "for quality studies)")
    parser.add_argument("--use_synthetic_data", action="store_true",
                        help="use the procedural toy backend instead of "
                             "on-disk volumes (CI / smoke runs)")
    parser.add_argument("--stem_pad_parity", action="store_true",
                        help="reference-faithful stem geometry (the "
                             "original's 1x1 stem conv pads by 1): set "
                             "when fine-tuning/evaluating IMPORTED "
                             "reference torch checkpoints so activations "
                             "and BN stats match the network they were "
                             "trained in (needs width/latent_width "
                             "ratio >= 4)")

    args = parser.parse_args(argv)

    # post-parse defaulting (reference: arguments.py:65-103).
    # NOTE: the combined families' image_mix_loss_func default
    # ("perceptual") lives in net_config.py's architecture table — ONE
    # site for ae_combined AND aesr_combined; the merge applies it
    # whenever the CLI value is None.
    if args.model in ("vae", "vae_combined"):
        args.ae_class = "VAE"
        if args.model == "vae" and args.vae_beta is None:
            args.vae_beta, args.lamb = 100, 1.0
        elif args.model == "vae_combined" and args.vae_beta is None:
            args.vae_beta, args.lamb = 200, 1.0
        else:
            args.lamb = 1.0
    elif args.model == "vae2":
        args.ae_class = "VAE2"
        args.lamb = 1.0
        if args.vae_beta is None:
            args.vae_beta = 1.0
    else:
        args.vae_beta, args.lamb = 0.0, 0.0
    if args.downsample_steps is None:
        raise ValueError("downsample_steps cannot be None")
    if args.dataset == "OASIS" and args.aug_patch_size is None and args.width < 220:
        args.aug_patch_size = 220
    if args.dataset == "dHCP" and args.aug_patch_size is None and args.width < 256:
        args.aug_patch_size = 256
    # ACDCC/ARVC are deliberately NOT given the 180 default — the
    # reference's post-parse defaulting covers only ACDC/ACDCLBL
    # (reference: kwatsch/arguments.py:91-93); ACDCC volumes are
    # pre-centered so full-frame padding is the intended geometry
    if args.dataset in ("ACDC", "ACDCLBL") and args.aug_patch_size is None:
        args.aug_patch_size = 180
    if args.output_dir is not None:
        args.output_dir = os.path.expanduser(
            os.path.join(args.output_dir, args.exper_id))
    else:
        args.output_dir = os.path.expanduser(os.path.join(
            "~/expers/sr_redo", args.dataset, args.model, args.exper_id))
    if args.model_filename is not None:
        args.model_filename = os.path.expanduser(args.model_filename)

    return args, vars(args)
