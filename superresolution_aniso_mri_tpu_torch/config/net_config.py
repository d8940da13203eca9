"""(model, dataset, ae_class) → architecture defaults + trainer routing.

A copy of ``superresolution_aniso_mri_tpu/config/net_config.py``
(reference: networks/net_config.py:10-92), so that a run's merged
settings carry the same keys and values in both packages.
"""
from __future__ import annotations

import os
from typing import Dict


def _default_mix_loss(combined: bool):
    """Default image-mix loss for the combined families.

    Reference parity: combined models FORCE 'perceptual'
    (kwatsch/arguments.py:67-76, networks/net_config.py). Setting
    ``SR_MIX_LOSS_DEFAULT=mse`` overrides that DEFAULT only — an
    explicit ``--image_mix_loss_func`` always wins either way (the
    merge rule). This is the documented production override for
    environments without converted VGG16 weights, where the LPIPS
    fallback measurably adds nothing over MSE and the MSE recipe wins
    the production benchmarks (docs/DESIGN.md 'Fallback-LPIPS gap',
    docs/quality_real_r4.jsonl perceptual@450 head-to-head,
    README 'Recommended production recipes')."""
    if not combined:
        return None
    env = os.environ.get("SR_MIX_LOSS_DEFAULT")
    if env is None:
        return "perceptual"
    if env not in ("perceptual", "mse"):
        raise ValueError(
            f"SR_MIX_LOSS_DEFAULT={env!r}: expected 'perceptual' or "
            f"'mse'")
    return env


class NetworkConfig:
    def __init__(self, network: str, dataset: str = None,
                 ae_class: str = "VanillaACAI"):
        self.network = network
        self.dataset = dataset
        self.ae_class = ae_class
        self.architecture: Dict = {}
        self.load_config()

    def load_config(self) -> None:
        arch = self.architecture
        arch["width"] = 128
        arch["latent_width"] = 16
        arch["depth"] = 32
        arch["colors"] = 2 if self.dataset == "ACDCLBL" else 1
        arch["latent"] = 16
        arch["use_laploss"] = False
        arch["use_percept_loss"] = False
        arch["n_res_block"] = None
        arch["use_batchnorm"] = True
        arch["use_sigmoid"] = True
        arch["max_grad_norm"] = 0
        arch["fine_tune"] = False
        # shadowed in practice: the CLI default for --ex_loss_weight1 is
        # 0.001 (non-None), so the merge always overrides this — kept
        # because the reference's net_config carries the same dead value
        # (reference: networks/net_config.py:32, kwatsch/arguments.py:56)
        arch["ex_loss_weight1"] = 0.5
        arch["ae_class"] = self.ae_class

        net, ds = self.network, self.dataset
        # every dataset the CLI entry points and loaders support
        # (cli/entry.py BRAIN_DATASETS/CARDIAC_DATASETS,
        # data/datasets.py get_datasets)
        plain = (None, "ACDC", "ACDCC", "ARVC", "dHCP", "ADNI", "OASIS",
                 "brainMASI", "MNIST3D", "MNISTRoto")
        if net in ("ae", "aesr"):
            arch["image_mix_loss_func"] = None
            if ds == "ACDCLBL":
                arch["trainer_class"] = "MultiChannelTrainer"
                arch["nclasses"] = 4
            elif ds in plain:
                arch["trainer_class"] = "AETrainer"
            else:
                raise ValueError(f"unsupported combination {net}/{ds}")
        elif net in ("ae_combined", "aesr_combined"):
            arch["image_mix_loss_func"] = _default_mix_loss(True)
            if ds == "ACDCLBL":
                arch["trainer_class"] = "MultiChannelCAISRTrainer"
                arch["nclasses"] = 4
            elif ds in plain:
                arch["trainer_class"] = "AETrainerCombined"
            else:
                raise ValueError(f"unsupported combination {net}/{ds}")
        elif net in ("vae", "vae_combined", "vae2"):
            if ds in plain:
                arch["image_mix_loss_func"] = _default_mix_loss(
                    "combined" in net)
                arch["trainer_class"] = "VAETrainer"
            else:
                raise ValueError(f"VAE does not support dataset {ds}")
        elif net in ("acai", "acai_combined"):
            if ds in plain:
                arch["image_mix_loss_func"] = _default_mix_loss(
                    "combined" in net)
                arch["trainer_class"] = "ACAITrainer"
            else:
                raise ValueError(f"ACAI does not support dataset {ds}")
        elif net in ("alpha", "alpha_end_to_end", "alpha_only",
                     "alpha_combined"):
            # alpha-probe families (reference MODULE_PATH routes these to
            # kwatsch/alpha/*; Trainer builds ae+probe[+decoder_mix])
            if ds in plain or ds == "ACDCLBL":
                arch["image_mix_loss_func"] = None
                arch["trainer_class"] = "AlphaTrainer"
            else:
                raise ValueError(f"unsupported combination {net}/{ds}")
        else:
            raise ValueError(f"unknown network {net}")


def merge_args_architecture(args_dict: Dict, architecture: Dict) -> Dict:
    """CLI wins only when not None (reference:
    train_cardiac_aesr.py:23-30)."""
    merged = dict(architecture)
    for key, value in args_dict.items():
        if key in merged and value is None:
            continue
        merged[key] = value
    return merged
