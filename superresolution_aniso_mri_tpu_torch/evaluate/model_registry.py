"""Experiment/model registries for paper-style evaluations.

Port of ``superresolution_aniso_mri_tpu/evaluate/model_registry.py``
(reference: evaluate/cardiac_model_list.py:11-84 and
evaluate/brain_model_list.py): dicts mapping experiment names to
(experiment path, checkpoint id), kept in a YAML file next to the
experiments and read with ``config.settings.parse_model_registry``
(no pyyaml):

  my_caisr_acdc:
    path: ~/expers/sr/ACDC/ae_combined/f0_128
    checkpoint: caisr        # or an epoch number
    downsample_steps: 2
"""
from __future__ import annotations

import os
from typing import Dict

from ..config.settings import load_model_registry

# built-in empty registries, extended at runtime or from a file
CARDIAC_MODEL_SPECS: Dict[str, Dict] = {}
BRAIN_MODEL_SPECS: Dict[str, Dict] = {}


def load_model_specs(path: str) -> Dict[str, Dict]:
    specs = load_model_registry(os.path.expanduser(path))
    for name, spec in specs.items():
        if not isinstance(spec, dict):
            raise ValueError(
                f"{path}: registry entry {name!r} must be a mapping "
                f"with a 'path' key (got {type(spec).__name__})")
        if "path" not in spec:
            raise ValueError(
                f"{path}: registry entry {name!r} has no 'path'")
        spec.setdefault("checkpoint", "caisr")
        spec["path"] = os.path.expanduser(str(spec["path"]))
    return specs


def register_model(registry: Dict[str, Dict], name: str, path: str,
                   checkpoint="caisr", **extra) -> None:
    registry[name] = {"path": os.path.expanduser(path),
                      "checkpoint": checkpoint, **extra}


def get_trainer_for_spec(spec: Dict, device=None):
    """Rehydrate the eval-mode trainer referenced by a registry entry on
    ``device`` (None: the CUDA device)."""
    from ..train import get_trainer

    # an empty 'checkpoint:' field reads as None, and get_trainer's
    # model_nbr=None would load no weights: fall back to the default
    # alias (an explicit None test: `or` would also drop epoch 0)
    ckpt = spec.get("checkpoint", "caisr")
    if ckpt is None:
        ckpt = "caisr"
    if isinstance(ckpt, str) and ckpt.isdigit():
        ckpt = int(ckpt)
    return get_trainer(spec["path"], model_nbr=ckpt, eval_mode=True,
                       device=device)
