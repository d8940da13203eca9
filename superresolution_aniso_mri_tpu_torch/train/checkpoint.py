"""Experiment checkpoints in the JAX package's on-disk layout.

Port of ``superresolution_aniso_mri_tpu/train/checkpoint.py``: the magic
``b"SRTPU1\\0\\0"``, the blob's length as ``<q``, then a flax msgpack
blob of ``{"model_dict_ae", "optimizer_dict_ae", "batch_stats",
"epoch"}`` (flax names and layouts, ``models/convert.py``; the optimizer
as the optax state's flax state dict, ``train/state.py``; the epoch a
0-d int64 array), written to ``<path>.tmp`` and renamed into place. So a
checkpoint of either package loads in the other. ``load_checkpoint``
also reads the reference's torch pickles (``train/import_torch.py``),
whose optimizer moments restart fresh.
"""
from __future__ import annotations

import os
import struct
import warnings
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..models import flax_to_torch, model_config
from ..models.convert import torch_to_flax
from . import msgpack
from .import_torch import is_torch_checkpoint, load_torch_reference
from .state import TrainState

_MAGIC = b"SRTPU1\x00\x00"


def save_checkpoint(path: str, state: TrainState, epoch: int,
                    params: Optional[Dict[str, torch.Tensor]] = None) -> None:
    """Write the model, optimizer state and ``epoch`` of ``state``;
    ``params`` (e.g. the EMA weights) replace the model's parameters of
    the same names. The ACAI family's ``{"ae", "disc"}`` model is stored
    as the dict trees JAX stores. The blob is streamed to the file."""
    model = state.model
    tree, batch_stats = torch_to_flax({**model.state_dict(), **(params or {})})
    if isinstance(model, torch.nn.ModuleDict):
        # JAX keeps each group's (possibly empty) statistics tree
        batch_stats = {k: batch_stats.get(k, {}) for k in model}
    payload = {
        "model_dict_ae": tree,
        "optimizer_dict_ae": state.tx.opt_state_tree(state.opt_state),
        "batch_stats": batch_stats,
        "epoch": np.asarray(int(epoch), np.int64),
    }
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(_MAGIC)
        f.write(struct.pack("<q", 0))
        n = msgpack.pack_to(f.write, payload)
        f.seek(len(_MAGIC))
        f.write(struct.pack("<q", n))
    os.replace(tmp, path)


def load_checkpoint_raw(path: str) -> Dict[str, Any]:
    """The checkpoint's tree: nested dicts of numpy arrays."""
    with open(path, "rb") as f:
        if f.read(8) != _MAGIC:
            if is_torch_checkpoint(path):
                raise ValueError(
                    f"{path}: not a SRTPU checkpoint but a reference-format "
                    f"torch checkpoint — load it through load_checkpoint() "
                    f"/ Trainer.load() (detected there) or convert it with "
                    f"the port's convert-reference-checkpoint command")
            raise ValueError(f"{path}: not a SRTPU checkpoint")
        (n,) = struct.unpack("<q", f.read(8))
        blob = f.read(n)
    return msgpack.unpackb(blob)


def load_checkpoint(path: str, state: TrainState) -> Tuple[TrainState, int]:
    """Restore the weights, BatchNorm statistics and optimizer state of
    ``path`` into ``state`` (in place); returns ``(state, epoch)``. An
    optimizer layout that differs from ``state``'s (another chain or
    schedule) restores the weights only and keeps ``state``'s own
    optimizer state, with a warning. A reference torch pickle restores
    the weights and BatchNorm statistics only."""
    if is_torch_checkpoint(path):
        return load_torch_reference(path, state)
    raw = load_checkpoint_raw(path)
    model = state.model
    cfg = model_config(model)
    sd = flax_to_torch(raw["model_dict_ae"], raw.get("batch_stats", {}),
                       cfg, model, device=next(model.parameters()).device)
    model.load_state_dict(sd)
    try:
        state.tx.load_opt_state_tree(raw["optimizer_dict_ae"],
                                     state.opt_state, state.params(), cfg)
    except (ValueError, KeyError, TypeError) as e:
        warnings.warn(
            f"{path}: optimizer state does not match the current "
            f"optimizer layout ({e}) — weights restored, optimizer "
            f"moments restart fresh")
    return state, int(raw.get("epoch", 0))
