"""Experiment checkpoints in the JAX package's on-disk layout.

Port of ``superresolution_aniso_mri_tpu/train/checkpoint.py``: the magic
``b"SRTPU1\\0\\0"``, the blob's length as ``<q``, then a flax msgpack
blob of ``{"model_dict_ae", "optimizer_dict_ae", "batch_stats",
"epoch"}`` (flax names and layouts, ``models/convert.py``; the optimizer
as the optax state's flax state dict, ``train/state.py``; the epoch a
0-d int64 array), written to ``<path>.tmp`` and renamed into place. So a
checkpoint of either package loads in the other. The JAX package's
reading of the reference's torch pickles is not ported.
"""
from __future__ import annotations

import os
import struct
import warnings
from typing import Any, Dict, Tuple

import numpy as np
import torch

from ..models import flax_to_torch
from ..models.convert import torch_to_flax
from . import msgpack
from .state import AdamState, TrainState

_MAGIC = b"SRTPU1\x00\x00"


def _to_host(groups):
    """Every tensor of ``groups`` (dicts of float32 tensors) in ONE
    device→host copy; returns the dicts with numpy arrays."""
    tensors = [t.detach() for g in groups for t in g.values()]
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError("checkpoint tensors must be float32")
    flat = torch.cat([t.reshape(-1) for t in tensors]).cpu().numpy()
    out, at = [], 0
    for g in groups:
        host = {}
        for key, t in g.items():
            host[key] = flat[at:at + t.numel()].reshape(t.shape)
            at += t.numel()
        out.append(host)
    return out


def save_checkpoint(path: str, state: TrainState, epoch: int) -> None:
    """Write the model, optimizer state and ``epoch`` of ``state``."""
    st = state.opt_state
    sd, mu, nu = _to_host([state.model.state_dict(), st.mu, st.nu])
    params, batch_stats = torch_to_flax(sd)
    payload = {
        "model_dict_ae": params,
        "optimizer_dict_ae": state.tx.opt_state_tree(
            AdamState(st.count, mu, nu, st.schedule_count)),
        "batch_stats": batch_stats,
        "epoch": np.asarray(int(epoch), np.int64),
    }
    blob = msgpack.packb(payload)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(_MAGIC)
        f.write(struct.pack("<q", len(blob)))
        f.write(blob)
    os.replace(tmp, path)


def load_checkpoint_raw(path: str) -> Dict[str, Any]:
    """The checkpoint's tree: nested dicts of numpy arrays."""
    with open(path, "rb") as f:
        if f.read(8) != _MAGIC:
            raise ValueError(f"{path}: not a SRTPU checkpoint (reference "
                             f"torch checkpoints are not read by the port)")
        (n,) = struct.unpack("<q", f.read(8))
        blob = f.read(n)
    return msgpack.unpackb(blob)


def load_checkpoint(path: str, state: TrainState) -> Tuple[TrainState, int]:
    """Restore the weights, BatchNorm statistics and optimizer state of
    ``path`` into ``state`` (in place); returns ``(state, epoch)``. An
    optimizer layout that differs from ``state``'s (another chain or
    schedule) restores the weights only and keeps ``state``'s own
    optimizer state, with a warning."""
    raw = load_checkpoint_raw(path)
    model = state.model
    sd = flax_to_torch(raw["model_dict_ae"], raw.get("batch_stats", {}),
                       model.config)
    model.load_state_dict(sd)
    try:
        state.tx.load_opt_state_tree(raw["optimizer_dict_ae"],
                                     state.opt_state, model)
    except (ValueError, KeyError, TypeError) as e:
        warnings.warn(
            f"{path}: optimizer state does not match the current "
            f"optimizer layout ({e}) — weights restored, optimizer "
            f"moments restart fresh")
    return state, int(raw.get("epoch", 0))
