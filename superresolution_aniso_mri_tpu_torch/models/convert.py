"""Flax parameter tree → state dict of the port's ``VanillaACAI``.

Takes the JAX package's ``(params, batch_stats)`` tree as nested dicts
of numpy arrays (``{"enc": {...}, "dec": {...}}``, or a family wrapper
``{"ae": {...}}``) and needs nothing of JAX. Names map as

    params/{enc,dec}/stem|head|out         → {enc,dec}.stem|head|out
    params/{enc,dec}/Conv_i                → {enc,dec}.convs.i
    params/{enc,dec}/BatchNorm_i           → {enc,dec}.bns.i (scale → weight)
    batch_stats/{enc,dec}/BatchNorm_i      → running_mean / running_var
    params/dec/ConvTranspose_i             → dec.ups.i
    params/{enc,dec}/ResBlock_i/Conv_{0,1} → {enc,dec}.res.i.conv{0,1}

Conv kernels go HWIO → OIHW. A flax ``ConvTranspose`` (no kernel
transpose) dilates its input by the stride, pads it by the given
((2, 2), (2, 2)) and CORRELATES with the (kh, kw, in, out) kernel.
torch's ``conv_transpose2d(stride=2, padding=1)`` dilates, pads by
``k - 1 - padding = 2`` and correlates with the spatially FLIPPED
``(in, out, kh, kw)`` weight — so the flax kernel maps to torch as
``flip(kh, kw)`` then ``(in, out, kh, kw)``.
"""
from __future__ import annotations

import re
from typing import Dict

import numpy as np
import torch

from .config import AEConfig

_INDEXED = {"Conv": "convs", "BatchNorm": "bns", "ConvTranspose": "ups",
            "ResBlock": "res"}


def _oihw(kernel) -> np.ndarray:
    return np.transpose(np.asarray(kernel, np.float32), (3, 2, 0, 1))


def _conv_transpose_weight(kernel) -> np.ndarray:
    k = np.asarray(kernel, np.float32)[::-1, ::-1]
    return np.transpose(k, (2, 3, 0, 1))


def _module_path(name: str) -> str:
    m = re.fullmatch(r"([A-Za-z]+)_(\d+)", name)
    if m and m.group(1) in _INDEXED:
        return f"{_INDEXED[m.group(1)]}.{m.group(2)}"
    return name


def _conv_entries(prefix: str, leaf: dict, transpose: bool = False):
    w = (_conv_transpose_weight(leaf["kernel"]) if transpose
         else _oihw(leaf["kernel"]))
    return {f"{prefix}.weight": w,
            f"{prefix}.bias": np.asarray(leaf["bias"], np.float32)}


def flax_to_torch(params, batch_stats, cfg: AEConfig) -> Dict[str, torch.Tensor]:
    """State dict for ``VanillaACAI(cfg)`` from a flax ``(params,
    batch_stats)`` tree of numpy arrays. Raises when the tree and
    ``cfg`` disagree (a missing or extra layer, or a wrong shape)."""
    from .acai import VanillaACAI

    if "enc" not in params and "ae" in params:
        params = params["ae"]
        batch_stats = (batch_stats or {}).get("ae", {})
    batch_stats = batch_stats or {}
    flat: Dict[str, np.ndarray] = {}
    for side in ("enc", "dec"):
        if side not in params:
            raise ValueError(f"flax tree has no {side!r} (keys: "
                             f"{sorted(params)})")
        stats = batch_stats.get(side, {}) or {}
        for name, leaf in params[side].items():
            path = f"{side}.{_module_path(name)}"
            if name.startswith("ResBlock_"):
                for sub in ("Conv_0", "Conv_1"):
                    flat.update(_conv_entries(f"{path}.conv{sub[-1]}",
                                              leaf[sub]))
            elif name.startswith("BatchNorm_"):
                if name not in stats:
                    raise ValueError(
                        f"{side}/{name}: no batch_stats for this "
                        f"BatchNorm — pass the full (params, batch_stats)")
                flat[f"{path}.weight"] = np.asarray(leaf["scale"], np.float32)
                flat[f"{path}.bias"] = np.asarray(leaf["bias"], np.float32)
                flat[f"{path}.running_mean"] = np.asarray(
                    stats[name]["mean"], np.float32)
                flat[f"{path}.running_var"] = np.asarray(
                    stats[name]["var"], np.float32)
            else:
                flat.update(_conv_entries(
                    path, leaf, transpose=name.startswith("ConvTranspose_")))

    want = VanillaACAI(cfg).state_dict()
    missing = sorted(set(want) - set(flat))
    extra = sorted(set(flat) - set(want))
    if missing or extra:
        raise ValueError(f"flax tree does not match {cfg}: missing "
                         f"{missing}, unexpected {extra}")
    out = {}
    for key, ref in want.items():
        arr = flat[key]
        if tuple(arr.shape) != tuple(ref.shape):
            raise ValueError(f"{key}: flax shape {tuple(arr.shape)} != "
                             f"port shape {tuple(ref.shape)}")
        out[key] = torch.from_numpy(np.array(arr, np.float32))  # own copy
    return out
