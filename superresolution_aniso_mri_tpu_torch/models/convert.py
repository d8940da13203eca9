"""Flax parameter trees ↔ state dicts of the port's models.

Takes and gives the JAX package's ``(params, batch_stats)`` trees as
nested dicts of numpy arrays and needs nothing of JAX. A flax module
path maps to the port's module path component by component:

    Conv_i                      ↔ convs.i
    BatchNorm_i                 ↔ bns.i      (scale ↔ weight)
    head_cls_bn (MultiChannelAE's class-head BatchNorm), to_latent_bn,
    from_latent_bn (LegacyAEAdv's)
                                ↔ themselves (scale ↔ weight)
    ConvTranspose_i             ↔ ups.i
    Dense_i                     ↔ dense.i
    ResBlock_i/Conv_{0,1}       ↔ res.i.conv{0,1}
    BasicEncoderBlock_i, BasicDecoderBlock_i (the legacy models)
                                ↔ enc_blocks.i, dec_blocks.i
    Encoder_0 (the ACAI critic) ↔ encoder
    Decoder_0 (AlphaDecoder)    ↔ decoder
    _CompressZ_0 (the probes)   ↔ compress
    anything else (enc, dec, stem, head, out, encoder_mu, ae, disc,
    probe, decoder_mix, …)      ↔ itself
    batch_stats …/BatchNorm_i   ↔ running_mean / running_var

so ``params/enc/Conv_3/kernel`` is ``enc.convs.3.weight`` and the ACAI
family's ``{"ae": …, "disc": …}`` trees (the alpha families' ``{"ae",
"probe"[, "decoder_mix"]}``) are the state dict of a ``ModuleDict`` with
those keys. Conv kernels go HWIO ↔ OIHW,
Dense kernels ``[in, out]`` ↔ ``[out, in]``. A flax ``ConvTranspose``
(no kernel transpose) dilates its input by the stride, pads it by the
given ((2, 2), (2, 2)) and CORRELATES with the (kh, kw, in, out) kernel.
torch's ``conv_transpose2d(stride=2, padding=1)`` dilates, pads by
``k - 1 - padding = 2`` and correlates with the spatially FLIPPED
``(in, out, kh, kw)`` weight — so the flax kernel maps to torch as
``flip(kh, kw)`` then ``(in, out, kh, kw)``, and back the other way.

The same names map the Adam moment trees of the optimizer state (the
params part only): ``flax_moments_to_torch`` and ``torch_to_flax``. The
layout changes run as torch ops on the tensors' device (``device`` on
the way in), so a 4 GiB recipe VAE head is transposed on the card, not
by numpy on the host.
"""
from __future__ import annotations

import re
from typing import Dict, Iterator, Sequence, Tuple

import numpy as np
import torch

from ..device import to_host
from .config import AEConfig

_INDEXED = {"Conv": "convs", "BatchNorm": "bns", "ConvTranspose": "ups",
            "ResBlock": "res", "Dense": "dense",
            "BasicEncoderBlock": "enc_blocks",
            "BasicDecoderBlock": "dec_blocks"}
_FLAX_NAME = {v: k for k, v in _INDEXED.items()}
_RENAMED = {"Encoder_0": "encoder", "Decoder_0": "decoder",
            "_CompressZ_0": "compress"}
# BatchNorms that flax names by their attribute, not BatchNorm_i
_NAMED_BATCHNORMS = ("head_cls_bn", "to_latent_bn", "from_latent_bn")
_FLAX_RENAMED = {v: k for k, v in _RENAMED.items()}


def _kernel_kind(path: Sequence[str], ndim: int) -> str:
    if path[-1].startswith("ConvTranspose_"):
        return "conv_transpose"
    return "conv" if ndim == 4 else "dense"


def _port_shape(kind: str, shape) -> Tuple[int, ...]:
    order = {"conv": (3, 2, 0, 1), "conv_transpose": (2, 3, 0, 1),
             "dense": (1, 0)}.get(kind)
    return tuple(shape) if order is None else tuple(shape[i] for i in order)


def _port_layout(kind: str, t: torch.Tensor) -> torch.Tensor:
    """A flax kernel (as a tensor) in the port's layout."""
    if kind == "conv":
        return t.permute(3, 2, 0, 1)
    if kind == "conv_transpose":
        return t.flip(0, 1).permute(2, 3, 0, 1)
    if kind == "dense":
        return t.t()
    return t


def _conv_transpose_weight(kernel) -> np.ndarray:
    """The port's weight of a flax ``ConvTranspose`` kernel."""
    t = torch.from_numpy(np.asarray(kernel, np.float32))
    return _port_layout("conv_transpose", t).numpy()


def _torch_path(path: Sequence[str]) -> str:
    """The port's module path of a flax module path."""
    out = []
    for i, name in enumerate(path):
        m = re.fullmatch(r"([A-Za-z]+)_(\d+)", name)
        if i and path[i - 1].startswith("ResBlock_") and name in (
                "Conv_0", "Conv_1"):
            out.append(f"conv{name[-1]}")
        elif name in _RENAMED:
            out.append(_RENAMED[name])
        elif m and m.group(1) in _INDEXED:
            out += [_INDEXED[m.group(1)], m.group(2)]
        else:
            out.append(name)
    return ".".join(out)


_Leaf = Tuple[str, np.ndarray]   # (layout kind, the flax array)


def _flat_params(tree, path: Tuple[str, ...] = ()
                 ) -> Iterator[Tuple[str, _Leaf]]:
    """(port name, leaf) of every leaf of a flax params tree (empty
    subtrees, such as optax's masked moments, hold none)."""
    for key, val in tree.items():
        if isinstance(val, dict):
            yield from _flat_params(val, path + (key,))
            continue
        name = _torch_path(path)
        arr = np.asarray(val, np.float32)
        if key == "kernel":
            yield f"{name}.weight", (_kernel_kind(path, arr.ndim), arr)
        elif key in ("scale", "bias"):
            yield (f"{name}.{'weight' if key == 'scale' else 'bias'}",
                   ("vector", arr))
        else:
            raise ValueError(f"unknown flax leaf {'/'.join(path + (key,))}")


def _flat_stats(tree, path: Tuple[str, ...] = ()
                ) -> Iterator[Tuple[str, _Leaf]]:
    for key, val in tree.items():
        if isinstance(val, dict):
            yield from _flat_stats(val, path + (key,))
        elif key in ("mean", "var"):
            leaf = "running_mean" if key == "mean" else "running_var"
            yield (f"{_torch_path(path)}.{leaf}",
                   ("vector", np.asarray(val, np.float32)))
        else:
            raise ValueError(f"unknown batch_stats leaf "
                             f"{'/'.join(path + (key,))}")


def _matched(flat: Dict[str, _Leaf], want: Dict[str, torch.Tensor],
             cfg: AEConfig, device=None) -> Dict[str, torch.Tensor]:
    """The tensors of ``flat`` in the port's layout on ``device`` (default
    the CPU), each its own copy; raises unless the names and shapes are
    those of ``want``."""
    missing = sorted(set(want) - set(flat))
    extra = sorted(set(flat) - set(want))
    if missing or extra:
        raise ValueError(f"flax tree does not match {cfg}: missing "
                         f"{missing}, unexpected {extra}")
    out = {}
    for key, ref in want.items():
        kind, arr = flat[key]
        shape = _port_shape(kind, arr.shape)
        if shape != tuple(ref.shape):
            raise ValueError(f"{key}: flax shape {shape} != port shape "
                             f"{tuple(ref.shape)}")
        t = torch.from_numpy(np.array(arr, np.float32)).to(device or "cpu")
        out[key] = _port_layout(kind, t).contiguous()
    return out


def _flat_variables(params, batch_stats) -> Dict[str, _Leaf]:
    """Every parameter and running statistic of a flax variables tree;
    raises when a BatchNorm has no statistics."""
    flat = dict(_flat_params(params))
    stats = dict(_flat_stats(batch_stats or {}))
    for key in flat:
        parts = key.split(".")
        if parts[-1] == "weight" and (
                (len(parts) >= 3 and parts[-3] == "bns")
                or (len(parts) >= 2 and parts[-2] in _NAMED_BATCHNORMS)):
            mod = key[:-len(".weight")]
            if f"{mod}.running_mean" not in stats:
                raise ValueError(
                    f"{mod}: no batch_stats for this BatchNorm — pass the "
                    f"full (params, batch_stats)")
    flat.update(stats)
    return flat


def flax_to_torch(params, batch_stats, cfg: AEConfig, model=None,
                  device=None) -> Dict[str, torch.Tensor]:
    """State dict for ``model`` (default ``VanillaACAI(cfg)``) from a
    flax ``(params, batch_stats)`` tree of numpy arrays. A family
    wrapper (``{"ae", "disc"}``, ``{"ae", "probe"[, "decoder_mix"]}``)
    gives its ``ae`` part unless ``model`` is itself the wrapper. The tensors are on
    ``device`` (default the CPU). Raises when the tree and the model
    disagree (a missing or extra layer, or a wrong shape)."""
    if model is None:
        from .acai import VanillaACAI
        model = VanillaACAI(cfg)
    want = model.state_dict()
    if ("ae" in params and "enc" not in params
            and not any(k.startswith("ae.") for k in want)):
        params = params["ae"]
        batch_stats = (batch_stats or {}).get("ae", {})
    return _matched(_flat_variables(params, batch_stats), want, cfg, device)


def flax_encoder_to_torch(variables, cfg: AEConfig) -> Dict[str, torch.Tensor]:
    """State dict for ``Encoder(cfg)`` from the variables of a flax
    ``Encoder`` alone (``{"params": ..., "batch_stats": ...}``, the
    ``enc`` subtree of a trained model, as the encoder-perceptual
    artifact stores it). Raises on any mismatch, like ``flax_to_torch``."""
    from .acai import Encoder

    flat = _flat_variables(variables["params"],
                           variables.get("batch_stats") or {})
    return _matched(flat, Encoder(cfg).state_dict(), cfg)


def flax_moments_to_torch(tree, cfg: AEConfig, params_like=None
                          ) -> Dict[str, torch.Tensor]:
    """``{parameter name: tensor}`` from a tree shaped like the flax
    params (an optax ``mu`` or ``nu``; optax's masked leaves, empty
    dicts, hold nothing), matched against the names and shapes of
    ``params_like`` (default: ``VanillaACAI(cfg)``'s parameters) and on
    their device. Raises on any mismatch."""
    if params_like is None:
        from .acai import VanillaACAI
        params_like = dict(VanillaACAI(cfg).named_parameters())
    device = next(iter(params_like.values())).device if params_like else None
    return _matched(dict(_flat_params(tree)), params_like, cfg, device)


def flax_key(name: str) -> Tuple[str, Tuple[str, ...], str]:
    """(collection, flax module path, flax leaf) of a port state-dict
    name: ``enc.convs.3.weight`` → ``('params', ('enc', 'Conv_3'),
    'kernel')``; running statistics are in ``'batch_stats'``."""
    *mod, leaf = name.split(".")
    path, i = [], 0
    while i < len(mod):
        part = mod[i]
        if part in _FLAX_NAME and i + 1 < len(mod) and mod[i + 1].isdigit():
            path.append(f"{_FLAX_NAME[part]}_{mod[i + 1]}")
            i += 2
            continue
        if path and path[-1].startswith("ResBlock_") and part in (
                "conv0", "conv1"):
            path.append(f"Conv_{part[-1]}")
        else:
            path.append(_FLAX_RENAMED.get(part, part))
        i += 1
    if leaf in ("running_mean", "running_var"):
        return "batch_stats", tuple(path), leaf[len("running_"):]
    if leaf == "weight":
        leaf = ("scale" if path[-1].startswith("BatchNorm_")
                or path[-1] in _NAMED_BATCHNORMS else "kernel")
    return "params", tuple(path), leaf


def _flax_layout(path: Tuple[str, ...], leaf: str,
                 t: torch.Tensor) -> torch.Tensor:
    """A port tensor in the layout of flax's leaf (on its device)."""
    if leaf != "kernel":
        return t
    kind = _kernel_kind(path, t.ndim)
    if kind == "conv":
        return t.permute(2, 3, 1, 0)
    if kind == "conv_transpose":
        return t.permute(2, 3, 0, 1).flip(0, 1)
    return t.t()


def set_in(tree: dict, path: Sequence[str], value) -> None:
    for name in path[:-1]:
        tree = tree.setdefault(name, {})
    tree[path[-1]] = value


def torch_to_flax(state_dict) -> Tuple[dict, dict]:
    """The inverse of ``flax_to_torch``: a state dict of any of the
    port's models (or any ``{port name: tensor or array}`` subset of it,
    such as an Adam moment dict) → ``(params, batch_stats)`` trees of
    float32 numpy arrays, in flax's names and layouts. ``batch_stats``
    is ``{}`` when the dict holds no running statistics."""
    keys = {key: flax_key(key) for key in state_dict}
    laid = {}
    for key, (_, path, leaf) in keys.items():
        val = state_dict[key]
        t = (val.detach() if isinstance(val, torch.Tensor)
             else torch.from_numpy(np.asarray(val, np.float32)))
        laid[key] = _flax_layout(path, leaf, t.float()).contiguous()
    (host,) = to_host([laid])
    trees = {"params": {}, "batch_stats": {}}
    for key, (coll, path, leaf) in keys.items():
        set_in(trees[coll], path + (leaf,), host[key])
    return trees["params"], trees["batch_stats"]
