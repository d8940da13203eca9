"""Reference-format torch checkpoints: reading.

Port of ``superresolution_aniso_mri_tpu/train/import_torch.py``. The
reference persists an experiment's checkpoints as torch pickles of
``{'model_dict_ae', 'optimizer_dict_ae', 'epoch'}`` (reference:
kwatsch/base_trainer.py:353-367) whose ``model_dict_ae`` is the state
dict of its ``nn.Sequential`` Encoder and Decoder, keyed by index
(``enc.3.weight``; reference: networks/acai_vanilla.py:49-102).

Both networks register the same layers in the same call order, so each
side's indexed entries are classified by kind (a conv carries a 4-D
``weight``, a BatchNorm ``running_mean``, a ResBlock nested
``conv.<i>.*`` keys) and zipped, kind by kind and in order, against the
port's module names (``models/acai.py``): convs ``stem``, ``convs.i``,
``head`` (encoder) and ``convs.i``, ``out`` (decoder), ``bns.i``,
``res.i.conv0`` / ``conv1``. The other ``ae_class`` models with the same
``enc`` / ``dec`` layout (LargerAE, VanillaACAIStrided, whose strided
convs sit in ``convs`` in call order) map the same way; as in JAX, the
sides without convs (the VAE's Dense heads) keep their values, and a
checkpoint side other than ``enc`` / ``dec`` is refused. Both are NCHW, so the tensors are copied as they are. For the ACAI
family's ``{"ae", "disc"}`` model the checkpoint (the reference stores
only ``model_dict_ae``) fills the ``ae`` and the critic keeps its
values. Optimizer moments are not imported: torch Adam's state has no
counterpart in the optax chain's, so they restart fresh, as in JAX.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch
from torch import nn

__all__ = ["is_torch_checkpoint", "load_torch_reference",
           "reference_state_to_port"]


def is_torch_checkpoint(path: str) -> bool:
    """True if the file looks like a ``torch.save`` artifact (a zip
    archive, torch >= 1.6, or a legacy pickle stream), not ``SRTPU1``."""
    with open(path, "rb") as f:
        head = f.read(8)
    # PK: zip archive; 0x80: the pickle PROTO opcode (protocol >= 2)
    return head[:2] == b"PK" or head[:1] == b"\x80"


def load_reference_pickle(path: str) -> dict:
    """The checkpoint's dict, read with ``weights_only=True`` (tensors,
    containers and numbers only: nothing in the file runs as code)."""
    raw = torch.load(path, map_location="cpu", weights_only=True)
    if not isinstance(raw, dict) or "model_dict_ae" not in raw:
        raise ValueError(f"{path}: torch checkpoint without "
                         f"'model_dict_ae' — not a reference .models file")
    return raw


def split_sides(sd) -> Dict[str, Dict[str, torch.Tensor]]:
    """'enc.3.weight'-style keys as {side: {'3.weight': tensor}}, in the
    state dict's order."""
    sides: Dict[str, Dict[str, torch.Tensor]] = {}
    for key, val in sd.items():
        side, _, rest = key.partition(".")
        sides.setdefault(side, {})[rest] = val
    return sides


def reference_layers(entries: Dict[str, torch.Tensor]):
    """(convs, bns, res) of one side's indexed entries, each in index
    order: ``(index, {leaf: tensor})``, and for a ResBlock ``(index,
    [(inner index, {leaf: tensor}), ...])`` (reference:
    networks/acai_vanilla.py:20-35: ReLU, Conv3x3, ReLU, Conv1x1 under
    ``conv``). Anything else raises NotImplementedError: skipping a layer
    would leave its weights at their initial values."""
    by_idx: Dict[str, Dict[str, torch.Tensor]] = {}
    for rest, val in entries.items():
        idx, _, leaf = rest.partition(".")
        by_idx.setdefault(idx, {})[leaf] = val
    convs, bns, res = [], [], []
    for idx, leaves in by_idx.items():
        if "running_mean" in leaves:
            bns.append((idx, leaves))
        elif "weight" in leaves and leaves["weight"].ndim == 4:
            convs.append((idx, leaves))
        elif all("." in k for k in leaves) and any(
                k.endswith(".weight") for k in leaves):
            sub: Dict[int, Dict[str, torch.Tensor]] = {}
            for k, val in leaves.items():
                parts = k.split(".")
                if len(parts) != 3 or parts[0] != "conv":
                    raise NotImplementedError(
                        f"unsupported nested torch submodule at index "
                        f"{idx} (key {k!r} — not a reference ResBlock)")
                sub.setdefault(int(parts[1]), {})[parts[2]] = val
            res.append((idx, [(i, sub[i]) for i in sorted(sub)]))
        else:
            raise NotImplementedError(
                f"unsupported torch layer at index {idx} "
                f"(leaves: {sorted(leaves)})")
    return convs, bns, res


def port_layers(model: nn.Module, side: str
                ) -> Tuple[List[str], List[str], List[str]]:
    """(conv, BatchNorm, ResBlock) module paths of one side of the port's
    model, each in call order."""
    mod = getattr(model, side)
    if side == "dec" and len(getattr(mod, "ups", ())):
        raise NotImplementedError(
            "the transposed-conv decoder (use_upsample=False) has no "
            "reference checkpoint layout: torch and flax transposed "
            "convolutions differ, as the JAX importer says")
    convs = [f"{side}.convs.{i}" for i in range(len(mod.convs))]
    convs = ([f"{side}.stem"] + convs + [f"{side}.head"] if side == "enc"
             else convs + [f"{side}.out"])
    return (convs, [f"{side}.bns.{i}" for i in range(len(mod.bns))],
            [f"{side}.res.{i}" for i in range(len(getattr(mod, "res", ())))])


def layer_pairs(model: nn.Module, side: str, entries):
    """[(reference key, port key)] of every tensor of one side, from the
    kind-by-kind zip; raises when the layer counts differ."""
    convs, bns, res = reference_layers(entries)
    p_convs, p_bns, p_res = port_layers(model, side)
    if (len(convs), len(bns), len(res)) != (len(p_convs), len(p_bns),
                                            len(p_res)):
        raise ValueError(
            f"{side}: torch has {len(convs)} convs / {len(bns)} BNs / "
            f"{len(res)} ResBlocks but the port's model has "
            f"{len(p_convs)} / {len(p_bns)} / {len(p_res)} — architecture "
            f"flags (width/latent_width/depth/use_batchnorm/n_res_block) "
            f"do not match the checkpoint")
    pairs = []
    for (idx, leaves), name in zip(convs, p_convs):
        if "bias" not in leaves:
            raise ValueError(
                f"{side}.{idx}: torch conv has no bias — the port's convs "
                f"always have one, so this checkpoint comes from another "
                f"architecture variant")
        pairs += [(f"{side}.{idx}.{leaf}", f"{name}.{leaf}")
                  for leaf in ("weight", "bias")]
    for (idx, subconvs), name in zip(res, p_res):
        if len(subconvs) != 2:
            raise ValueError(f"{side}.{idx} → {name}: torch ResBlock has "
                             f"{len(subconvs)} convs, the port's has 2")
        pairs += [(f"{side}.{idx}.conv.{i}.{leaf}", f"{name}.conv{j}.{leaf}")
                  for j, (i, _) in enumerate(subconvs)
                  for leaf in ("weight", "bias")]
    for (idx, _), name in zip(bns, p_bns):
        pairs += [(f"{side}.{idx}.{leaf}", f"{name}.{leaf}")
                  for leaf in ("weight", "bias", "running_mean",
                               "running_var")]
    return pairs


def reference_state_to_port(torch_sd, model: nn.Module
                            ) -> Dict[str, torch.Tensor]:
    """The port's state dict for the ``enc`` / ``dec`` of ``model`` from
    a reference NCHW state dict. Raises ValueError on a side the model
    lacks, a conv-owning side of the model the checkpoint lacks (a
    partial artifact would otherwise serve a random decoder), other layer
    counts or other shapes; NotImplementedError on a side other than
    ``enc`` / ``dec``."""
    sides = split_sides(torch_sd)
    model_sides = sorted(name for name, mod in model.named_children()
                         if any(p.ndim == 4 for p in mod.parameters()))
    unknown = sorted(set(sides) - {n for n, _ in model.named_children()})
    if unknown:
        raise ValueError(
            f"torch checkpoint has submodules {unknown} with no "
            f"counterpart (model sides: {model_sides}) — wrong ae_class "
            f"for this checkpoint? (MultiChannelAE / ACDCLBL reference "
            f"checkpoints are not importable: the decoder head structure "
            f"differs)")
    missing = sorted(set(model_sides) - set(sides))
    if missing:
        raise ValueError(
            f"torch checkpoint is missing submodules {missing} that the "
            f"model requires (checkpoint sides: {sorted(sides)}) — "
            f"partial/encoder-only artifact?")
    other = sorted(set(sides) - {"enc", "dec"})
    if other:
        raise NotImplementedError(
            f"torch checkpoint sides {other}: only the enc / dec layers of "
            f"the reference's Sequential networks have an importer")
    want = model.state_dict()
    out = {}
    for side, entries in sides.items():
        for ref_key, port_key in layer_pairs(model, side, entries):
            val = torch_sd[ref_key]
            if tuple(val.shape) != tuple(want[port_key].shape):
                raise ValueError(
                    f"{ref_key} → {port_key}: shape {tuple(val.shape)} != "
                    f"the model's {tuple(want[port_key].shape)}")
            out[port_key] = val.to(torch.float32)
    return out


def load_torch_reference(path: str, state) -> Tuple[object, int]:
    """Restore a reference ``.models`` torch pickle into ``state``'s model
    (in place; the ACAI family's ``ae``, the critic untouched); returns
    ``(state, epoch)``. The optimizer state is left as it is (fresh)."""
    raw = load_reference_pickle(path)
    model = state.model
    if isinstance(model, nn.ModuleDict):
        model = model["ae"]
    model.load_state_dict({**model.state_dict(), **reference_state_to_port(
        raw["model_dict_ae"], model)})
    return state, int(raw.get("epoch", 0))
