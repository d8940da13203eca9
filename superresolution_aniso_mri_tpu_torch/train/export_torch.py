"""Reference-format torch checkpoints: writing, the inverse of
``import_torch``.

Port of ``superresolution_aniso_mri_tpu/train/export_torch.py``. Writes a
torch pickle of ``{'model_dict_ae', 'optimizer_dict_ae', 'epoch'}`` whose
``model_dict_ae`` is the ``nn.Sequential`` state dict of the reference's
Encoder/Decoder (reference: networks/acai_vanilla.py:49-102,112-138;
kwatsch/base_trainer.py:353-367), so the ORIGINAL PyTorch code loads a
model trained here. Its ``BaseTrainer.load`` restores the optimizer dict
too, so that is a fresh Adam state over the twin's parameters.

The keys come from a live torch twin of the reference's generator
(``build_reference_twin``), filled through ``import_torch``'s kind-by-kind
zip in the other direction. The port's 1x1 stem is VALID (shape-exact)
where the reference pads it by 1; keys and shapes are the same either
way (``stem_pad_parity`` evaluates the reference's geometry).
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch
from torch import nn

from ..models import VanillaACAI
from .import_torch import layer_pairs, split_sides

__all__ = ["build_reference_twin", "port_state_to_reference",
           "save_reference_checkpoint"]


class _ResBlock(nn.Module):
    """The reference ResBlock (acai_vanilla.py:20-35): ReLU, Conv3x3 to
    ``channel``, ReLU, Conv1x1 back, under ``conv``, plus the input."""

    def __init__(self, in_channel: int, channel: int = 128):
        super().__init__()
        self.conv = nn.Sequential(
            nn.ReLU(inplace=True),
            nn.Conv2d(in_channel, channel, 3, padding=1),
            nn.ReLU(inplace=True),
            nn.Conv2d(channel, in_channel, 1),
        )

    def forward(self, x):
        return x + self.conv(x)


class _ReferenceAE(nn.Module):
    def __init__(self, enc, dec):
        super().__init__()
        self.enc = nn.Sequential(*enc)
        self.dec = nn.Sequential(*dec)

    def forward(self, x):
        return self.dec(self.enc(x))

    def encode(self, x):
        return self.enc(x)

    def decode(self, z):
        return self.dec(z)


def build_reference_twin(width: int, latent_width: int, depth: int,
                         latent: int, colors: int = 1,
                         use_batchnorm: bool = True,
                         use_sigmoid: bool = True,
                         n_res_block: Optional[int] = None,
                         stem_padding: int = 0) -> nn.Module:
    """Torch twin of VanillaACAI in the reference generator's exact
    registration order (networks/acai_vanilla.py:49-102: per scale
    [Conv3x3, LeakyReLU] x2 [+BN] + AvgPool, optional ResBlocks, 3x3
    head; the decoder mirrored with Upsample(x2) and an optional final
    Sigmoid). ``stem_padding=1`` is the reference's padded 1x1 stem; keys
    and shapes are the same either way."""
    scales = int(round(math.log2(width // latent_width)))
    enc = [nn.Conv2d(colors, depth, 1, padding=stem_padding)]
    kp = depth
    for s in range(scales):
        k = depth << s
        enc += [nn.Conv2d(kp, k, 3, padding=1), nn.LeakyReLU(0.01),
                nn.Conv2d(k, k, 3, padding=1), nn.LeakyReLU(0.01)]
        if use_batchnorm:
            enc += [nn.BatchNorm2d(k)]
        enc += [nn.AvgPool2d(2)]
        kp = k
    if n_res_block:
        enc += [_ResBlock(kp) for _ in range(n_res_block)]
        enc += [nn.ReLU(inplace=True)]
    k = depth << scales
    enc += [nn.Conv2d(kp, k, 3, padding=1), nn.LeakyReLU(0.01),
            nn.Conv2d(k, latent, 3, padding=1)]

    dec = []
    if n_res_block:
        dec += [_ResBlock(latent) for _ in range(n_res_block)]
        dec += [nn.ReLU(inplace=True)]
    kp = latent
    for s in range(scales - 1, -1, -1):
        k = depth << s
        dec += [nn.Conv2d(kp, k, 3, padding=1), nn.LeakyReLU(0.01),
                nn.Conv2d(k, k, 3, padding=1), nn.LeakyReLU(0.01)]
        if use_batchnorm:
            dec += [nn.BatchNorm2d(k)]
        dec += [nn.Upsample(scale_factor=2)]
        kp = k
    dec += [nn.Conv2d(kp, depth, 3, padding=1), nn.LeakyReLU(0.01),
            nn.Conv2d(depth, colors, 3, padding=1)]
    if use_sigmoid:
        dec += [nn.Sigmoid()]
    return _ReferenceAE(enc, dec)


def port_state_to_reference(model: VanillaACAI,
                            twin: nn.Module) -> Dict[str, torch.Tensor]:
    """``twin``'s state dict with every conv and BatchNorm tensor taken
    from ``model`` (float32 CPU copies); raises ValueError when the layer
    counts or shapes differ (other architecture flags)."""
    sd = twin.state_dict()
    have = model.state_dict()
    out = dict(sd)
    for side, entries in split_sides(sd).items():
        if side not in ("enc", "dec"):
            raise ValueError(f"twin submodule {side!r} has no counterpart "
                             f"in the port's model")
        for ref_key, port_key in layer_pairs(model, side, entries):
            val = have[port_key]
            if tuple(val.shape) != tuple(sd[ref_key].shape):
                raise ValueError(
                    f"{port_key} → {ref_key}: shape {tuple(val.shape)} != "
                    f"the reference layout's {tuple(sd[ref_key].shape)}")
            out[ref_key] = val.detach().to("cpu", torch.float32).clone()
    return out


def save_reference_checkpoint(path: str, model: VanillaACAI, epoch: int = 0,
                              lr: float = 0.0001) -> None:
    """Write ``model`` as a reference-loadable ``.models`` torch pickle;
    its architecture comes from ``model.config``. ``optimizer_dict_ae``
    is a fresh Adam state over the twin's parameters (the reference's
    ``BaseTrainer.load`` restores it unconditionally,
    base_trainer.py:358-362)."""
    cfg = model.config
    twin = build_reference_twin(cfg.width, cfg.latent_width, cfg.depth,
                                cfg.latent, colors=cfg.colors,
                                use_batchnorm=cfg.use_batchnorm,
                                use_sigmoid=cfg.use_sigmoid,
                                n_res_block=cfg.n_res_block)
    twin.load_state_dict(port_state_to_reference(model, twin))
    opt = torch.optim.Adam(twin.parameters(), lr=lr)
    torch.save({"model_dict_ae": twin.state_dict(),
                "optimizer_dict_ae": opt.state_dict(),
                "epoch": int(epoch)}, path)
