"""The image + segmentation autoencoder of the labeled cardiac path
(ACDCLBL), NCHW: ``MultiChannelAE`` with its half-stem encoder and
decoder trunk.

Port of ``superresolution_aniso_mri_tpu/models/multi_channel.py``
(reference: networks/acai_multi_channel.py:22-103). ``LargerAE``
(``models/variants.py``) is built from the same encoder and trunk.

Parameter names follow the flax modules' flat names: the encoder's
``stem``, ``Conv_i`` → ``convs.i``, ``BatchNorm_i`` → ``bns.i`` and
``head``; the trunk's ``Conv_0`` (the 1x1 latent expansion) and
``BatchNorm_0`` first, then one conv pair and BatchNorm per scale and
the last conv, in call order. ``MultiChannelAE``'s own layers keep
their flax names: ``enc``, ``trunk``, ``head_image``, ``head_cls_a``,
``head_cls_bn``, ``head_cls_b``.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

from .acai import BatchNorm, Conv, _leaky, reset_parameters
from .config import AEConfig


class HalfStemEncoder(nn.Module):
    """Encoder whose 1x1 stem maps to ``depth // 2`` channels; per scale
    [3x3 conv, LeakyReLU] x2 (+BN) + 2x2 avg-pool; 3x3 head."""

    def __init__(self, config: AEConfig):
        super().__init__()
        cfg = self.config = config
        self.stem = Conv(cfg.colors, cfg.depth // 2, 1)
        convs, bns = [], []
        cin = cfg.depth // 2
        for scale in range(cfg.scales):
            k = cfg.depth << scale
            convs += [Conv(cin, k, 3), Conv(k, k, 3)]
            if cfg.use_batchnorm:
                bns.append(BatchNorm(k))
            cin = k
        k = cfg.depth << cfg.scales
        convs.append(Conv(cin, k, 3))
        self.convs = nn.ModuleList(convs)
        self.bns = nn.ModuleList(bns)
        self.head = Conv(k, cfg.latent, 3)

    def forward(self, x: torch.Tensor, train: bool = False,
                update_stats: bool = True) -> torch.Tensor:
        cfg = self.config
        x = x.to(cfg.dtype)
        if cfg.stem_pad_parity:
            x = F.pad(x, (1, 1, 1, 1))
        x = self.stem(x)
        for scale in range(cfg.scales):
            x = _leaky(self.convs[2 * scale](x))
            x = _leaky(self.convs[2 * scale + 1](x))
            if cfg.use_batchnorm:
                x = self.bns[scale](x, train, update_stats)
            x = F.avg_pool2d(x, 2)
        x = _leaky(self.convs[-1](x))
        return self.head(x).float()


class TrunkDecoder(nn.Module):
    """The shared decoder trunk: 1x1 latent expansion to ``depth <<
    scales`` channels (+BN), per scale [3x3 conv, LeakyReLU] x2 (+BN) +
    nearest 2x upsample, last 3x3 conv to ``depth`` channels. Returns
    the features in the compute dtype."""

    def __init__(self, config: AEConfig):
        super().__init__()
        cfg = self.config = config
        top = cfg.depth << cfg.scales
        convs = [Conv(cfg.latent, top, 1)]
        bns = [BatchNorm(top)] if cfg.use_batchnorm else []
        cin = top
        for scale in range(cfg.scales - 1, -1, -1):
            k = cfg.depth << scale
            convs += [Conv(cin, k, 3), Conv(k, k, 3)]
            if cfg.use_batchnorm:
                bns.append(BatchNorm(k))
            cin = k
        convs.append(Conv(cin, cfg.depth, 3))
        self.convs = nn.ModuleList(convs)
        self.bns = nn.ModuleList(bns)

    def trunk(self, z: torch.Tensor, train: bool = False,
              update_stats: bool = True) -> torch.Tensor:
        cfg = self.config
        bn = iter(self.bns)
        x = _leaky(self.convs[0](z.to(cfg.dtype)))
        if cfg.use_batchnorm:
            x = next(bn)(x, train, update_stats)
        for i in range(cfg.scales):
            x = _leaky(self.convs[1 + 2 * i](x))
            x = _leaky(self.convs[2 + 2 * i](x))
            if cfg.use_batchnorm:
                x = next(bn)(x, train, update_stats)
            x = F.interpolate(x, scale_factor=2, mode="nearest")
        return _leaky(self.convs[-1](x))

    def forward(self, z: torch.Tensor, train: bool = False,
                update_stats: bool = True) -> torch.Tensor:
        return self.trunk(z, train, update_stats)


class MultiChannelAE(nn.Module):
    """encode / decode / forward over a ``HalfStemEncoder`` of
    ``colors`` (image, label) input planes and a ``TrunkDecoder`` that
    feeds two heads: ``head_image`` (3x3 to one plane, sigmoid) and the
    class head ``head_cls_a`` (3x3 to ``depth``, LeakyReLU) →
    ``head_cls_bn`` → ``head_cls_b`` (1x1 to ``nclasses``) → softmax over
    the classes. ``decode`` returns ``{"image", "soft_probs"}``, both
    float32. ``train`` and ``update_stats`` go to every BatchNorm, the
    class head's included."""

    def __init__(self, config: AEConfig):
        super().__init__()
        cfg = self.config = config
        self.enc = HalfStemEncoder(cfg)
        self.trunk = TrunkDecoder(cfg)
        self.head_image = Conv(cfg.depth, 1, 3)
        self.head_cls_a = Conv(cfg.depth, cfg.depth, 3)
        self.head_cls_bn = BatchNorm(cfg.depth)
        self.head_cls_b = Conv(cfg.depth, cfg.nclasses, 1)

    def encode(self, x: torch.Tensor, train: bool = False,
               update_stats: bool = True) -> torch.Tensor:
        return self.enc(x, train, update_stats)

    def decode(self, z: torch.Tensor, train: bool = False,
               update_stats: bool = True) -> Dict[str, torch.Tensor]:
        h = self.trunk(z, train, update_stats)
        img = torch.sigmoid(self.head_image(h)).float()
        c = _leaky(self.head_cls_a(h))
        c = self.head_cls_b(self.head_cls_bn(c, train, update_stats))
        return {"image": img, "soft_probs": torch.softmax(c, dim=1).float()}

    def forward(self, x: torch.Tensor,
                train: bool = False) -> Dict[str, torch.Tensor]:
        return self.decode(self.encode(x, train), train)

    def reset_parameters(self, generator: torch.Generator) -> None:
        reset_parameters(self, generator)
