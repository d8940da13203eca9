"""The half-stem encoder and the decoder trunk of the multi-channel
family, NCHW.

Port of ``superresolution_aniso_mri_tpu/models/multi_channel.py``
(``_HalfStemEncoder``, ``trunk_decoder_body``), which ``LargerAE``
(``models/variants.py``) is built from. ``MultiChannelAE`` comes with the
labeled path (ROADMAP item 9b).

Parameter names follow the flax modules' flat names: the encoder's
``stem``, ``Conv_i`` → ``convs.i``, ``BatchNorm_i`` → ``bns.i`` and
``head``; the trunk's ``Conv_0`` (the 1x1 latent expansion) and
``BatchNorm_0`` first, then one conv pair and BatchNorm per scale and
the last conv, in call order.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .acai import BatchNorm, Conv, _leaky
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
