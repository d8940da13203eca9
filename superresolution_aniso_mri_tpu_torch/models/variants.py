"""The alternative ``ae_class`` models, NCHW: ``LargerAE`` and
``VanillaACAIStrided``.

Port of ``superresolution_aniso_mri_tpu/models/variants.py``. LargerAE
is the half-stem encoder with the decoder trunk plus an image head;
VanillaACAIStrided downsamples with a 2x2 stride-2 conv (ACAI
initialisation, like every other conv) in place of each avg-pool and
decodes with the standard ``Decoder``. Its strided convs sit in the
encoder's ``convs`` at their flax ``Conv_i`` index (after each scale's
conv pair), so the parameter names follow flax's call order.
"""
from __future__ import annotations

import torch
from torch import nn

from .acai import (BatchNorm, Conv, Decoder, _leaky, reset_parameters)
from .config import AEConfig
from .multi_channel import HalfStemEncoder, TrunkDecoder


class _AEFacade(nn.Module):
    """encode / decode / forward over ``enc`` and ``dec``."""

    def encode(self, x: torch.Tensor, train: bool = False,
               update_stats: bool = True) -> torch.Tensor:
        return self.enc(x, train, update_stats)

    def decode(self, z: torch.Tensor, train: bool = False,
               update_stats: bool = True) -> torch.Tensor:
        return self.dec(z, train, update_stats)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        return self.decode(self.encode(x, train), train)

    def reset_parameters(self, generator: torch.Generator) -> None:
        reset_parameters(self, generator)


class LargerDecoder(TrunkDecoder):
    """The decoder trunk and a 3x3 image head (+ sigmoid)."""

    def __init__(self, config: AEConfig):
        super().__init__(config)
        self.out = Conv(config.depth, config.colors, 3)

    def forward(self, z: torch.Tensor, train: bool = False,
                update_stats: bool = True) -> torch.Tensor:
        x = self.out(self.trunk(z, train, update_stats))
        if self.config.use_sigmoid:
            x = torch.sigmoid(x)
        return x.float()


class LargerAE(_AEFacade):
    def __init__(self, config: AEConfig):
        super().__init__()
        self.config = config
        self.enc = HalfStemEncoder(config)
        self.dec = LargerDecoder(config)


class StridedEncoder(nn.Module):
    """Per scale [3x3 conv, LeakyReLU] x2 (+BN) + a 2x2 stride-2 conv;
    3x3 conv, LeakyReLU; 3x3 head. No stem padding, no ResBlocks."""

    def __init__(self, config: AEConfig):
        super().__init__()
        cfg = self.config = config
        self.stem = Conv(cfg.colors, cfg.depth, 1)
        convs, bns = [], []
        cin = cfg.depth
        for scale in range(cfg.scales):
            k = cfg.depth << scale
            convs += [Conv(cin, k, 3), Conv(k, k, 3), Conv(k, k, 2, stride=2)]
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
        x = self.stem(x.to(cfg.dtype))
        for scale in range(cfg.scales):
            x = _leaky(self.convs[3 * scale](x))
            x = _leaky(self.convs[3 * scale + 1](x))
            if cfg.use_batchnorm:
                x = self.bns[scale](x, train, update_stats)
            x = self.convs[3 * scale + 2](x)
        x = _leaky(self.convs[-1](x))
        return self.head(x).float()


class VanillaACAIStrided(_AEFacade):
    def __init__(self, config: AEConfig):
        super().__init__()
        self.config = config
        self.enc = StridedEncoder(config)
        self.dec = Decoder(config)
