"""Alpha probes: small heads that predict the mixing coefficients of two
latents, NCHW.

Port of ``superresolution_aniso_mri_tpu/models/alpha.py``
(``_CompressZ``, ``_MLPProbe``, ``make_alpha_probe``, ``SELayer``,
``AlphaDecoder``). A probe takes the channel concatenation of two
latents ``[B, 2 * latent, lw, lw]`` and a ``[B, F]`` row of scalar
features (slice ids, frame id, spacing, slice count) and returns
``[B, num_out]`` coefficients: 2, ``2 * latent``, ``latent`` or
``lw ** 2`` of them.

The compression flattens its map in flax's NHWC order (``(h * lw + w) *
C + c``), so the first ``Dense`` is the flax kernel transposed and
nothing else. Parameter layout (``models/convert.py``): flax's
``_CompressZ_0/{Conv_0, BatchNorm_0}`` is ``compress.{convs.0, bns.0}``,
``Dense_i`` is ``dense.i`` (weight ``[out, in]``), ``AlphaDecoder``'s
``Decoder_0`` is ``decoder``. Initialisation is flax's defaults
(``lecun_normal`` kernels, zero biases) through
``models.reset_parameters``; the decoder keeps the ACAI draw.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .acai import BatchNorm, Conv, Decoder, Dense, _leaky
from .config import AEConfig

# the probes' scalar features (data/pairs.py ``alpha_features``)
ALPHA_FEATURES = 5


class _CompressZ(nn.Module):
    """1x1 conv of the concatenated latents, LeakyReLU, then (with
    ``use_batchnorm``) BatchNorm, flattened in NHWC order."""

    def __init__(self, cin: int, out_channels: int = 1,
                 use_batchnorm: bool = False):
        super().__init__()
        self.convs = nn.ModuleList([Conv(cin, out_channels, 1,
                                         kernel_init="lecun")])
        self.bns = nn.ModuleList(
            [BatchNorm(out_channels)] if use_batchnorm else [])

    def forward(self, z: torch.Tensor, train: bool = False,
                update_stats: bool = True) -> torch.Tensor:
        x = _leaky(self.convs[0](z))
        if len(self.bns):
            x = self.bns[0](x, train, update_stats)
        return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)


class _MLPProbe(nn.Module):
    """compress → concatenate the features → ``Dense`` stack (ReLU after
    each hidden one unless ``hidden_act`` is False) → a bias-free
    ``Dense`` to ``num_out``."""

    def __init__(self, z_channels: int, lw: int, features: int,
                 hidden: Sequence[int], num_out: int,
                 compress_channels: int = 1, use_batchnorm: bool = False,
                 hidden_act: bool = True, hidden_bias: bool = True):
        super().__init__()
        self.hidden_act = hidden_act
        self.compress = _CompressZ(z_channels, compress_channels,
                                   use_batchnorm)
        widths = [compress_channels * lw * lw + features] + list(hidden)
        dense = [Dense(a, b, bias=hidden_bias)
                 for a, b in zip(widths[:-1], widths[1:])]
        dense.append(Dense(widths[-1], num_out, bias=False))
        self.dense = nn.ModuleList(dense)

    def forward(self, z: torch.Tensor, add_features: torch.Tensor,
                train: bool = False, update_stats: bool = True
                ) -> torch.Tensor:
        x = torch.cat([self.compress(z, train, update_stats),
                       add_features.to(torch.float32)], dim=1)
        for layer in self.dense[:-1]:
            x = layer(x)
            if self.hidden_act:
                x = F.relu(x)
        return self.dense[-1](x)


def make_alpha_probe(name: str, config: AEConfig, additional_dims: int = 0,
                     use_batchnorm: bool = False) -> _MLPProbe:
    """The probe class ``name`` for latents of ``config`` and
    ``additional_dims`` scalar features. Outputs: AlphaProbe /
    AlphaProbev2 2; AlphaProbe16v1 / v2 / ExBN ``2 * latent``;
    AlphaProbe16Convex ``latent``; AlphaProbe256v1 ``latent_width ** 2``."""
    latent, lw = config.latent, config.latent_width

    def probe(hidden, num_out, **kw):
        return _MLPProbe(2 * latent, lw, additional_dims, hidden, num_out,
                         use_batchnorm=use_batchnorm, **kw)

    if name == "AlphaProbe":
        return probe((), 2)
    if name == "AlphaProbev2":
        return probe((512,), 2)
    if name == "AlphaProbe16v1":
        return probe((512,), 2 * latent)
    if name == "AlphaProbe16v2":
        return probe((512, 1024), 2 * latent)
    if name == "AlphaProbe16Convex":
        return probe((512, 1024), latent)
    if name == "AlphaProbe16ExBN":
        # no activation between the two Dense layers
        return probe((512,), 2 * latent, hidden_act=False)
    if name == "AlphaProbe256v1":
        # every Dense bias-free
        flat = lw * lw * (lw // 2) + additional_dims
        return probe((flat // 32, flat), lw * lw, compress_channels=lw // 2,
                     hidden_bias=False)
    raise ValueError(f"unknown alpha probe class: {name}")


class SELayer(nn.Module):
    """Squeeze-excitation: the per-channel spatial mean through two
    bias-free ``Dense`` layers (ReLU, sigmoid) scales the channels."""

    def __init__(self, channels: int, reduction: int = 16):
        super().__init__()
        self.dense = nn.ModuleList([
            Dense(channels, channels // reduction, bias=False),
            Dense(channels // reduction, channels, bias=False)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.dense[0](x.mean(dim=(2, 3))))
        y = torch.sigmoid(self.dense[1](y))
        return x * y[:, :, None, None]


class AlphaDecoder(nn.Module):
    """The separate mix decoder of ``alpha_combined``: a ``Decoder``."""

    def __init__(self, config: AEConfig):
        super().__init__()
        self.config = config
        self.decoder = Decoder(config)

    def forward(self, z: torch.Tensor, train: bool = False,
                update_stats: bool = True) -> torch.Tensor:
        return self.decoder(z, train, update_stats)
