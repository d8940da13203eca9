"""The legacy block autoencoders and critics, NCHW: library API, which no
entry point trains or serves (nor does the JAX package's).

Port of ``superresolution_aniso_mri_tpu/models/legacy.py``
(``BasicEncoderBlock``, ``BasicDecoderBlock``, ``bilinear_upsample2x``,
``BlockEncoder``, ``BlockDecoder``, ``LegacyAE``, ``LegacyAEAdv``,
``DiscriminatorSpatial``, ``DiscriminatorFakeReal``). The port's modules
take the input channels (and the spatial critic its input width) that
flax infers at its first call.

Parameter layout (``models/convert.py``): flax's ``BasicEncoderBlock_i``
/ ``BasicDecoderBlock_i`` are ``enc_blocks.i`` / ``dec_blocks.i``, a
module's own ``Conv_i`` ``convs.i``, ``Dense_0`` ``dense.0``; LegacyAEAdv's
``to_latent``, ``to_latent_bn``, ``from_latent`` and ``from_latent_bn``
keep their names. Initialisation (``models.reset_parameters``): flax's
``kaiming_normal`` for the block convs and the fake/real critic,
``lecun_normal`` (flax's default) for LegacyAEAdv's 1x1 projections and
the spatial critic's head, zero biases.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .acai import BatchNorm, Conv, Dense, _leaky


def _lconv(cin: int, cout: int, kernel: int) -> Conv:
    return Conv(cin, cout, kernel, kernel_init="kaiming")


class BasicEncoderBlock(nn.Module):
    """3x3 conv → LeakyReLU twice (+ BatchNorm, + whole-channel dropout
    in train mode), then a 2x2 average pool when ``downsample``."""

    def __init__(self, cin: int, channels_out: int, downsample: bool = True,
                 use_batchnorm: bool = False, dropout: float = 0.0):
        super().__init__()
        self.convs = nn.ModuleList([_lconv(cin, cin, 3),
                                    _lconv(cin, channels_out, 3)])
        self.bns = nn.ModuleList(
            [BatchNorm(channels_out)] if use_batchnorm else [])
        self.downsample = downsample
        self.dropout = float(dropout)

    def forward(self, x: torch.Tensor, train: bool = False,
                update_stats: bool = True) -> torch.Tensor:
        x = _leaky(self.convs[0](x))
        x = _leaky(self.convs[1](x))
        if len(self.bns):
            x = self.bns[0](x, train, update_stats)
        if self.dropout:
            x = F.dropout2d(x, self.dropout, training=train)
        if self.downsample:
            x = F.avg_pool2d(x, 2)
        return x


def _up2_bilinear_axis(x: torch.Tensor, dim: int) -> torch.Tensor:
    """2x bilinear upsample along ``dim``: ``out[2i] = 0.75 x[i] + 0.25
    x[i-1]``, ``out[2i+1] = 0.75 x[i] + 0.25 x[i+1]``, the edges
    clamped (JAX's formula, term for term)."""
    n = x.shape[dim]
    xm = torch.cat([x.narrow(dim, 0, 1), x.narrow(dim, 0, n - 1)], dim)
    xp = torch.cat([x.narrow(dim, 1, n - 1), x.narrow(dim, n - 1, 1)], dim)
    even = 0.75 * x + 0.25 * xm
    odd = 0.75 * x + 0.25 * xp
    shape = list(x.shape)
    shape[dim] = 2 * n
    return torch.stack([even, odd], dim=dim + 1).reshape(shape)


def bilinear_upsample2x(x: torch.Tensor) -> torch.Tensor:
    """NCHW 2x bilinear upsampling: H, then W."""
    return _up2_bilinear_axis(_up2_bilinear_axis(x, 2), 3)


class BasicDecoderBlock(nn.Module):
    """3x3 conv → LeakyReLU twice, then a 2x bilinear upsample when
    ``do_upsample``."""

    def __init__(self, cin: int, channels_out: int, do_upsample: bool = True):
        super().__init__()
        self.convs = nn.ModuleList([_lconv(cin, cin, 3),
                                    _lconv(cin, channels_out, 3)])
        self.do_upsample = do_upsample

    def forward(self, x: torch.Tensor, train: bool = False,
                update_stats: bool = True) -> torch.Tensor:
        x = _leaky(self.convs[0](x))
        x = _leaky(self.convs[1](x))
        return bilinear_upsample2x(x) if self.do_upsample else x


class BlockEncoder(nn.Module):
    """A ``BasicEncoderBlock`` per (channels, downsample) pair, then two
    3x3 conv → LeakyReLU, the second to ``latent_dim``."""

    def __init__(self, cin: int, channel_list: Sequence[int],
                 downsample_list: Sequence[bool], latent_dim: int):
        super().__init__()
        blocks = []
        for cout, down in zip(channel_list, downsample_list):
            blocks.append(BasicEncoderBlock(cin, cout, downsample=down))
            cin = cout
        self.enc_blocks = nn.ModuleList(blocks)
        self.convs = nn.ModuleList([_lconv(cin, cin, 3),
                                    _lconv(cin, latent_dim, 3)])

    def forward(self, x: torch.Tensor, train: bool = False,
                update_stats: bool = True) -> torch.Tensor:
        for blk in self.enc_blocks:
            x = blk(x, train, update_stats)
        x = _leaky(self.convs[0](x))
        return _leaky(self.convs[1](x))


class BlockDecoder(nn.Module):
    """The mirror: blocks to ``channel_list[::-1][1:] + [colors]`` with
    the upsample flags of ``downsample_list`` (not reversed), then a 3x3
    conv to ``colors`` (a sigmoid only with ``use_sigmoid``)."""

    def __init__(self, cin: int, channel_list: Sequence[int],
                 downsample_list: Sequence[bool], colors: int = 1,
                 use_sigmoid: bool = False):
        super().__init__()
        rev = list(channel_list)[::-1][1:] + [colors]
        blocks = []
        for cout, up in zip(rev, downsample_list):
            blocks.append(BasicDecoderBlock(cin, cout, do_upsample=up))
            cin = cout
        self.dec_blocks = nn.ModuleList(blocks)
        self.convs = nn.ModuleList([_lconv(cin, colors, 3)])
        self.use_sigmoid = use_sigmoid

    def forward(self, z: torch.Tensor, train: bool = False,
                update_stats: bool = True) -> torch.Tensor:
        x = z
        for blk in self.dec_blocks:
            x = blk(x, train, update_stats)
        x = self.convs[0](x)
        return torch.sigmoid(x) if self.use_sigmoid else x


class LegacyAE(nn.Module):
    """The plain block autoencoder."""

    def __init__(self, channel_list: Sequence[int] = (32, 64, 128),
                 downsample_list: Sequence[bool] = (True, True, True),
                 latent_dim: int = 64, colors: int = 1):
        super().__init__()
        self.enc = BlockEncoder(colors, channel_list, downsample_list,
                                latent_dim)
        self.dec = BlockDecoder(latent_dim, channel_list, downsample_list,
                                colors)

    def encode(self, x: torch.Tensor, train: bool = False,
               update_stats: bool = True) -> torch.Tensor:
        return self.enc(x, train, update_stats)

    def decode(self, z: torch.Tensor, train: bool = False,
               update_stats: bool = True) -> torch.Tensor:
        return self.dec(z, train, update_stats)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        return self.decode(self.encode(x, train), train)


class LegacyAEAdv(LegacyAE):
    """The block autoencoder with a 1x1 conv + BatchNorm + LeakyReLU
    projection to ``latent_dim_chan`` channels and back."""

    def __init__(self, channel_list: Sequence[int] = (32, 64, 128),
                 downsample_list: Sequence[bool] = (True, True, True),
                 latent_dim: int = 64, latent_dim_chan: int = 16,
                 colors: int = 1):
        super().__init__(channel_list, downsample_list, latent_dim, colors)
        self.dec = BlockDecoder(channel_list[-1], channel_list,
                                downsample_list, colors)
        self.to_latent = Conv(latent_dim, latent_dim_chan, 1,
                              kernel_init="lecun")
        self.to_latent_bn = BatchNorm(latent_dim_chan)
        self.from_latent = Conv(latent_dim_chan, channel_list[-1], 1,
                                kernel_init="lecun")
        self.from_latent_bn = BatchNorm(channel_list[-1])

    def encode(self, x: torch.Tensor, train: bool = False,
               update_stats: bool = True) -> torch.Tensor:
        h = self.to_latent(self.enc(x, train, update_stats))
        return _leaky(self.to_latent_bn(h, train, update_stats))

    def decode(self, z: torch.Tensor, train: bool = False,
               update_stats: bool = True) -> torch.Tensor:
        h = _leaky(self.from_latent_bn(self.from_latent(z), train,
                                       update_stats))
        return self.dec(h, train, update_stats)


class DiscriminatorSpatial(nn.Module):
    """The block-encoder stack, a 1x1 conv, the NHWC flatten and a
    ``Dense`` to one score per sample (no activation in the head).
    ``width``: the input's height and width, which fix the Dense."""

    def __init__(self, channel_list: Sequence[int] = (32, 64, 128),
                 downsample_list: Sequence[bool] = (True, True, True),
                 colors: int = 1, width: int = 32):
        super().__init__()
        blocks, cin = [], colors
        for cout, down in zip(channel_list, downsample_list):
            blocks.append(BasicEncoderBlock(cin, cout, downsample=down))
            cin = cout
            width = width // 2 if down else width
        self.enc_blocks = nn.ModuleList(blocks)
        self.convs = nn.ModuleList([Conv(cin, cin, 1, kernel_init="lecun")])
        self.dense = nn.ModuleList([Dense(cin * width * width, 1)])

    def forward(self, x: torch.Tensor, train: bool = False,
                update_stats: bool = True) -> torch.Tensor:
        for blk in self.enc_blocks:
            x = blk(x, train, update_stats)
        x = self.convs[0](x)
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        return self.dense[0](x)[:, 0]


class DiscriminatorFakeReal(nn.Module):
    """The image-space real/fake critic: four 4x4 stride-2 convs (ReLU)
    alternating ``channel // 2`` and ``channel``, a 3x3 conv,
    ``n_res_block`` residual blocks (ReLU → 3x3 → ReLU → 1x1, plus the
    skip), ReLU, a bias-free 1x1 conv to ``latent_dim_chan``, and the
    sigmoid of the mean of every feature. ``convs`` holds them in flax's
    order (``Conv_0`` … ``Conv_{5 + 2 n_res_block}``)."""

    def __init__(self, channel: int = 128, latent_dim_chan: int = 64,
                 n_res_block: int = 2, n_res_channel: int = 32,
                 colors: int = 1):
        super().__init__()
        ch = channel
        convs, cin = [], colors
        for cout in (ch // 2, ch, ch // 2, ch):
            convs.append(Conv(cin, cout, 4, stride=2, padding=1,
                              kernel_init="kaiming"))
            cin = cout
        convs.append(_lconv(ch, ch, 3))
        for _ in range(n_res_block):
            convs += [_lconv(ch, n_res_channel, 3),
                      _lconv(n_res_channel, ch, 1)]
        convs.append(Conv(ch, latent_dim_chan, 1, bias=False,
                          kernel_init="kaiming"))
        self.convs = nn.ModuleList(convs)
        self.n_res_block = n_res_block

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        x = x.float()
        for conv in self.convs[:4]:
            x = F.relu(conv(x))
        x = self.convs[4](x)
        for r in range(self.n_res_block):
            h = self.convs[5 + 2 * r](F.relu(x))
            x = x + self.convs[6 + 2 * r](F.relu(h))
        x = self.convs[-1](F.relu(x))
        return torch.sigmoid(x.reshape(x.shape[0], -1).mean(dim=1))
