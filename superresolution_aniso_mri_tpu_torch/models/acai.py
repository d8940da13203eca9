"""ACAI-style convolutional autoencoder, NCHW.

Port of ``superresolution_aniso_mri_tpu/models/acai.py`` (``Encoder``,
``Decoder``, ``VanillaACAI``, ``ResBlock``). ``train=False`` (serving)
normalises with the BatchNorm running statistics; ``train=True``
normalises with the batch's statistics and, unless ``update_stats`` is
False, advances the running statistics once, as flax's ``BatchNorm``
with ``mutable=["batch_stats"]`` does. The ACAI ``Discriminator``,
``lerp`` and ``swap_halves`` belong to the acai family (ROADMAP item 9).

Precision follows the reference's mixed-precision rule exactly, with
explicit casts rather than autocast: parameters are float32; each conv
casts its input, kernel and bias to ``config.dtype``; BatchNorm
normalises in float32 against its float32 statistics and casts the
result back to ``config.dtype``; the latent and the decoded image leave
as float32.

Parameter layout: a flax ``Conv_i`` lives at ``convs.i`` (OIHW),
``BatchNorm_i`` at ``bns.i``, ``ConvTranspose_i`` at ``ups.i`` (torch's
``(in, out, kh, kw)``, kernel flipped — see ``models/convert.py``) and
``ResBlock_i`` at ``res.i``.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from .config import AEConfig

LEAKY_SLOPE = 0.01  # nn.LeakyReLU() default, as in the original network
RES_CHANNELS = 128  # ResBlock hidden width (reference ResBlock default)


def _leaky(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, LEAKY_SLOPE)


class Conv(nn.Module):
    """Stride-1 conv with SAME padding for odd kernels > 1 and VALID for
    1x1; float32 parameters cast to the activation dtype per call."""

    def __init__(self, cin: int, cout: int, kernel: int):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(cout, cin, kernel, kernel))
        self.bias = nn.Parameter(torch.zeros(cout))
        self.padding = kernel // 2

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv2d(x, self.weight.to(x.dtype), self.bias.to(x.dtype),
                        padding=self.padding)


class ConvTranspose(nn.Module):
    """4x4 stride-2 transposed conv doubling H and W (the reference's
    ``use_upsample=False`` decoder block). Weight in torch layout
    ``(in, out, 4, 4)``; ``padding=1`` gives the flax block's output."""

    def __init__(self, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(channels, channels, 4, 4))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv_transpose2d(x, self.weight.to(x.dtype),
                                  self.bias.to(x.dtype), stride=2,
                                  padding=1)


class BatchNorm(nn.Module):
    """BatchNorm with flax's arithmetic: ``(x - mean) * (rsqrt(var + eps)
    * scale) + bias`` in float32, cast back to the input dtype.

    In train mode the statistics are flax's, not ``F.batch_norm``'s:
    reduced in float32 (also for bfloat16 activations), the fast
    variance ``max(0, E[x^2] - E[x]^2)`` (biased), gradients through
    both; the running statistics move as ``ra = 0.9 * ra + 0.1 * batch``
    with the biased variance."""

    momentum = 0.9

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))
        self.eps = eps

    def forward(self, x: torch.Tensor, train: bool = False,
                update_stats: bool = True) -> torch.Tensor:
        shape = (1, -1, 1, 1)
        xf = x.float()
        if train:
            mean = xf.mean(dim=(0, 2, 3))
            var = torch.clamp_min((xf * xf).mean(dim=(0, 2, 3))
                                  - mean * mean, 0.0)
            if update_stats:
                with torch.no_grad():
                    for ra, stat in ((self.running_mean, mean),
                                     (self.running_var, var)):
                        ra.mul_(self.momentum).add_(
                            stat.detach() * (1.0 - self.momentum))
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (xf - mean.view(shape)) * mul.view(shape) + self.bias.view(shape)
        return y.to(x.dtype)


class ResBlock(nn.Module):
    """relu → 3x3 conv (C→128) → relu → 1x1 conv (128→C), plus the skip."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv0 = Conv(channels, RES_CHANNELS, 3)
        self.conv1 = Conv(RES_CHANNELS, channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.conv1(F.relu(self.conv0(F.relu(x))))


class Encoder(nn.Module):
    """Per scale [3x3 conv, LeakyReLU] x2 (+BN) + 2x2 avg-pool; 3x3 head."""

    def __init__(self, config: AEConfig):
        super().__init__()
        cfg = self.config = config
        self.stem = Conv(cfg.colors, cfg.depth, 1)
        convs, bns = [], []
        cin = cfg.depth
        for scale in range(cfg.scales):
            k = cfg.depth << scale
            convs += [Conv(cin, k, 3), Conv(k, k, 3)]
            if cfg.use_batchnorm:
                bns.append(BatchNorm(k))
            cin = k
        self.res = nn.ModuleList(
            ResBlock(cin) for _ in range(cfg.n_res_block or 0))
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
        if len(self.res):
            for blk in self.res:
                x = blk(x)
            x = F.relu(x)
        x = _leaky(self.convs[-1](x))
        return self.head(x).float()


class Decoder(nn.Module):
    """Mirror of the encoder with nearest 2x upsampling (or, with
    ``use_upsample=False``, a 4x4 stride-2 transposed conv)."""

    def __init__(self, config: AEConfig, use_upsample: Optional[bool] = None):
        super().__init__()
        cfg = self.config = config
        self.use_upsample = (cfg.use_upsample if use_upsample is None
                             else use_upsample)
        self.res = nn.ModuleList(
            ResBlock(cfg.latent) for _ in range(cfg.n_res_block or 0))
        convs, bns, ups = [], [], []
        cin = cfg.latent
        for scale in range(cfg.scales - 1, -1, -1):
            k = cfg.depth << scale
            convs += [Conv(cin, k, 3), Conv(k, k, 3)]
            if cfg.use_batchnorm:
                bns.append(BatchNorm(k))
            if not self.use_upsample:
                ups.append(ConvTranspose(k))
            cin = k
        convs.append(Conv(cin, cfg.depth, 3))
        self.convs = nn.ModuleList(convs)
        self.bns = nn.ModuleList(bns)
        self.ups = nn.ModuleList(ups)
        self.out = Conv(cfg.depth, cfg.colors, 3)

    def forward(self, z: torch.Tensor, train: bool = False,
                update_stats: bool = True) -> torch.Tensor:
        cfg = self.config
        x = z.to(cfg.dtype)
        if len(self.res):
            for blk in self.res:
                x = blk(x)
            x = F.relu(x)
        for i in range(cfg.scales):
            x = _leaky(self.convs[2 * i](x))
            x = _leaky(self.convs[2 * i + 1](x))
            if cfg.use_batchnorm:
                x = self.bns[i](x, train, update_stats)
            if self.use_upsample:
                x = F.interpolate(x, scale_factor=2, mode="nearest")
            else:
                x = self.ups[i](x)
        x = _leaky(self.convs[-1](x))
        x = self.out(x)
        if cfg.use_sigmoid:
            x = torch.sigmoid(x)
        return x.float()


class VanillaACAI(nn.Module):
    """encode / decode / forward facade over ``Encoder`` and ``Decoder``.
    Inputs are NCHW float tensors; outputs float32. ``train`` and
    ``update_stats`` go to every BatchNorm (see ``BatchNorm``)."""

    def __init__(self, config: AEConfig):
        super().__init__()
        self.config = config
        self.enc = Encoder(config)
        self.dec = Decoder(config)

    def encode(self, x: torch.Tensor, train: bool = False,
               update_stats: bool = True) -> torch.Tensor:
        return self.enc(x, train, update_stats)

    def decode(self, z: torch.Tensor, train: bool = False,
               update_stats: bool = True) -> torch.Tensor:
        return self.dec(z, train, update_stats)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        return self.decode(self.encode(x, train), train)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """ACAI author initialisation, as the reference's
        ``acai_kernel_init``: every conv kernel ~ N(0, std) with
        ``std = 1/sqrt((1 + 0.2^2) * fan_in)``, fan_in = kh*kw*in;
        zero biases; identity BatchNorm. Draws on the CPU from
        ``generator`` in module order, so a seed gives the same weights
        on every machine."""
        for mod in self.modules():
            if isinstance(mod, (Conv, ConvTranspose)):
                w = mod.weight
                cin = w.shape[0] if isinstance(mod, ConvTranspose) else w.shape[1]
                fan_in = cin * w.shape[2] * w.shape[3]
                std = 1.0 / math.sqrt((1.0 + 0.2 ** 2) * fan_in)
                w.copy_(torch.randn(w.shape, generator=generator) * std)
                mod.bias.zero_()
            elif isinstance(mod, BatchNorm):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
                mod.running_mean.zero_()
                mod.running_var.fill_(1.0)
