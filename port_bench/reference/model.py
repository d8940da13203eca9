"""VanillaACAI, the ``ae_combined`` autoencoder, as plain functions of a
parameter dict.

From the architecture's description (the reference repository's
``networks/acai_vanilla.py``): a 1x1 stem conv to ``depth`` channels;
per scale (``scales = log2(width / latent_width)``) two 3x3 convs to
``depth << scale`` channels, each followed by LeakyReLU(0.01), then
BatchNorm and a 2x2 average pool; a 3x3 conv to ``depth << scales``
channels with LeakyReLU and a 3x3 head to ``latent`` channels. The
decoder mirrors it: per scale two 3x3 convs with LeakyReLU, BatchNorm
and a nearest 2x upsample; a 3x3 conv to ``depth`` channels with
LeakyReLU, a 3x3 conv to the image's channels and a sigmoid. Convs pad
SAME; BatchNorm normalises with the batch's biased statistics in
training (moving the running statistics by 0.1 where asked) and with the
running statistics otherwise, eps 1e-5.

Parameters are named as the port's ``state_dict`` names them, so one
dict of seeded tensors loads into both (``param_shapes``).
"""
from __future__ import annotations

import dataclasses
import math
from collections import OrderedDict
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from .precision import operands

LEAKY = 0.01
BN_EPS = 1e-5
BN_MOMENTUM = 0.9


@dataclasses.dataclass(frozen=True)
class Arch:
    width: int
    latent_width: int
    depth: int
    latent: int
    colors: int = 1
    use_batchnorm: bool = True
    use_sigmoid: bool = True

    @property
    def scales(self) -> int:
        return int(round(math.log2(self.width / self.latent_width)))

    @classmethod
    def from_config(cls, cfg: Dict) -> "Arch":
        return cls(**{f.name: cfg[f.name] for f in dataclasses.fields(cls)
                      if f.name in cfg})


def _convs(arch: Arch):
    """(name, cin, cout, kernel) of every conv, encoder then decoder."""
    d, s = arch.depth, arch.scales
    out = [("enc.stem", arch.colors, d, 1)]
    cin, i = d, 0
    for scale in range(s):
        k = d << scale
        out += [(f"enc.convs.{i}", cin, k, 3), (f"enc.convs.{i + 1}", k, k, 3)]
        cin, i = k, i + 2
    out += [(f"enc.convs.{i}", cin, d << s, 3),
            ("enc.head", d << s, arch.latent, 3)]
    cin, i = arch.latent, 0
    for scale in range(s - 1, -1, -1):
        k = d << scale
        out += [(f"dec.convs.{i}", cin, k, 3), (f"dec.convs.{i + 1}", k, k, 3)]
        cin, i = k, i + 2
    out += [(f"dec.convs.{i}", cin, d, 3), ("dec.out", d, arch.colors, 3)]
    return out


def _bns(arch: Arch):
    """(name, channels) of every BatchNorm, encoder then decoder."""
    if not arch.use_batchnorm:
        return []
    d, s = arch.depth, arch.scales
    return ([(f"enc.bns.{i}", d << i) for i in range(s)]
            + [(f"dec.bns.{i}", d << (s - 1 - i)) for i in range(s)])


def param_shapes(arch: Arch) -> "OrderedDict[str, tuple]":
    """name → (shape, role) of every tensor of the model's state: roles
    ``conv_w`` (fan-in in the shape), ``bias``, ``bn_w``, ``bn_b``,
    ``bn_mean``, ``bn_var``. Running statistics are buffers; the rest are
    trained parameters."""
    out: "OrderedDict[str, tuple]" = OrderedDict()
    for name, cin, cout, k in _convs(arch):
        out[name + ".weight"] = ((cout, cin, k, k), "conv_w")
        out[name + ".bias"] = ((cout,), "bias")
    for name, c in _bns(arch):
        out[name + ".weight"] = ((c,), "bn_w")
        out[name + ".bias"] = ((c,), "bn_b")
        out[name + ".running_mean"] = ((c,), "bn_mean")
        out[name + ".running_var"] = ((c,), "bn_var")
    return out


def is_buffer(name: str) -> bool:
    return name.endswith(".running_mean") or name.endswith(".running_var")


class Net:
    """The autoencoder over ``state`` (name → tensor, ``param_shapes``'
    names) in precision ``mode``. ``encode`` / ``decode`` take NCHW
    float32; ``train`` normalises with batch statistics, and
    ``update_stats`` writes the moved running statistics into ``state``
    (as new tensors, out of autograd)."""

    def __init__(self, arch: Arch, state: Dict[str, torch.Tensor],
                 mode: str = "float32"):
        self.arch, self.state, self.mode = arch, state, mode

    def _conv(self, name: str, x: torch.Tensor) -> torch.Tensor:
        w, b = self.state[name + ".weight"], self.state[name + ".bias"]
        x, w, b = operands(self.mode, x.device, x, w, b)
        return F.conv2d(x, w, b, padding=w.shape[-1] // 2)

    def _bn(self, name: str, x: torch.Tensor, train: bool,
            update_stats: bool) -> torch.Tensor:
        st = self.state
        if train:
            mean = x.mean(dim=(0, 2, 3))
            var = ((x - mean.view(1, -1, 1, 1)) ** 2).mean(dim=(0, 2, 3))
            if update_stats:
                for key, stat in (("running_mean", mean), ("running_var", var)):
                    full = f"{name}.{key}"
                    st[full] = (BN_MOMENTUM * st[full]
                                + (1.0 - BN_MOMENTUM) * stat.detach())
        else:
            mean, var = st[name + ".running_mean"], st[name + ".running_var"]
        scale = torch.rsqrt(var + BN_EPS) * st[name + ".weight"]
        return ((x - mean.view(1, -1, 1, 1)) * scale.view(1, -1, 1, 1)
                + st[name + ".bias"].view(1, -1, 1, 1))

    def encode(self, x: torch.Tensor, train: bool = False,
               update_stats: bool = False) -> torch.Tensor:
        a = self.arch
        x = self._conv("enc.stem", x)
        for scale in range(a.scales):
            x = F.leaky_relu(self._conv(f"enc.convs.{2 * scale}", x), LEAKY)
            x = F.leaky_relu(self._conv(f"enc.convs.{2 * scale + 1}", x), LEAKY)
            if a.use_batchnorm:
                x = self._bn(f"enc.bns.{scale}", x, train, update_stats)
            x = F.avg_pool2d(x, 2)
        x = F.leaky_relu(self._conv(f"enc.convs.{2 * a.scales}", x), LEAKY)
        return self._conv("enc.head", x)

    def decode(self, z: torch.Tensor, train: bool = False,
               update_stats: bool = False) -> torch.Tensor:
        a = self.arch
        x = z
        for i in range(a.scales):
            x = F.leaky_relu(self._conv(f"dec.convs.{2 * i}", x), LEAKY)
            x = F.leaky_relu(self._conv(f"dec.convs.{2 * i + 1}", x), LEAKY)
            if a.use_batchnorm:
                x = self._bn(f"dec.bns.{i}", x, train, update_stats)
            x = F.interpolate(x, scale_factor=2, mode="nearest")
        x = F.leaky_relu(self._conv(f"dec.convs.{2 * a.scales}", x), LEAKY)
        x = self._conv("dec.out", x)
        return torch.sigmoid(x) if a.use_sigmoid else x


def trained_names(arch: Arch):
    """The names of the trained parameters (no running statistics)."""
    return [k for k in param_shapes(arch) if not is_buffer(k)]


def clone_state(state: Dict[str, torch.Tensor],
                device: Optional[torch.device] = None) -> Dict[str, torch.Tensor]:
    return {k: v.detach().to(device or v.device, copy=True)
            for k, v in state.items()}
