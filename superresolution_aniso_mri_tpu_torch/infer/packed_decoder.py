"""Space-to-depth packed decoder for inference, NCHW.

Port of ``superresolution_aniso_mri_tpu/infer/packed_decoder.py``.
Every upsample of the standard ``Decoder`` is a nearest 2x, so the
pattern ``u --nearest 2x--> x --3x3 conv (W), zero pad--> y`` equals
one 3x3 conv on ``u`` whose ``4 * cout`` output channels are the 2x2
phases of ``y``:

    y(2p+a, 2q+b) = sum_{di,dj} W[di,dj] * u(floor((2p+a+di)/2),
                                             floor((2q+b+dj)/2))

Per phase a the three taps di = -1, 0, 1 collapse onto the u offsets
{-1, 0} (a = 0) or {0, +1} (a = 1). Same operations at a quarter of the
pixels and four times the output channels; ``depth_to_space2`` puts the
phases back in place before the next conv.

The packed channels keep JAX's phase-major order: channel
``(a * 2 + b) * cout + c`` holds phase (a, b) of output channel c (JAX's
NHWC ``(a, b, c)`` reshape, read on the channel axis of NCHW). That is
not ``pixel_shuffle``'s ``(c, a, b)`` order, so ``depth_to_space2`` is
its own reshape.

The tap sums are formed in float32 and cast to the compute dtype, as in
JAX, so the packed conv rounds differently from the plain one (a sum of
taps against a sum of products); BatchNorm runs as the plain decoder's
module (float32 against its running statistics).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..models.acai import Decoder, _leaky
from ..models.vae import VAE2


def pack_after_upsample_kernel(w: torch.Tensor) -> torch.Tensor:
    """[cout, cin, 3, 3] OIHW → [4 * cout, cin, 3, 3] whose output
    channels are phase-major ``(a, b, cout)`` blocks."""
    cout, cin = w.shape[0], w.shape[1]
    p = w.new_zeros((2, 2, cout, cin, 3, 3))
    for a in (0, 1):
        for di in (-1, 0, 1):
            ti = (a + di) // 2 + 1
            for b in (0, 1):
                for dj in (-1, 0, 1):
                    tj = (b + dj) // 2 + 1
                    p[a, b, :, :, ti, tj] += w[:, :, di + 1, dj + 1]
    return p.reshape(4 * cout, cin, 3, 3)


def depth_to_space2(x: torch.Tensor) -> torch.Tensor:
    """[N, 4c, H, W] (phase-major ``(a, b, c)`` channels) →
    [N, c, 2H, 2W]."""
    n, c4, h, w = x.shape
    c = c4 // 4
    x = x.reshape(n, 2, 2, c, h, w).permute(0, 3, 4, 1, 5, 2)
    return x.reshape(n, c, 2 * h, 2 * w)


def _packed_conv(x: torch.Tensor, conv) -> torch.Tensor:
    """The conv after a nearest 2x upsample of ``x``, at ``x``'s size:
    packed kernel and tiled bias in ``x``'s dtype, then depth to space."""
    kernel = pack_after_upsample_kernel(conv.weight.float()).to(x.dtype)
    bias = conv.bias.to(x.dtype).repeat(4)
    return depth_to_space2(_leaky(F.conv2d(x, kernel, bias, padding=1)))


def packable(model) -> bool:
    """True when ``model`` decodes through the standard ``Decoder`` with
    nearest upsampling and no residual blocks (VanillaACAI, VAE,
    VanillaACAIStrided): ``model.decode(z)`` is ``model.dec(z)``."""
    dec = getattr(model, "dec", None)
    return (type(dec) is Decoder and dec.use_upsample and not len(dec.res)
            and not isinstance(model, VAE2))


def make_packed_decoder(model):
    """``decode(z)``: the eval-mode decode of ``model`` (``packable``)
    with every upsample folded into the following conv."""
    if not packable(model):
        raise ValueError(f"{type(model).__name__}: no packed decoder (needs "
                         f"the standard nearest-upsampling Decoder)")
    dec = model.dec
    cfg = dec.config

    def decode(z: torch.Tensor) -> torch.Tensor:
        x = z.to(cfg.dtype)
        for i in range(cfg.scales):
            if i == 0:
                x = _leaky(dec.convs[0](x))
            else:
                # the conv after the previous scale's upsample, packed
                x = _packed_conv(x, dec.convs[2 * i])
            x = _leaky(dec.convs[2 * i + 1](x))
            if cfg.use_batchnorm:
                x = dec.bns[i](x)
        x = dec.out(_packed_conv(x, dec.convs[-1]))
        if cfg.use_sigmoid:
            x = torch.sigmoid(x)
        return x.float()

    return decode
