"""β-VAE variants on the shared Encoder / Decoder, NCHW.

Port of ``superresolution_aniso_mri_tpu/models/vae.py`` (``VAE``,
``VAE2``). The mu / logvar heads are ``Dense`` layers on the flattened
conv latent; ``VAE`` keeps the full flattened size, ``VAE2`` compresses
to ``latent`` values and decodes through a dense expansion.

The flat latent is in flax's order, the flatten of the NHWC latent
(``(h * W + w) * C + c``): ``heads`` flattens the NCHW latent through a
permute to NHWC and ``unflatten`` permutes back, so the Dense weights
are the flax kernels transposed and nothing else, and a noise vector
``eps`` drawn for JAX's ``reparametrize`` means the same here.
``reparametrize`` takes that noise as an argument. The heads fix the
in-plane size: the encoder must see ``width`` × ``width`` images.
"""
from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from .acai import Decoder, Dense, Encoder, reset_parameters
from .config import AEConfig


def flatten_nhwc(z: torch.Tensor) -> torch.Tensor:
    """[N, C, H, W] → [N, H*W*C] in flax's (NHWC) order."""
    return z.permute(0, 2, 3, 1).reshape(z.shape[0], -1)


def unflatten_nhwc(z_flat: torch.Tensor, cfg: AEConfig) -> torch.Tensor:
    """The inverse of ``flatten_nhwc`` for the config's latent grid."""
    lw = cfg.latent_width
    return z_flat.reshape(-1, lw, lw, cfg.latent).permute(0, 3, 1, 2)


class _VAEBase(nn.Module):
    def __init__(self, config: AEConfig, head_out: int):
        super().__init__()
        self.config = config
        self.enc = Encoder(config)
        self.dec = Decoder(config)
        self.latent_flat = (config.latent * config.latent_width
                            * config.latent_width)
        self.encoder_mu = Dense(self.latent_flat, head_out)
        self.encoder_logvar = Dense(self.latent_flat, head_out)

    def encode(self, x: torch.Tensor, train: bool = False,
               update_stats: bool = True) -> torch.Tensor:
        return self.enc(x, train, update_stats)

    def heads(self, z_conv: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
        flat = flatten_nhwc(z_conv)
        return self.encoder_mu(flat), self.encoder_logvar(flat)

    def encode_mu(self, x: torch.Tensor, train: bool = False,
                  update_stats: bool = True) -> torch.Tensor:
        """encode → heads → mu → unflatten: the latent the VAE family
        serves and scores through (the mean, never a sample)."""
        mu, _ = self.heads(self.encode(x, train, update_stats))
        return self.unflatten(mu)

    @staticmethod
    def reparametrize(mu: torch.Tensor, logvar: torch.Tensor,
                      eps: torch.Tensor) -> torch.Tensor:
        """``mu + exp(logvar / 2) * eps`` with the caller's N(0, 1)
        noise."""
        return mu + torch.exp(0.5 * logvar) * eps

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        return self.decode(self.encode_mu(x, train), train)

    def reset_parameters(self, generator: torch.Generator) -> None:
        reset_parameters(self, generator)


class VAE(_VAEBase):
    """Full-width latent VAE: mu / logvar have the flattened latent's
    ``latent * latent_width**2`` values."""

    def __init__(self, config: AEConfig):
        lf = config.latent * config.latent_width * config.latent_width
        super().__init__(config, lf)

    def unflatten(self, z_flat: torch.Tensor) -> torch.Tensor:
        return unflatten_nhwc(z_flat, self.config)

    def decode(self, z: torch.Tensor, train: bool = False,
               update_stats: bool = True) -> torch.Tensor:
        if z.ndim == 2:
            z = self.unflatten(z)
        return self.dec(z, train, update_stats)


class VAE2(_VAEBase):
    """Compressed-latent VAE: mu / logvar have ``latent`` values and
    ``decoder_dense`` expands them back to the latent grid."""

    def __init__(self, config: AEConfig):
        super().__init__(config, config.latent)
        self.decoder_dense = Dense(config.latent, self.latent_flat)

    def unflatten(self, z_flat: torch.Tensor) -> torch.Tensor:
        return z_flat  # the dense decode head does the reshape

    def decode(self, z: torch.Tensor, train: bool = False,
               update_stats: bool = True) -> torch.Tensor:
        h = unflatten_nhwc(self.decoder_dense(z), self.config)
        return self.dec(h, train, update_stats)
