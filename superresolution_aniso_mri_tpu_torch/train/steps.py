"""Train and eval steps of every model family: ``ae``, ``ae_combined``,
``vae``, ``acai``, the labeled ``multichannel`` /
``multichannel_combined`` and the alpha probes' ``alpha`` /
``alpha_end_to_end`` / ``alpha_only`` / ``alpha_combined``.

Port of ``superresolution_aniso_mri_tpu/train/steps.py`` (``LossConfig``,
``_recon_loss``, ``_mix_image_loss``, ``_wmse``, ``_train_latent_mix``,
``_ae_losses``, ``_vae_losses``, ``_acai_losses``,
``_multichannel_losses``, ``alpha_mix``, ``_alpha_losses``,
``make_train_step``, ``make_eval_step``), NCHW.

Batch contract (``data/transforms.py::device_batch``):
  image          [2B, C, H, W]  from-slices ∥ to-slices
  slice_between  [B, C, H, W]
  alpha_from/alpha_to [B]
  is_inbetween   [B]            optional, weights the synthesis loss
  outer, outer2  [2B, C, H, W]  for train_latent_interp cubic / lanczos3
  loss_mask      [B, 1, H, W]   optional (``use_masks``)
  noise_eps      [2B, F]        vae family: the N(0, 1) reparametrisation
                                noise (F = the heads' width, flax order)
  noise_alpha    [B]            acai family: the critic's mixing
                                coefficients, U[0, 0.5)
  alpha_features [B, 5]         alpha families: the probe's slice-geometry
                                features (``data/pairs.py``); required

The multichannel families' images carry two planes, (image, label):
the reconstruction and synthesis losses read plane 0, and the Dice terms
take plane 1 truncated to int32 class ids. As in JAX they never read
``loss_mask`` (``--get_masks`` loads it); the alpha families' synthesis
loss is the masked one.

JAX draws the noise inside its step from a threefry key; here it is an
input, drawn by the trainer from its generator (``draw_noise``) or given
by the caller, so a CUDA graph replays it from a static buffer like the
rest of the batch.

BatchNorm: the main encode → decode advances the running statistics
once (MultiChannelAE's class-head BatchNorm included; and the critic's
pass over the regularised reconstruction, the critic's); the auxiliary
passes (outward-neighbour encodes, the decode
of the mix, the encodes of ``slice_between`` and of the synthesized
slice, the critic's pass over the decoded mix) normalise with their own
batch statistics and advance nothing.

The ACAI model is the ``{"ae", "disc"}`` ``ModuleDict``; its step takes
the gradient of ``loss_ae_full + loss_disc`` over both groups, which is
the reference's twin backward, and the Laplacian term is logged but
never enters it. The alpha families' model is the ``{"ae", "probe"[,
"decoder_mix"]}`` ``ModuleDict`` under one optimizer; their gradient
stops are JAX's (see ``_alpha_losses``), and a parameter that a loss
does not reach (``alpha_only``'s autoencoder) gets a zero gradient, as
in JAX.

Losses: MSE, or with ``lpips_params`` the VGG LPIPS (``perceptual``)
or the encoder-backbone distance (``perceptual_enc``) for the
reconstruction (``recon_loss``) and the synthesis loss
(``image_mix_loss_func``); ``use_ssim_loss`` adds 0.135·(1 − SSIM, win
11) to the MSE reconstruction loss through the plain, differentiable
``ops/metrics.py::ssim_volume`` (the JAX step uses its XLA SSIM there,
not the Pallas kernel). The LPIPS weights are frozen tensors passed to
the step builders, never among the model's parameters.

Metrics are device tensors (no host sync per step) under the JAX step's
keys; ``loss_ae_dist_extra`` is logged weighted by ``mix_weight``.
"""
from __future__ import annotations

import copy
import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from ..device import f32_exact
from ..ops.dice import dice_loss
from ..ops.lap_pyramid import lap_loss, lap_loss_per_sample
from ..ops.losses import (bce_sum_over_batch, kl_standard_normal, latent_mix,
                          latent_mix_cubic, latent_mix_lanczos3, mse)
from ..ops.lpips import lpips_distance
from ..ops.metrics import ssim_volume
from ..ops.perceptual import enc_lpips_distance
from ..parallel.distributed import average_gradients, global_mean, global_sum
from ..utils.profiling import span
from .state import TrainState, scalar_tensor

Batch = Dict[str, torch.Tensor]

FAMILY_OF_MODEL = {
    "ae": "ae", "aesr": "ae",
    "ae_combined": "ae_combined", "aesr_combined": "ae_combined",
    "vae": "vae", "vae_combined": "vae", "vae2": "vae",
    "acai": "acai", "acai_combined": "acai",
    "multichannel": "multichannel",
    "multichannel_combined": "multichannel_combined",
    "alpha": "alpha",
    "alpha_end_to_end": "alpha",
    "alpha_only": "alpha",
    "alpha_combined": "alpha",
}


@dataclasses.dataclass(frozen=True)
class LossConfig:
    """The JAX package's loss configuration (same names and defaults).
    ``num_alphas`` and ``alpha_scheme`` (``'pair'``, ``'convex'``,
    ``'halves'``, ``'spatial'``; empty: chosen from the count) describe
    the alpha probe's output, ``latent`` the latent's channels.
    ``lpips_dtype`` is the precision of the perceptual distance's
    backbone ('float32' or 'bfloat16')."""

    model: str = "ae_combined"
    recon_loss: str = "mse"
    use_laploss: bool = False
    use_ssim_loss: bool = False
    image_mix_loss_func: Optional[str] = None
    use_extra_latent_loss: bool = False
    use_masks: bool = False
    train_latent_interp: str = "linear"
    vae_beta: float = 0.0
    lamb: float = 1.0
    lamb_reg_acai: float = 0.5
    gamma_reg_acai: float = 0.2
    nclasses: int = 4
    dice_weight: float = 0.1
    num_alphas: int = 32
    alpha_scheme: str = ""
    latent: int = 16
    lpips_dtype: str = "float32"

    @property
    def family(self) -> str:
        return FAMILY_OF_MODEL[self.model]

    @property
    def combined(self) -> bool:
        return "combined" in self.model


def check_supported(cfg: LossConfig) -> None:
    """Raise ValueError for a configuration no step can train."""
    if cfg.train_latent_interp not in ("linear", "cubic", "lanczos3"):
        raise ValueError(f"unknown train_latent_interp "
                         f"{cfg.train_latent_interp!r}")


def _weighted(per_sample: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """``sum(l·w) / max(sum(w), 1)``, both sums over the global batch in
    a sharded train step."""
    return (global_sum((per_sample * weight).sum())
            / global_sum(weight.sum()).clamp_min(1.0))


def _recon_loss(cfg: LossConfig, lpips_params: Any, pred: torch.Tensor,
                target: torch.Tensor):
    """(loss_ae, loss_ae_dist, loss_laploss): the perceptual distance
    (with ``lpips_params``) or MSE (+ the SSIM term with
    ``use_ssim_loss``), plus, with ``use_laploss``, the Laplacian-pyramid
    term in either branch (the reference adds it after the dispatch)."""
    if cfg.recon_loss == "perceptual_enc" and lpips_params is not None:
        dist = global_mean(enc_lpips_distance(lpips_params, pred, target,
                                              compute_dtype=cfg.lpips_dtype))
    elif cfg.recon_loss == "perceptual" and lpips_params is not None:
        dist = global_mean(lpips_distance(lpips_params, pred, target,
                                          normalize=True,
                                          compute_dtype=cfg.lpips_dtype))
    else:
        dist = mse(pred, target)
        if cfg.use_ssim_loss:
            s = global_mean(ssim_volume(pred[:, 0], target[:, 0],
                                        data_range=1.0, win_size=11))
            dist = dist + 0.135 * (1.0 - s)
    lap = lap_loss(pred, target) if cfg.use_laploss else pred.new_zeros(())
    return dist + lap, dist, lap


def _mix_image_loss(cfg: LossConfig, lpips_params: Any,
                    reference: torch.Tensor, synthesized: torch.Tensor,
                    mask: Optional[torch.Tensor],
                    sample_weight: Optional[torch.Tensor] = None):
    """Synthesis loss: the perceptual distance (``perceptual`` or
    ``perceptual_enc`` with ``lpips_params``; no lap term, as in the
    reference) or MSE (+ lap). Per-sample ``sample_weight``
    (``is_inbetween``) keeps degenerate triplets out, of the lap term
    too; all-ones weights give the unweighted loss."""
    if (cfg.image_mix_loss_func in ("perceptual", "perceptual_enc")
            and lpips_params is not None):
        dist_fn = (enc_lpips_distance
                   if cfg.image_mix_loss_func == "perceptual_enc"
                   else lpips_distance)
        if cfg.use_masks and mask is not None:
            reference, synthesized = reference * mask, synthesized * mask
        d = dist_fn(lpips_params, reference, synthesized, normalize=True,
                    compute_dtype=cfg.lpips_dtype)
        if sample_weight is not None:
            return _weighted(d, sample_weight)
        return global_mean(d)
    m = mask if (cfg.use_masks and mask is not None) else None
    if sample_weight is None:
        loss = mse(reference, synthesized, m)
    else:
        d = (reference - synthesized) ** 2
        if m is not None:
            d = d * m
        loss = _weighted(d.mean(dim=tuple(range(1, d.ndim))), sample_weight)
    if cfg.use_laploss:
        if sample_weight is None:
            loss = loss + lap_loss(synthesized, reference)
        else:
            loss = loss + _weighted(
                lap_loss_per_sample(synthesized, reference), sample_weight)
    return loss


def _wmse(a: torch.Tensor, b: torch.Tensor,
          sample_weight: Optional[torch.Tensor]) -> torch.Tensor:
    """mse, per-sample weighted when ``sample_weight`` is given."""
    if sample_weight is None:
        return mse(a, b)
    return _weighted(((a - b) ** 2).mean(dim=tuple(range(1, a.ndim))),
                     sample_weight)


def _train_latent_mix(model, cfg: LossConfig, z: torch.Tensor,
                      batch: Batch, train: bool = True) -> torch.Tensor:
    """The latent mix: 2-tap lerp, 4-tap Catmull-Rom (``outer``) or 6-tap
    lanczos3 (``outer`` and ``outer2``, encoded as ONE batch, so their
    batch statistics are joint, as in JAX). The outward encodes advance
    no running statistics."""
    if cfg.train_latent_interp == "cubic":
        if "outer" not in batch:
            raise ValueError(
                "train_latent_interp='cubic' needs the batch to carry "
                "'outer' (TripletSampler(latent_taps=4) through "
                "prepare_batch_quintets)")
        z_outer = model.encode(batch["outer"], train, update_stats=False)
        return latent_mix_cubic(z, z_outer, batch["alpha_to"])
    if cfg.train_latent_interp == "lanczos3":
        if "outer" not in batch or "outer2" not in batch:
            raise ValueError(
                "train_latent_interp='lanczos3' needs the batch to carry "
                "'outer' and 'outer2' (TripletSampler(latent_taps=6) "
                "through prepare_batch_septets)")
        n2 = batch["outer"].shape[0]
        z_out = model.encode(torch.cat([batch["outer"], batch["outer2"]]),
                             train, update_stats=False)
        return latent_mix_lanczos3(z, z_out[:n2], z_out[n2:],
                                   batch["alpha_to"])
    return latent_mix(z, batch["alpha_from"], batch["alpha_to"])


def _synthesis_terms(encode, cfg: LossConfig, lpips_params: Any,
                     batch: Batch, mix_weight, s_mix, z_mix, z_ref,
                     metrics: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The combined families' synthesis loss (and, with
    ``use_extra_latent_loss``, the latent terms through ``encode``),
    weighted by ``mix_weight``; logs its metrics into ``metrics``."""
    sw = batch.get("is_inbetween")
    loss_mix = _mix_image_loss(cfg, lpips_params, batch["slice_between"],
                               s_mix, batch.get("loss_mask"),
                               sample_weight=sw)
    loss_extra = mix_weight * loss_mix
    if cfg.use_extra_latent_loss:
        z_syn = encode(s_mix)
        l_lat2 = _wmse(z_ref, z_syn, sw)
        loss_extra = loss_extra + 0.5 * (_wmse(z_ref, z_mix, sw) + l_lat2)
        metrics["loss_latent_2"] = l_lat2
    metrics["loss_ae_dist_extra"] = mix_weight * loss_mix
    return loss_extra


def _ae_losses(model, cfg: LossConfig, lpips_params: Any,
               batch: Batch,
               mix_weight) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(loss, metrics) of the ``ae`` / ``ae_combined`` families."""
    x = batch["image"]
    between = batch["slice_between"]
    z = model.encode(x, train=True)
    out = model.decode(z, train=True)
    loss_ae, loss_dist, loss_lap = _recon_loss(cfg, lpips_params, out, x)

    z_mix = _train_latent_mix(model, cfg, z, batch)
    s_mix = model.decode(z_mix, train=True, update_stats=False)
    z_ref = model.encode(between, train=True, update_stats=False)
    metrics = {"loss_ae_dist": loss_dist, "loss_laploss": loss_lap,
               "loss_latent_1": mse(z_mix, z_ref)}
    if cfg.family == "ae_combined":
        loss_extra = _synthesis_terms(
            lambda img: model.encode(img, train=True, update_stats=False),
            cfg, lpips_params, batch, mix_weight, s_mix, z_mix, z_ref,
            metrics)
        loss_ae = loss_ae + loss_extra
        metrics["loss_ae_extra"] = loss_extra
    metrics["loss_ae"] = loss_ae
    return loss_ae, {k: v.detach() for k, v in metrics.items()}


def _vae_losses(model, cfg: LossConfig, lpips_params: Any, batch: Batch,
                mix_weight) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(loss, metrics) of ``vae`` / ``vae_combined`` / ``vae2``: BCE +
    β·KL through a sample of ``batch["noise_eps"]``; the mix and the
    reference latents go through the mean."""
    x = batch["image"]
    mu, logvar = model.heads(model.encode(x, train=True))
    z = model.unflatten(model.reparametrize(mu, logvar, batch["noise_eps"]))
    out = model.decode(z, train=True)
    recon = bce_sum_over_batch(out, x)
    kl = kl_standard_normal(mu, logvar)
    loss_ae = cfg.lamb * recon + cfg.vae_beta * kl
    z_mix = latent_mix(z, batch["alpha_from"], batch["alpha_to"])
    s_mix = model.decode(z_mix, train=True, update_stats=False)

    def enc_mu(img):
        return model.encode_mu(img, train=True, update_stats=False)

    z_ref = enc_mu(batch["slice_between"])
    metrics = {"loss_ae_dist": recon, "kl_loss": cfg.vae_beta * kl,
               "loss_latent_1": mse(z_mix, z_ref)}
    if cfg.combined:
        loss_ae = loss_ae + _synthesis_terms(enc_mu, cfg, lpips_params, batch,
                                             mix_weight, s_mix, z_mix, z_ref,
                                             metrics)
    metrics["loss_ae"] = loss_ae
    return loss_ae, {k: v.detach() for k, v in metrics.items()}


def _acai_losses(models, cfg: LossConfig, lpips_params: Any, batch: Batch,
                 mix_weight) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(loss, metrics) of ``acai`` / ``acai_combined``: the critic
    regresses ``batch["noise_alpha"]`` from decoded latent mixes and
    sees the gamma-regularised reconstruction; the loss is
    ``loss_ae_full + loss_disc`` over both groups."""
    ae, disc = models["ae"], models["disc"]
    x = batch["image"]
    z = ae.encode(x, train=True)
    out = ae.decode(z, train=True)
    _, loss_dist, loss_lap = _recon_loss(cfg, lpips_params, out, x)
    d_reg = disc(out + cfg.gamma_reg_acai * (x - out), train=True)
    loss_disc_l2 = global_mean(d_reg ** 2)
    alpha = batch["noise_alpha"]
    out_mix = ae.decode(latent_mix(z, alpha, 1.0 - alpha), train=True,
                        update_stats=False)
    d_mix = disc(out_mix, train=True, update_stats=False)
    loss_ae_l2 = global_mean(d_mix ** 2)
    loss_disc_dist = global_mean((d_mix - alpha) ** 2)
    # the objective takes loss_ae_DIST only: the reference logs the
    # Laplacian term but trains on ['loss_ae_dist']
    loss_ae_full = loss_dist + cfg.lamb_reg_acai * loss_ae_l2
    loss_disc = loss_disc_dist + loss_disc_l2
    z_mix = latent_mix(z, batch["alpha_from"], batch["alpha_to"])
    s_mix = ae.decode(z_mix, train=True, update_stats=False)

    def enc(img):
        return ae.encode(img, train=True, update_stats=False)

    z_ref = enc(batch["slice_between"])
    metrics = {"loss_ae_dist": loss_dist, "loss_laploss": loss_lap,
               "loss_disc": loss_disc, "loss_latent_1": mse(z_mix, z_ref)}
    if cfg.combined:
        loss_ae_full = loss_ae_full + _synthesis_terms(
            enc, cfg, lpips_params, batch, mix_weight, s_mix, z_mix, z_ref,
            metrics)
    metrics["loss_ae"] = loss_ae_full
    return (loss_ae_full + loss_disc,
            {k: v.detach() for k, v in metrics.items()})


def _multichannel_losses(model, cfg: LossConfig, lpips_params: Any,
                         batch: Batch, mix_weight
                         ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(loss, metrics) of ``multichannel`` / ``multichannel_combined``
    (ACDCLBL): the reconstruction loss on the image plane plus
    ``dice_weight`` · Dice of the class head against the label plane;
    the combined family adds ``mix_weight`` · (the synthesis loss on the
    image plane + the Dice of the mix's class head against the between
    slice's labels). ``loss_ae`` is logged without the Dice term, which
    is logged as ``loss_label``."""
    x = batch["image"]                          # [2B, 2, H, W]
    between = batch["slice_between"]            # [B, 2, H, W]
    labels = x[:, 1].to(torch.int32)
    z = model.encode(x, train=True)
    out = model.decode(z, train=True)
    loss_ae, loss_dist, loss_lap = _recon_loss(cfg, lpips_params,
                                               out["image"], x[:, 0:1])
    loss_labels = cfg.dice_weight * dice_loss(out["soft_probs"], labels,
                                              cfg.nclasses)
    total = loss_ae + loss_labels
    z_mix = latent_mix(z, batch["alpha_from"], batch["alpha_to"])
    s_mix = model.decode(z_mix, train=True, update_stats=False)
    z_ref = model.encode(between, train=True, update_stats=False)
    metrics = {"loss_ae_dist": loss_dist, "loss_laploss": loss_lap,
               "loss_label": loss_labels,
               "loss_latent_1": mse(z_mix, z_ref)}
    if cfg.family == "multichannel_combined":
        loss_mix = _mix_image_loss(cfg, lpips_params, between[:, 0:1],
                                   s_mix["image"], None,
                                   sample_weight=batch.get("is_inbetween"))
        loss_mix_labels = dice_loss(s_mix["soft_probs"],
                                    between[:, 1].to(torch.int32),
                                    cfg.nclasses)
        total = total + mix_weight * (loss_mix + loss_mix_labels)
        metrics["loss_ae_dist_extra"] = mix_weight * loss_mix
        metrics["loss_ae_dist_labels"] = mix_weight * loss_mix_labels
        metrics["loss_ae_extra"] = mix_weight * (loss_mix + loss_mix_labels)
    metrics["loss_ae"] = loss_ae
    return total, {k: v.detach() for k, v in metrics.items()}


def alpha_mix(alpha: torch.Tensor, z1: torch.Tensor, z3: torch.Tensor,
              num_alphas: int, latent: int, scheme: str = "") -> torch.Tensor:
    """The latent mix of the probe's coefficients ``alpha`` [B, n]:
    ``pair`` (n = 2, any latent rank) ``a0 * z1 + a1 * z3``; on conv
    latents [B, C, lw, lw] ``convex`` (n = C) ``a * z1 + (1 - a) * z3``
    per channel, ``halves`` (n = 2C) per channel with the first half on
    ``z1``, ``spatial`` (n = lw²) ``a * z1 + (1 - a) * z3`` per position
    (row-major, as JAX's NHWC ``[B, lw, lw, 1]``). An empty ``scheme``
    is chosen from ``num_alphas`` as JAX does."""
    b = z1.shape[0]
    if not scheme:
        scheme = ("pair" if num_alphas == 2 else
                  "convex" if num_alphas == latent else
                  "halves" if num_alphas == 2 * latent else "spatial")
    if scheme == "pair":
        shape = (b,) + (1,) * (z1.ndim - 1)
        return (alpha[:, 0].reshape(shape) * z1
                + alpha[:, 1].reshape(shape) * z3)
    if z1.ndim != 4:
        raise ValueError(
            f"alpha_mix scheme {scheme!r} needs conv latents "
            f"[B, c, lw, lw], got shape {tuple(z1.shape)} — only the "
            f"'pair' scheme supports dense latents")
    if scheme == "convex":
        a = alpha[:, :, None, None]
        return a * z1 + (1.0 - a) * z3
    if scheme == "halves":
        return (alpha[:, :latent, None, None] * z1
                + alpha[:, latent:, None, None] * z3)
    lw = z1.shape[2]
    a = alpha.reshape(b, 1, lw, lw)
    return a * z1 + (1.0 - a) * z3


def _alpha_features(batch: Batch) -> torch.Tensor:
    if "alpha_features" not in batch:
        raise KeyError(
            "alpha-family batches need 'alpha_features' [B, 5] "
            "(TripletSampler emits them; see data/pairs.py and "
            "data/transforms.py::device_batch)")
    return batch["alpha_features"]


def _alpha_losses(models, cfg: LossConfig, lpips_params: Any, batch: Batch,
                  mix_weight) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(loss, metrics) of the alpha families, with JAX's gradient stops:

    * ``alpha``: the probe's input is detached, the mix keeps the live
      latents; the decode of the mix and the encodes of
      ``slice_between`` and of the synthesized slice carry no gradient,
      so only ``loss_latent_1`` trains the probe (and, with the
      reconstruction, the encoder);
    * ``alpha_end_to_end``: nothing detached;
    * ``alpha_only``: the autoencoder runs in eval mode (running
      statistics, which never move) and carries no gradient; the loss is
      the probe's alone, its image term weighted 0.005;
    * ``alpha_combined``: as end to end, the mix decoded by
      ``decoder_mix`` in train mode.

    The image and latent terms weigh 0.5 each; ``mix_weight`` is unused.
    The synthesis loss is ``_mix_image_loss``, masked by ``loss_mask``
    with ``use_masks`` and weighted by ``is_inbetween``."""
    variant = cfg.model
    ae, probe = models["ae"], models["probe"]
    dec_mix = models["decoder_mix"] if "decoder_mix" in models else None
    x, between = batch["image"], batch["slice_between"]
    feats = _alpha_features(batch)
    b = x.shape[0] // 2
    ae_train = variant != "alpha_only"
    frozen = variant in ("alpha", "alpha_only")
    with torch.set_grad_enabled(ae_train):
        z = ae.encode(x, train=ae_train)
        out = ae.decode(z, train=ae_train)
    z1, z3 = z[:b], z[b:]
    z_cat = torch.cat([z1, z3], dim=1)
    alpha = probe(z_cat.detach() if frozen else z_cat, feats, train=True)
    z_mix = alpha_mix(alpha, z1, z3, cfg.num_alphas, cfg.latent,
                      cfg.alpha_scheme)
    with torch.set_grad_enabled(not frozen):
        if variant == "alpha_combined" and dec_mix is not None:
            s_mix = dec_mix(z_mix, train=True)
        else:
            s_mix = ae.decode(z_mix, train=ae_train, update_stats=False)
        z_ref = ae.encode(between, train=ae_train, update_stats=False)
        z_syn = ae.encode(s_mix, train=ae_train, update_stats=False)
    loss_img = _mix_image_loss(cfg, lpips_params, between, s_mix,
                               batch.get("loss_mask"),
                               sample_weight=batch.get("is_inbetween"))
    l_lat1 = mse(z_ref, z_mix)
    l_lat2 = mse(z_ref, z_syn)
    img_w = 0.005 if variant == "alpha_only" else 0.5
    loss_extra = img_w * loss_img + 0.5 * (l_lat1 + l_lat2)
    metrics = {"loss_latent_1": l_lat1, "loss_latent_2": l_lat2,
               "loss_ae_dist_extra": loss_img, "loss_ae_extra": loss_extra,
               "pred_alpha_mean": global_mean(alpha)}
    if variant == "alpha_only":
        total = loss_extra
        metrics["loss_ae_dist"] = mse(out, x)
    else:
        loss_ae, loss_dist, loss_lap = _recon_loss(cfg, lpips_params, out, x)
        total = loss_ae + loss_extra
        metrics["loss_ae_dist"] = loss_dist
        metrics["loss_laploss"] = loss_lap
    metrics["loss_ae"] = total
    return total, {k: v.detach() for k, v in metrics.items()}


def _update(state: TrainState, cfg: LossConfig, lpips_params: Any,
            batch: Batch, scalars: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Forward, backward and the optimizer update of one step, in place
    on ``state``'s tensors; ``scalars`` is the device tensor ``[c1, c2,
    lr, mix_weight]`` (``Optimizer.scalar_rows``), one row per parameter
    group for the ACAI family. Device work only, so a CUDA graph can
    capture it."""
    params = state.params()
    # looked up per call, so a family's loss can be swapped in tests
    losses = {"vae": _vae_losses, "acai": _acai_losses,
              "multichannel": _multichannel_losses,
              "multichannel_combined": _multichannel_losses,
              "alpha": _alpha_losses,
              }.get(cfg.family, _ae_losses)
    loss, metrics = losses(state.model, cfg, lpips_params, batch,
                           scalars.reshape(-1)[3])
    # a parameter the loss does not reach (alpha_only's autoencoder) has
    # a zero gradient, as in JAX
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(
        params.values(), torch.autograd.grad(loss, list(params.values()),
                                             allow_unused=True))]
    # a sharded step: the mean of the ranks' gradients of the global loss
    # (each reached its own rows through the reductions) is the global
    # gradient, before the clip and Adam of every parameter group
    grads = average_gradients(grads)
    state.tx.apply({k: p.data for k, p in params.items()},
                   dict(zip(params, grads)), state.opt_state, scalars)
    return metrics


def _scalar_rows(state: TrainState, mix_weight, n: int) -> List[List[float]]:
    """The ``scalars`` of the next ``n`` steps of ``state``, from its
    host counts, which stay as they are."""
    opt = copy.copy(state.opt_state)
    if isinstance(opt, dict):
        opt = {k: copy.copy(v) for k, v in opt.items()}
    rows = []
    for _ in range(n):
        rows.append(state.tx.scalar_rows(opt, float(mix_weight)))
        state.tx.advance(opt)
    return rows


def _advance(state: TrainState) -> None:
    state.tx.advance(state.opt_state)
    state.step += 1


def _device_of(state: TrainState) -> torch.device:
    return next(state.model.parameters()).device


def make_train_step(cfg: LossConfig, lpips_params: Any = None) -> Callable:
    """``step(state, batch, mix_weight) → (state, metrics)``: forward,
    backward and one optimizer update, in place on ``state`` (its model
    and optimizer state); float32 work with TF32 off. ``mix_weight`` is
    the synthesis-loss weight (a float, or a 0-d tensor that is read on
    the host).
    ``lpips_params``: the frozen weights of the perceptual losses
    (``ops.get_lpips_params`` or ``ops.get_enc_perceptual_params``);
    without them the perceptual losses fall back to MSE, as in JAX."""
    check_supported(cfg)

    def step(state: TrainState, batch: Batch, mix_weight):
        scalars = scalar_tensor(_scalar_rows(state, mix_weight, 1)[0],
                                _device_of(state))
        with f32_exact():
            metrics = _update(state, cfg, lpips_params, batch, scalars)
        _advance(state)
        return state, metrics

    return step


# eager steps of a new batch signature before its capture: they make the
# lazily built state (cuDNN plans, autograd's device threads, the step's
# constants) that a capture may not create
WARMUP_STEPS = 3


class _CapturedStep:
    """One train step of ``state`` captured in a CUDA graph, with its
    static inputs (``batch``, one buffer per key, and ``scalars``) and
    its static output (``metrics``, the step's metrics stacked in the
    order of ``keys``)."""

    def __init__(self, state: TrainState, cfg: LossConfig, lpips_params: Any,
                 like: Batch):
        self.state = state
        dev = _device_of(state)
        self.batch = {k: torch.empty_like(v) for k, v in like.items()}
        self.scalars = scalar_tensor(_scalar_rows(state, 0.0, 1)[0], dev)
        self.graph = torch.cuda.CUDAGraph()
        with f32_exact(), torch.cuda.graph(self.graph):
            metrics = _update(state, cfg, lpips_params, self.batch,
                              self.scalars)
            self.keys = list(metrics)
            self.metrics = torch.stack([metrics[k] for k in self.keys])

    def replay(self, batch: Batch, scalars: torch.Tensor) -> torch.Tensor:
        for k, buf in self.batch.items():
            buf.copy_(batch[k], non_blocking=True)
        self.scalars.copy_(scalars)
        self.graph.replay()
        return self.metrics


def make_multi_train_step(cfg: LossConfig, lpips_params: Any = None, *,
                          device) -> Callable:
    """``step(state, batches, mix_weight) → (state, metrics)``: one
    ``make_train_step`` step on each batch of the sequence ``batches`` in
    turn, the same trajectory, with the metrics stacked per key ([N]).
    JAX scans the N steps in one program (``lax.scan``).

    ``device`` (the trainer's) picks the path. On the CPU the steps run
    eagerly. On a CUDA device one step is captured in a CUDA graph and
    replayed from static buffers: each batch is copied into them, the
    step's ``[c1, c2, lr, mix_weight]`` is written, the graph replays and
    its metrics are copied out before the next replay. A batch signature
    (its keys, shapes and dtypes, with the state) is captured after its
    first ``WARMUP_STEPS`` steps, which run eagerly on a side stream as
    real steps of the trajectory; a capture that fails raises."""
    check_supported(cfg)
    if torch.device(device).type != "cuda":
        one_step = make_train_step(cfg, lpips_params)

        def eager(state: TrainState, batches: Sequence[Batch], mix_weight):
            out = [one_step(state, b, mix_weight)[1] for b in batches]
            return state, {k: torch.stack([m[k] for m in out])
                           for k in out[0]}
        return eager

    side = torch.cuda.Stream(device)
    captured: Dict[tuple, _CapturedStep] = {}
    # signature → [state, eager steps taken]; the state is held so that
    # its id in the signature is never reused
    warm: Dict[tuple, list] = {}

    def step(state: TrainState, batches: Sequence[Batch], mix_weight):
        dev = _device_of(state)
        rows = scalar_tensor(_scalar_rows(state, mix_weight, len(batches)),
                             dev)
        out, keys = [], None
        for i, batch in enumerate(batches):
            sig = (id(state),) + tuple(
                (k, tuple(v.shape), v.dtype) for k, v in sorted(batch.items()))
            rec = captured.get(sig)
            if rec is None and warm.setdefault(sig, [state, 0])[1] \
                    >= WARMUP_STEPS:
                with span("build.graph"):
                    rec = captured[sig] = _CapturedStep(state, cfg,
                                                        lpips_params, batch)
            if rec is not None:
                with span("train.replay"):
                    out.append(rec.replay(batch, rows[i]).clone())
                keys = rec.keys
            else:
                with span("build.eager_step"):
                    side.wait_stream(torch.cuda.current_stream(dev))
                    with torch.cuda.stream(side), f32_exact():
                        metrics = _update(state, cfg, lpips_params, batch,
                                          rows[i])
                        keys = list(metrics)
                        out.append(torch.stack([metrics[k] for k in keys]))
                    torch.cuda.current_stream(dev).wait_stream(side)
                warm[sig][1] += 1
            _advance(state)
        stacked = torch.stack(out)
        return state, {k: stacked[:, j] for j, k in enumerate(keys)}

    return step


def make_eval_step(cfg: LossConfig, lpips_params: Any = None) -> Callable:
    """``eval_step(model, batch, mix_weight=None) → (metrics, aux)``:
    eval-mode forward and the training loss decomposition (with the
    perceptual weights ``lpips_params``, as ``make_train_step``); the
    mix losses are weighted by ``mix_weight`` (None: 1). The VAE family
    goes through the mean and scores BCE; the ACAI family scores its
    ``ae``; the multichannel families score the image plane, unmasked as
    their train loss, and ``multichannel_combined`` adds the mix's Dice
    (``loss_ae_dist_labels``) and the sum that selects ``caisr.models``
    (``loss_ae_extra``). The alpha families mix with the probe's
    coefficients (the probe in eval mode; ``decoder_mix`` decodes the
    mix when the model has one) and return them as ``pred_alphas`` in
    the aux."""
    check_supported(cfg)
    labeled = cfg.family.startswith("multichannel")
    alpha_family = cfg.family == "alpha"

    @torch.no_grad()
    def eval_step(model, batch: Batch, mix_weight=None):
        w = 1.0 if mix_weight is None else mix_weight
        x = batch["image"]
        between = batch["slice_between"]
        models = model
        if cfg.family in ("acai", "alpha"):
            model = model["ae"]
        aux_extra = {}
        with f32_exact():
            if cfg.family == "vae":
                z = model.encode_mu(x)
                recon = model.decode(z)
                loss_dist = bce_sum_over_batch(recon, x)
                loss_ae, lap = loss_dist, loss_dist.new_zeros(())
                z_mix = latent_mix(z, batch["alpha_from"], batch["alpha_to"])
                z_ref = model.encode_mu(between)
            else:
                z = model.encode(x)
                recon = model.decode(z)
                if labeled:
                    recon = recon["image"]
                loss_ae, loss_dist, lap = _recon_loss(
                    cfg, lpips_params, recon, x[:, 0:1] if labeled else x)
                if alpha_family:
                    b = x.shape[0] // 2
                    alpha = models["probe"](torch.cat([z[:b], z[b:]], dim=1),
                                            _alpha_features(batch))
                    z_mix = alpha_mix(alpha, z[:b], z[b:], cfg.num_alphas,
                                      cfg.latent, cfg.alpha_scheme)
                    aux_extra["pred_alphas"] = alpha
                elif cfg.family in ("ae", "ae_combined"):
                    z_mix = _train_latent_mix(model, cfg, z, batch,
                                              train=False)
                else:
                    z_mix = latent_mix(z, batch["alpha_from"],
                                       batch["alpha_to"])
                z_ref = model.encode(between)
            if alpha_family and "decoder_mix" in models:
                s_mix = mix_out = models["decoder_mix"](z_mix)
            else:
                s_mix = mix_out = model.decode(z_mix)
            if labeled:
                s_mix = mix_out["image"]
            metrics = {"loss_ae": loss_ae, "loss_ae_dist": loss_dist,
                       "loss_laploss": lap,
                       "loss_latent_1": mse(z_mix, z_ref)}
            if cfg.combined or cfg.image_mix_loss_func is not None:
                ref, mask = ((between[:, 0:1], None) if labeled
                             else (between, batch.get("loss_mask")))
                loss_mix = _mix_image_loss(
                    cfg, lpips_params, ref, s_mix, mask,
                    sample_weight=batch.get("is_inbetween"))
                metrics["loss_ae_dist_extra"] = w * loss_mix
                if cfg.family == "multichannel_combined":
                    mix_labels = dice_loss(mix_out["soft_probs"],
                                           between[:, 1].to(torch.int32),
                                           cfg.nclasses)
                    metrics["loss_ae_dist_labels"] = w * mix_labels
                    metrics["loss_ae_extra"] = w * (loss_mix + mix_labels)
        return metrics, {"reconstruction": recon,
                         "slice_inbetween_mix": s_mix, "z_mix": z_mix,
                         **aux_extra}

    return eval_step
