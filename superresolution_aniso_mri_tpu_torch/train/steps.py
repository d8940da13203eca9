"""Train and eval steps of the ``ae`` and ``ae_combined`` families.

Port of ``superresolution_aniso_mri_tpu/train/steps.py`` (``LossConfig``,
``_recon_loss``, ``_mix_image_loss``, ``_wmse``, ``_train_latent_mix``,
``_ae_losses``, ``make_train_step``, ``make_eval_step``), NCHW.

Batch contract (``data/transforms.py::device_batch``):
  image          [2B, C, H, W]  from-slices ∥ to-slices
  slice_between  [B, C, H, W]
  alpha_from/alpha_to [B]
  is_inbetween   [B]            optional, weights the synthesis loss
  outer, outer2  [2B, C, H, W]  for train_latent_interp cubic / lanczos3
  loss_mask      [B, C, H, W]   optional (``use_masks``)

BatchNorm: the main encode → decode advances the running statistics
once; the auxiliary passes (outward-neighbour encodes, the decode of the
mix, the encodes of ``slice_between`` and of the synthesized slice)
normalise with their own batch statistics and advance nothing.

Metrics are device tensors (no host sync per step) under the JAX step's
keys; ``loss_ae_dist_extra`` is logged weighted by ``mix_weight``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch

from ..device import f32_exact
from ..models import VanillaACAI
from ..ops.lap_pyramid import lap_loss, lap_loss_per_sample
from ..ops.losses import latent_mix, latent_mix_cubic, latent_mix_lanczos3, mse
from .state import TrainState

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
    """The JAX package's loss configuration, the fields of the ``ae``
    families (same names and defaults); the port trains them with MSE
    losses (``check_supported``). The other families' fields come with
    ROADMAP item 9."""

    model: str = "ae_combined"
    recon_loss: str = "mse"
    use_laploss: bool = False
    use_ssim_loss: bool = False
    image_mix_loss_func: Optional[str] = None
    use_extra_latent_loss: bool = False
    use_masks: bool = False
    train_latent_interp: str = "linear"

    @property
    def family(self) -> str:
        return FAMILY_OF_MODEL[self.model]

    @property
    def combined(self) -> bool:
        return "combined" in self.model


def check_supported(cfg: LossConfig) -> None:
    """Raise NotImplementedError for what the port does not train yet,
    naming the ROADMAP item that lifts it."""
    if cfg.family not in ("ae", "ae_combined"):
        raise NotImplementedError(
            f"model {cfg.model!r} (family {cfg.family!r}): the port trains "
            f"the ae and ae_combined families only (ROADMAP item 9)")
    if cfg.recon_loss != "mse" or cfg.image_mix_loss_func not in (None,
                                                                  "mse"):
        raise NotImplementedError(
            f"recon_loss={cfg.recon_loss!r}, image_mix_loss_func="
            f"{cfg.image_mix_loss_func!r}: perceptual losses are not "
            f"ported yet (ROADMAP item 8); use mse")
    if cfg.use_ssim_loss:
        raise NotImplementedError(
            "use_ssim_loss needs a differentiable SSIM (ROADMAP item 8)")
    if cfg.train_latent_interp not in ("linear", "cubic", "lanczos3"):
        raise ValueError(f"unknown train_latent_interp "
                         f"{cfg.train_latent_interp!r}")


def _weighted(per_sample: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    return (per_sample * weight).sum() / weight.sum().clamp_min(1.0)


def _recon_loss(cfg: LossConfig, pred: torch.Tensor, target: torch.Tensor):
    """(loss_ae, loss_ae_dist, loss_laploss): MSE plus, with
    ``use_laploss``, the Laplacian-pyramid term."""
    dist = mse(pred, target)
    lap = lap_loss(pred, target) if cfg.use_laploss else pred.new_zeros(())
    return dist + lap, dist, lap


def _mix_image_loss(cfg: LossConfig, reference: torch.Tensor,
                    synthesized: torch.Tensor,
                    mask: Optional[torch.Tensor],
                    sample_weight: Optional[torch.Tensor] = None):
    """Synthesis loss, MSE branch: per-sample ``sample_weight``
    (``is_inbetween``) keeps degenerate triplets out, of the lap term
    too; all-ones weights give the unweighted loss."""
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


def _train_latent_mix(model: VanillaACAI, cfg: LossConfig, z: torch.Tensor,
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


def _ae_losses(model: VanillaACAI, cfg: LossConfig, batch: Batch,
               mix_weight) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(loss, metrics) of the ``ae`` / ``ae_combined`` families."""
    x = batch["image"]
    between = batch["slice_between"]
    z = model.encode(x, train=True)
    out = model.decode(z, train=True)
    loss_ae, loss_dist, loss_lap = _recon_loss(cfg, out, x)

    z_mix = _train_latent_mix(model, cfg, z, batch)
    s_mix = model.decode(z_mix, train=True, update_stats=False)
    z_ref = model.encode(between, train=True, update_stats=False)
    metrics = {"loss_ae_dist": loss_dist, "loss_laploss": loss_lap,
               "loss_latent_1": mse(z_mix, z_ref)}
    if cfg.family == "ae_combined":
        sw = batch.get("is_inbetween")
        loss_mix = _mix_image_loss(cfg, between, s_mix,
                                   batch.get("loss_mask"), sample_weight=sw)
        loss_extra = mix_weight * loss_mix
        if cfg.use_extra_latent_loss:
            z_syn = model.encode(s_mix, train=True, update_stats=False)
            l_lat2 = _wmse(z_ref, z_syn, sw)
            loss_extra = loss_extra + 0.5 * (_wmse(z_ref, z_mix, sw) + l_lat2)
            metrics["loss_latent_2"] = l_lat2
        loss_ae = loss_ae + loss_extra
        metrics["loss_ae_dist_extra"] = mix_weight * loss_mix
        metrics["loss_ae_extra"] = loss_extra
    metrics["loss_ae"] = loss_ae
    return loss_ae, {k: v.detach() for k, v in metrics.items()}


def make_train_step(cfg: LossConfig) -> Callable:
    """``step(state, batch, mix_weight) → (state, metrics)``: forward,
    backward and one optimizer update, in place on ``state`` (its model
    and optimizer state); float32 work with TF32 off. ``mix_weight`` is
    the synthesis-loss weight (a float or a 0-d tensor)."""
    check_supported(cfg)

    def step(state: TrainState, batch: Batch, mix_weight):
        with f32_exact():
            params = state.params()
            loss, metrics = _ae_losses(state.model, cfg, batch, mix_weight)
            grads = torch.autograd.grad(loss, list(params.values()))
            state.tx.step({k: p.data for k, p in params.items()},
                          dict(zip(params, grads)), state.opt_state)
        state.step += 1
        return state, metrics

    return step


def make_eval_step(cfg: LossConfig) -> Callable:
    """``eval_step(model, batch, mix_weight=None) → (metrics, aux)``:
    eval-mode forward and the training loss decomposition; the mix
    losses are weighted by ``mix_weight`` (None: 1)."""
    check_supported(cfg)

    @torch.no_grad()
    def eval_step(model: VanillaACAI, batch: Batch, mix_weight=None):
        w = 1.0 if mix_weight is None else mix_weight
        x = batch["image"]
        between = batch["slice_between"]
        with f32_exact():
            z = model.encode(x)
            recon = model.decode(z)
            loss_ae, loss_dist, lap = _recon_loss(cfg, recon, x)
            z_mix = _train_latent_mix(model, cfg, z, batch, train=False)
            s_mix = model.decode(z_mix)
            z_ref = model.encode(between)
            metrics = {"loss_ae": loss_ae, "loss_ae_dist": loss_dist,
                       "loss_laploss": lap,
                       "loss_latent_1": mse(z_mix, z_ref)}
            if cfg.combined or cfg.image_mix_loss_func is not None:
                loss_mix = _mix_image_loss(
                    cfg, between, s_mix, batch.get("loss_mask"),
                    sample_weight=batch.get("is_inbetween"))
                metrics["loss_ae_dist_extra"] = w * loss_mix
        return metrics, {"reconstruction": recon,
                         "slice_inbetween_mix": s_mix, "z_mix": z_mix}

    return eval_step
