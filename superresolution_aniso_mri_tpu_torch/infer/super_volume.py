"""Whole-volume super-resolution: encode the kept slices, mix latents,
decode, interleave.

Port of ``superresolution_aniso_mri_tpu/infer/super_volume.py``
(``:30-66,124-225,263-464,478-1059``). All kept slices encode as one
flat ``[B*K]`` batch, every (K-1) x A mixed latent is built with one
broadcast, and reconstructions and interpolants decode together as
``[recon ∥ interp]``, in per-volume chunks of ``decode_batch`` slices.
Slice order, tail-slice semantics, padding and the latent mixing rules
(dtype included) are the reference's. Tensors are NCHW inside; the
public functions take and return the reference's numpy shapes
(``[S, H, W]`` in, ``[S', H, W]`` out).

The conventional baselines (``simple_interpolation``,
``create_simple_interpolation``, ``apply_blur_filter``,
``rescale_volume``; ``:1141-1250``) are host numpy and scipy code,
copied.

Every ``ae_class`` of ``models.MODEL_REGISTRY`` serves. The VAE family
encodes ``encode → heads → mu → unflatten`` (``encode_mu``), so it
serves the mean, never a sample, and its Dense heads take only latents
of a ``width`` × ``width`` input: a volume whose stride-padded in-plane
size is not ``width`` raises a ValueError before any device work. A
``VAE2`` latent is a flat vector, mixed the same way.

``MultiChannelAE`` (ACDCLBL) encodes (image, label) planes: the labels
ride along the kept grid (zeros, with a warning, when there are none)
and the decode returns the image and ``argmax(soft_probs)`` as two
planes through the same interleave; the class ids are never clamped and
come back as ``upsampled_labels``, rounded to the input labels' dtype
(int32 without input labels).

The AE+CAISR combo (``trainer.params_sr``, loaded by
``Trainer.load_caisr``): the SR model synthesizes the in-between slices
through its own synthesis core (cached on the trainer under the SR
module, beside the autoencoder's), and the primary model reconstructs
the kept slices through ``trainer.predict`` in chunks of the decode
budget, unless ``use_original``. A MultiChannelAE combo keeps the SR
model's decoded labels and the primary's ``argmax(soft_probs)``.

``num_devices`` N > 1 shards over the first N devices of the
trainer's device type (N shards of the CPU, or ``cuda:0 … cuda:N-1``,
ValueError when fewer are attached): ``create_super_volume`` the kept
slices (the kept count padded to a multiple of N, edge-replicated for
multi-tap schemes; the decode budget per device ``max(32, decode_batch
// N)``), ``create_super_volumes`` the volumes (chunks of a multiple of
N, padded with the last volume; a lone shape goes the sharded single
path), as JAX's ``:656-681,926-1022``. ``packed=True`` decodes through
``infer/packed_decoder.py``.
"""
from __future__ import annotations

import threading
import weakref
from functools import partial
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ..device import f32_exact
from ..models.multi_channel import MultiChannelAE
from ..ops.losses import (LANCZOS3_OFFSETS, catmull_rom_weights,
                          lanczos3_weights)
from .latent_taps import (fitted_tap_weights, fitted_table_path,
                          is_fitted_mode, latent_interp_cache_token,
                          load_latent_taps)
from .packed_decoder import make_packed_decoder, packable
from ..utils.profiling import span

LATENT_INTERP_MODES = ("linear", "cubic", "lanczos3", "fitted")
_LATENT_TAP_OFFSETS = {"cubic": (-1, 0, 1, 2), "lanczos3": LANCZOS3_OFFSETS}
READBACK_DTYPES = (None, "float32", "bfloat16")



def _chunked_call_pervol(fn, x: torch.Tensor,
                         per_vol_chunk: Optional[int]) -> torch.Tensor:
    """Apply ``fn`` over the flat [B*N] batch of a [B, N, ...] stack in
    chunks of ``per_vol_chunk`` slices PER VOLUME (each step runs
    [B, chunk]), bounding in-flight activations; None runs one call.
    Returns [B, N, ...]."""
    b, n = x.shape[0], x.shape[1]
    if per_vol_chunk is None or n <= per_vol_chunk:
        return fn(x.flatten(0, 1)).unflatten(0, (b, n))
    outs = []
    for start in range(0, n, int(per_vol_chunk)):
        part = x[:, start:start + int(per_vol_chunk)]
        outs.append(fn(part.flatten(0, 1)).unflatten(0, (b, part.shape[1])))
    return torch.cat(outs, dim=1)


def model_label_semantics(trainer):
    """(needs_label_channel, decodes_labels): a ``colors >= 2`` encoder
    takes [image, label] input planes; only ``MultiChannelAE`` decodes
    class ids (a plain 2-channel AE's second output plane is an
    intensity reconstruction, so its labels ride along instead)."""
    colors = int(getattr(getattr(trainer, "model_config", None),
                         "colors", 1) or 1)
    return colors >= 2, isinstance(trainer._ae_model(), MultiChannelAE)


def make_kept_label_channel(kept_images: np.ndarray, labels,
                            downsample_steps, remain: int,
                            context: str) -> np.ndarray:
    """Label plane on the kept-slice grid for ``colors >= 2`` encoders:
    tail-strip + stride the full-grid ``labels`` like the image volume;
    zeros (with a warning) when labels are unavailable."""
    kept_images = np.asarray(kept_images)
    if labels is None:
        import warnings
        warnings.warn(
            f"multichannel volume synthesis without labels ({context}): "
            "feeding a zero label channel", stacklevel=3)
        return np.zeros(kept_images.shape, np.float32)
    lbl = np.asarray(labels, np.float32)
    if remain:
        lbl = lbl[:-remain]
    if downsample_steps is not None and int(downsample_steps) > 1:
        lbl = lbl[::int(downsample_steps)]
    if lbl.shape != kept_images.shape:
        raise ValueError(
            f"{context}: labels {np.asarray(labels).shape} do not lie on "
            f"the image grid — strided to {lbl.shape} but the kept image "
            f"grid is {kept_images.shape}; pass labels with one plane "
            "per image slice (or None for a zero channel)")
    return lbl


def kept_slice_grid(img, ds: int):
    """(kept, remain): strip the verbatim tail and stride to the kept
    grid — which slices the model sees."""
    s = img.shape[0]
    remain = (s - 1) % int(ds)
    return (img[:-remain] if remain else img)[::ds], remain


def clip_with_label_channel(vol: torch.Tensor,
                            decodes_labels: bool) -> torch.Tensor:
    """[0,1]-clamp of [..., C, H, W] that leaves a decoded-label channel
    (channel 1) untouched."""
    if decodes_labels:
        return torch.cat([vol[..., :1, :, :].clamp(0.0, 1.0),
                          vol[..., 1:, :, :]], dim=-3)
    return vol.clamp(0.0, 1.0)


def latent_decoder(model):
    """The decoder that serving uses: ``MultiChannelAE``'s decode as two
    planes, the image and ``argmax(soft_probs)`` (the first maximum, as
    ``jnp.argmax``) in the image's dtype; else ``decode``."""
    if not isinstance(model, MultiChannelAE):
        return model.decode

    def decode(z: torch.Tensor) -> torch.Tensor:
        out = model.decode(z)
        ids = out["soft_probs"].argmax(dim=1, keepdim=True)
        return torch.cat([out["image"], ids.to(out["image"].dtype)], dim=1)

    return decode


def latent_encoder(model):
    """The encoder that serving uses: the VAE family's ``encode_mu``,
    else ``encode``."""
    return getattr(model, "encode_mu", model.encode)


def check_vae_size(model, h: int, w: int) -> None:
    """Raise ValueError when ``model`` has Dense heads (the VAE family)
    and the stride-padded in-plane size ``h`` × ``w`` is not its
    ``width`` × ``width``."""
    cfg = model.config
    div = 2 ** cfg.scales
    hp, wp = h + (-h) % div, w + (-w) % div
    if hasattr(model, "heads") and (hp, wp) != (cfg.width, cfg.width):
        raise ValueError(
            f"{type(model).__name__} serves only volumes whose padded "
            f"in-plane size is --width ({cfg.width} x {cfg.width}): its "
            f"Dense heads are fixed to that latent grid, got {h} x {w} "
            f"(padded {hp} x {wp}); crop or resample the volume first")


def latent_tap_weights(mode: str, alphas: torch.Tensor) -> torch.Tensor:
    """[A] → [A, n_taps] mixing weights for a multi-tap latent scheme."""
    if mode == "cubic":
        return catmull_rom_weights(alphas)
    if mode == "lanczos3":
        return lanczos3_weights(alphas)
    raise ValueError(f"no tap weights for latent_interp={mode!r}")


def interleave_volume(recon: torch.Tensor,
                      interp: torch.Tensor) -> torch.Tensor:
    """[..., K, C, H, W] + [..., K-1, A, C, H, W] →
    [..., (K-1)(A+1)+1, C, H, W]: each kept slice followed by its A
    interpolants, then the last kept slice."""
    k, a = recon.shape[-4], interp.shape[-4]
    lead = recon.shape[:-4]
    body = torch.cat([recon[..., :-1, None, :, :, :], interp], dim=-4)
    body = body.reshape(lead + ((k - 1) * (a + 1),) + recon.shape[-3:])
    return torch.cat([body, recon[..., -1:, :, :, :]], dim=-4)


class SynthesisStages:
    """The stages of the synthesis core for one model: ``encode`` the
    kept stack, ``mix`` the latents of a range of pairs, ``decode``
    reconstructions and interpolants, ``finish`` (interleave, clamp).
    The sharded synthesizer (``parallel.mesh``) runs them per device."""

    def __init__(self, model, decode_batch: Optional[int] = None,
                 packed: bool = False, latent_interp: str = "linear"):
        self.model = model
        self.decode_batch = decode_batch
        self.cfg = model.config
        self._encode = latent_encoder(model)
        self._decode = (make_packed_decoder(model)
                        if packed and packable(model)
                        else latent_decoder(model))
        self.decodes_labels = isinstance(model, MultiChannelAE)
        if is_fitted_mode(latent_interp):
            table = load_latent_taps(fitted_table_path(latent_interp))
            self.tap_offsets = tuple(int(o) for o in table["offsets"])
            self.tap_weight_fn = partial(fitted_tap_weights, table["alphas"],
                                         table["weights"])
        elif latent_interp in _LATENT_TAP_OFFSETS:
            self.tap_offsets = _LATENT_TAP_OFFSETS[latent_interp]
            self.tap_weight_fn = partial(latent_tap_weights, latent_interp)
        elif latent_interp == "linear":
            self.tap_offsets = self.tap_weight_fn = None
        else:
            raise ValueError(f"latent_interp must be one of "
                             f"{LATENT_INTERP_MODES} (fitted as "
                             f"'fitted:<table path>'), got {latent_interp!r}")

    def _pads(self, h: int, w: int):
        div = 2 ** self.cfg.scales
        return (-h) % div, (-w) % div

    def encode(self, kept: torch.Tensor) -> torch.Tensor:
        """[B, K, C, H, W] → latents [B, K, ...] in the compute dtype (an
        in-plane size not divisible by the encoder's total stride is
        reflect-padded; ``decode`` crops back)."""
        b, k, _, h, w = kept.shape
        check_vae_size(self.model, h, w)
        ph, pw = self._pads(h, w)
        with span("synth.encode"):
            if ph or pw:
                flat = torch.nn.functional.pad(
                    kept.flatten(0, 1), (0, pw, 0, ph), mode="reflect")
                kept = flat.unflatten(0, (b, k))
            # the latent carries the compute dtype through the mix
            return _chunked_call_pervol(self._encode, kept,
                                        self.decode_batch).to(self.cfg.dtype)

    def mix(self, z: torch.Tensor, alphas: torch.Tensor, lo: int,
            hi: int) -> torch.Tensor:
        """The mixed latents [B, hi - lo, A, ...] of pairs ``lo … hi-1``
        of the whole stack ``z`` [B, K, ...] (taps clamped to [0, K-1])."""
        with span("synth.mix"):
            b, k = z.shape[0], z.shape[1]
            a_n = alphas.shape[0]
            # [1, 1, A, 1, ...] over the latent's own axes ([C, H, W] or
            # VAE2's flat [D])
            bcast = (1, 1, a_n) + (1,) * (z.ndim - 2)
            if self.tap_offsets is None:
                a = alphas.to(z.dtype).view(bcast)
                one = torch.ones((), dtype=z.dtype, device=z.device)
                return (a * z[:, lo + 1:hi + 1, None]
                        + (one - a) * z[:, lo:hi, None])
            # weights in float32, then the mix in the latent's dtype
            wts = self.tap_weight_fn(alphas).to(z.dtype)    # [A, n_taps]
            pair = torch.arange(lo, hi, device=z.device)
            z_mix = torch.zeros((b, hi - lo, a_n) + z.shape[2:],
                                dtype=z.dtype, device=z.device)
            for ti, off in enumerate(self.tap_offsets):
                tap = z.index_select(1, (pair + off).clamp(0, k - 1))
                z_mix = z_mix + wts[:, ti].view(bcast) * tap[:, :, None]
            return z_mix

    def decode(self, kept: torch.Tensor, z: torch.Tensor,
               z_mix: torch.Tensor, use_original: bool
               ) -> Dict[str, torch.Tensor]:
        """{'recon' [B, K, ...], 'interp' [B, P, A, ...]}: the decoded
        ``z`` (or, with ``use_original``, ``kept`` itself: a
        MultiChannelAE's kept planes, the input labels verbatim) and the
        decoded ``z_mix`` [B, P, A, ...], as one batch."""
        with span("synth.decode"):
            k, k1, a_n = z.shape[1], z_mix.shape[1], z_mix.shape[2]
            z_flat = z_mix.flatten(1, 2)                   # [B, P*A, ...]
            if use_original:
                dec = _chunked_call_pervol(self._decode, z_flat,
                                           self.decode_batch)
                recon = kept
                interp = dec.unflatten(1, (k1, a_n))
            else:
                dec = _chunked_call_pervol(self._decode,
                                           torch.cat([z, z_flat], dim=1),
                                           self.decode_batch)
                recon = dec[:, :k]
                interp = dec[:, k:].unflatten(1, (k1, a_n))
            h, w = kept.shape[3], kept.shape[4]
            if any(self._pads(h, w)):
                recon = recon[..., :h, :w]
                interp = interp[..., :h, :w]
            return {"recon": recon, "interp": interp}

    def finish(self, out: Dict[str, torch.Tensor], interleave: bool,
               single: bool) -> Dict[str, torch.Tensor]:
        if interleave:
            out["volume"] = clip_with_label_channel(
                interleave_volume(out["recon"], out["interp"]),
                self.decodes_labels)
        if single:
            out = {key: val[0] for key, val in out.items()}
        return out


def make_synthesis_core(model, decode_batch: Optional[int] = None,
                        packed: bool = False,
                        latent_interp: str = "linear"):
    """core(kept [K,C,H,W] or [B,K,C,H,W], alphas [A], use_original,
    interleave) → {'recon', 'interp'[, 'volume']}, with a leading volume
    axis on every output when the input had one.

    ``packed=True`` decodes through ``infer/packed_decoder.py`` (every
    nearest 2x upsample folded into the following conv) when the model
    is ``packable``, else through the plain decoder; off by default, as
    in JAX.

    Multi-tap schemes read z[clip(pair + offset, 0, K-1)]: callers that
    pad the kept stack must edge-replicate (create_super_volume does)."""
    stages = SynthesisStages(model, decode_batch, packed, latent_interp)

    @torch.inference_mode()
    def core(kept: torch.Tensor, alphas: torch.Tensor,
             use_original: bool = False,
             interleave: bool = False) -> Dict[str, torch.Tensor]:
        with f32_exact():
            single = kept.ndim == 4
            if single:
                kept = kept[None]
            z = stages.encode(kept)
            out = stages.decode(kept, z,
                                stages.mix(z, alphas, 0, kept.shape[1] - 1),
                                use_original)
            return stages.finish(out, interleave, single)

    return core


def _get_core(trainer, decode_batch: Optional[int], latent_interp: str,
              model=None, num_devices: int = 1, batched: bool = False):
    """The synthesis core for ``model`` (default ``trainer``'s
    autoencoder; the combo passes its SR model), cached on the trainer
    per (model, decode_batch, latent_interp table version, mesh): the
    key holds the module itself, so an SR model never gets the
    autoencoder's core, nor a later SR model an earlier one's. With
    ``num_devices`` N > 1 it is the sharded synthesizer over the first N
    devices of the trainer's device type: the slice axis, or with
    ``batched`` the volume axis (``make_sharded_batched_synthesizer``,
    which returns the volumes)."""
    model = trainer._ae_model() if model is None else model
    n = int(num_devices or 1)
    key = (model, decode_batch, latent_interp_cache_token(latent_interp),
           n, batched and n > 1)
    cache = trainer.synth_cache
    if key not in cache:
        with span("build.core"):
            if n > 1:
                from .. import parallel

                mesh = parallel.local_mesh(n, trainer.device)
                factory = (parallel.make_sharded_batched_synthesizer
                           if batched else parallel.make_sharded_synthesizer)
                cache[key] = factory(model, mesh, decode_batch=decode_batch,
                                     latent_interp=latent_interp)
            else:
                cache[key] = make_synthesis_core(
                    model, decode_batch, latent_interp=latent_interp)
    return cache[key]


def synthesis_model(trainer):
    """The model that synthesizes the in-between slices: the SR model
    when one is loaded (``params_sr``), else the autoencoder."""
    sr = getattr(trainer, "params_sr", None)
    return trainer._ae_model() if sr is None else sr


def latent_space_interp(trainer, alpha: float, img1, img2):
    """``decode(alpha * enc(img1) + (1 - alpha) * enc(img2))`` of NCHW
    slices, through the SR model when one is loaded."""
    z1 = trainer.encode(img1, use_sr_model=True)
    z2 = trainer.encode(img2, use_sr_model=True)
    return trainer.decode(alpha * z1 + (1.0 - alpha) * z2, use_sr_model=True)


def make_volume_synthesizer(model, decode_batch: Optional[int] = None,
                            packed: bool = False,
                            latent_interp: str = "linear"):
    """synth(kept [K,C,H,W], alphas [A], use_original, interleave) →
    {'recon' [K,C,H,W], 'interp' [K-1,A,C,H,W][, 'volume']}: the
    synthesis core itself."""
    return make_synthesis_core(model, decode_batch, packed, latent_interp)


def make_batched_synthesizer(model, decode_batch: Optional[int] = None,
                             latent_interp: str = "linear",
                             packed: bool = False):
    """synth(kept [B,K,C,H,W], alphas [A], use_original) → interleaved,
    clamped volumes [B, (K-1)(A+1)+1, C, H, W] (one flat [B*K] batch)."""
    core = make_synthesis_core(model, decode_batch, packed, latent_interp)

    def synthesize(kept, alphas, use_original: bool = False):
        return core(kept, alphas, use_original, True)["volume"]

    return synthesize


# kept-slice-count buckets: kept stacks pad up to the next bucket
SLICE_BUCKETS = (8, 12, 16, 24, 32, 48, 64, 96, 128, 192, 256, 384, 512)

# Device-memory budgets for in-flight decode activations, as the
# reference sized them for a 16 GB TPU v5e; re-sizing them for the
# 80 GB H100 waits for a measurement (ROADMAP.md).
_DECODE_ACT_BUDGET_BYTES = 1 << 30
_BATCH_ACT_BUDGET_BYTES = 4 << 30
# Page-locked host bytes that returned volumes still alive may hold
# before a volume is read back into pageable memory instead: a caller
# that keeps many volumes (create_hr_images, a notebook) pins no more
# than this (the allocator rounds each block up to a power of two).
_PINNED_OUTPUT_BUDGET_BYTES = 2 << 30


def bucket_size(k: int) -> int:
    """Next bucket ≥ k (beyond the table: next multiple of 128)."""
    for b in SLICE_BUCKETS:
        if k <= b:
            return b
    return ((k + 127) // 128) * 128


def _auto_decode_batch(n_total: int, h: int, w: int,
                       depth: int) -> Optional[int]:
    """Chunk size bounding decoder activations to the budget (full-res
    feature map at float32 with 4x headroom); None when all fits."""
    per_slice = h * w * max(depth, 32) * 4 * 4
    cap = max(32, _DECODE_ACT_BUDGET_BYTES // max(per_slice, 1))
    return None if n_total <= cap else int(cap)


def _batch_volume_cap(k_pad: int, a_n: int, h: int, w: int,
                      depth: int, decode_batch="auto",
                      channels: int = 1) -> tuple:
    """(decode_batch, max_b): per-volume decode chunk and how many
    volumes fit one batched call under _BATCH_ACT_BUDGET_BYTES, charging
    the in-flight activations and the chunk-independent resident tensors
    (output volume, kept input, latent stacks) per volume."""
    n_dec = k_pad + (k_pad - 1) * a_n
    if decode_batch == "auto":
        decode_batch = _auto_decode_batch(n_dec, h, w, depth)
    in_flight = n_dec if decode_batch is None else min(decode_batch, n_dec)
    act = in_flight * h * w * max(depth, 32) * 4 * 2
    resident = n_dec * h * w * max(1, int(channels)) * 4 * 3
    per_vol = act + resident
    return decode_batch, max(1, int(_BATCH_ACT_BUDGET_BYTES
                                    // max(per_vol, 1)))


# test-time augmentation: in-plane symmetries of the slice grid
TTA_MODES = ("flips", "dihedral")


def _tta_variants(mode: str):
    """(forward, inverse) pairs of in-plane (axes 1, 2) numpy transforms
    for [S, H, W] volumes; the identity is always first."""
    if mode not in TTA_MODES:
        raise ValueError(f"tta must be one of {TTA_MODES} or None, "
                         f"got {mode!r}")
    ks = (0, 2) if mode == "flips" else (0, 1, 2, 3)
    variants = []
    for k in ks:
        for flip in (False, True):
            def fwd(v, k=k, flip=flip):
                v = np.rot90(v, k, axes=(1, 2))
                if flip:
                    v = np.flip(v, axis=2)
                return np.ascontiguousarray(v)

            def inv(v, k=k, flip=flip):
                if flip:
                    v = np.flip(v, axis=2)
                return np.ascontiguousarray(np.rot90(v, -k, axes=(1, 2)))

            variants.append((fwd, inv))
    return variants


def _predict_chunked(trainer, kept: torch.Tensor, decode_batch):
    """``trainer.predict`` in ``decode_batch``-sized chunks (the combo's
    reconstruction pass keeps the synthesis core's memory bound)."""
    n = kept.shape[0]
    if decode_batch is None or n <= int(decode_batch):
        return trainer.predict(kept)
    c = int(decode_batch)
    outs = [trainer.predict(kept[i:i + c]) for i in range(0, n, c)]
    if isinstance(outs[0], dict):
        return {k: torch.cat([o[k] for o in outs]) for k in outs[0]}
    return torch.cat(outs)


def _combo_volume(trainer, kept: torch.Tensor, alphas: torch.Tensor,
                  k_true: int, use_original: bool, decode_batch,
                  latent_interp: str, decodes_labels: bool,
                  num_devices: int = 1) -> torch.Tensor:
    """The AE+CAISR combo's interleaved [S', P, H, W] volume, its image
    plane clamped to [0, 1] on the device as the synthesis core's is: the
    SR model synthesizes (slice-sharded over ``num_devices``), the
    primary reconstructs (or the kept slices stay)."""
    core = _get_core(trainer, decode_batch, latent_interp, trainer.params_sr,
                     num_devices)
    interp = core(kept, alphas, use_original=True)["interp"]
    n_ch = 2 if (decodes_labels and interp.shape[-3] >= 2) else 1
    interp = interp[:k_true - 1, :, :n_ch]
    kept_true = kept[:k_true]
    if use_original:
        recon = kept_true[:, :n_ch]
    else:
        pred = _predict_chunked(trainer, kept_true, decode_batch)
        if isinstance(pred, dict):
            recon = pred["image"][:, :1]
            if n_ch == 2:
                ids = pred["soft_probs"].argmax(dim=1, keepdim=True)
                recon = torch.cat([recon, ids.to(recon.dtype)], dim=1)
        else:
            recon = pred[:, :n_ch]
    dtype = torch.promote_types(recon.dtype, interp.dtype)
    return clip_with_label_channel(
        interleave_volume(recon.to(dtype), interp.to(dtype)), n_ch == 2)


def _check_serving_options(trainer, readback_dtype) -> None:
    sr = getattr(trainer, "params_sr", None)
    if sr is not None and not isinstance(sr, torch.nn.Module):
        raise TypeError(
            f"trainer.params_sr must be the SR model that "
            f"Trainer.load_caisr loads (an nn.Module), got "
            f"{type(sr).__name__}: the port has no (params, batch_stats) "
            f"pair")
    if readback_dtype not in READBACK_DTYPES:
        raise ValueError(f"readback_dtype must be one of {READBACK_DTYPES}, "
                         f"got {readback_dtype!r}")


def _alpha_grid(alpha_range, downsample_steps, generate_inbetween_slices):
    if alpha_range is None:
        alpha_range = [0.25, 0.5, 0.75]
    alpha_range = np.asarray(list(alpha_range), np.float32)
    if generate_inbetween_slices and downsample_steps is None:
        downsample_steps = int(len(alpha_range) + 1)
    if generate_inbetween_slices and downsample_steps != len(alpha_range) + 1:
        raise ValueError(
            f"generate_inbetween_slices needs len(alpha_range) "
            f"({len(alpha_range)}) == downsample_steps-1 "
            f"({downsample_steps - 1})")
    return alpha_range, downsample_steps


def _pad_kept(kept: np.ndarray, k_pad: int, latent_interp: str) -> np.ndarray:
    """Pad the kept stack [K, ...] to k_pad slices: edge-replicate for
    multi-tap schemes (boundary taps must read the true edge latent),
    zeros for linear (pairs never read padded latents)."""
    k_true = kept.shape[0]
    if k_pad <= k_true:
        return kept
    return np.pad(kept, ((0, k_pad - k_true),) + ((0, 0),) * (kept.ndim - 1),
                  mode="edge" if latent_interp != "linear" else "constant")


class _LiveBytes:
    """The bytes of the arrays handed to ``track``, each counted until
    the object that owns its memory (the array's base) is freed. The
    caching host allocator's ``active_bytes`` stat does not fall when a
    block is freed (torch 2.11), so the readback keeps its own count."""

    def __init__(self):
        self.total = 0
        self._lock = threading.Lock()

    def _add(self, n: int) -> None:
        with self._lock:
            self.total += n

    def track(self, array: np.ndarray) -> np.ndarray:
        self._add(array.nbytes)
        owner = array if array.base is None else array.base
        weakref.finalize(owner, self._add, -array.nbytes)
        return array


_PINNED_OUTPUTS = _LiveBytes()


def _readback(vol: torch.Tensor, readback_dtype) -> np.ndarray:
    """Device → host float32 numpy array of its own, C-contiguous;
    'bfloat16' casts on the device and widens on the host (half the
    transfer).

    A float32 CUDA tensor lands, by one asynchronous copy, in a
    page-locked block of torch's caching host allocator, and the array
    returned is that block: it goes back to the allocator only when the
    caller has dropped every array on it, so a reused block never aliases
    a returned volume. Past ``_PINNED_OUTPUT_BUDGET_BYTES`` held by
    such arrays the copy lands in pageable memory. The
    ``serve.readback`` span counts ``pinned`` (1 for a page-locked copy)
    and ``host_allocs`` (1 where that copy took a new block)."""
    with span("serve.readback", pinned=0, host_allocs=0) as rec:
        if readback_dtype == "bfloat16":
            return vol.to(torch.bfloat16).cpu().to(torch.float32).numpy()
        vol = vol.to(torch.float32)
        if vol.device.type != "cuda":
            # the core's own output: the copy gives the volume its memory
            return vol.numpy().copy()
        if (_PINNED_OUTPUTS.total + vol.nbytes
                > _PINNED_OUTPUT_BUDGET_BYTES):
            return vol.cpu().numpy()
        allocs = (torch.cuda.host_memory_stats().get("num_host_alloc", 0)
                  if rec is not None else 0)
        host = torch.empty(vol.shape, dtype=torch.float32, pin_memory=True)
        if rec is not None:
            rec.counts.update(pinned=1, host_allocs=int(
                torch.cuda.host_memory_stats().get("num_host_alloc", 0)
                - allocs))
        host.copy_(vol, non_blocking=True)
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(vol.device))
        done.synchronize()
        return _PINNED_OUTPUTS.track(host.numpy())


def _read_volume(vol: torch.Tensor, readback_dtype) -> tuple:
    """(image [S', H, W], class ids [S', H, W] or None) of an interleaved
    [S', P, H, W] volume on the device, clamped there: the image plane
    through ``_readback``, the decoded class ids of a MultiChannelAE
    (P = 2) as float32 (small integers, exact in either readback
    dtype)."""
    ids = None
    if vol.shape[1] >= 2:
        with span("serve.readback"):
            ids = vol[:, 1].to(torch.float32).cpu().numpy()
    return _readback(vol[:, 0], readback_dtype), ids


def create_super_volume(trainer, images, alpha_range=None,
                        use_original: bool = False,
                        downsample_steps: Optional[int] = None,
                        generate_inbetween_slices: bool = False,
                        labels=None, pad_to_bucket: bool = True,
                        decode_batch="auto",
                        num_devices: int = 1,
                        tta: Optional[str] = None,
                        latent_interp: str = "linear",
                        readback_dtype: Optional[str] = None
                        ) -> Dict[str, np.ndarray]:
    """Synthesize one volume with the reference's tail-slice semantics.

    ``trainer``: a ``ServingModel`` (runs on its device). ``images``:
    [S, H, W] in [0, 1]. Returns {'upsampled_image' [S', H, W],
    'pred_alphas', 'upsampled_labels'}; see the reference
    ``create_super_volume`` for every option. ``readback_dtype=
    'bfloat16'`` casts on the device and widens on the host."""
    _check_serving_options(trainer, readback_dtype)
    kwargs = dict(alpha_range=alpha_range, use_original=use_original,
                  downsample_steps=downsample_steps,
                  generate_inbetween_slices=generate_inbetween_slices,
                  pad_to_bucket=pad_to_bucket, decode_batch=decode_batch,
                  num_devices=num_devices, latent_interp=latent_interp,
                  readback_dtype=readback_dtype)
    # the work runs in a callee, so that its host buffers are freed
    # inside the request's span
    with span("serve.request", volumes=1):
        if tta:
            return _tta_volume(trainer, images, labels, tta, kwargs)
        return _one_volume(trainer, images, labels, **kwargs)


def _tta_volume(trainer, images, labels, tta: str,
                kwargs: Dict) -> Dict[str, np.ndarray]:
    """``create_super_volume`` with test-time augmentation: the mean of
    the volumes of every ``_tta_variants(tta)`` transform of ``images``
    (and ``labels``), each transformed back, clamped to [0, 1]; the
    other outputs of the identity's call."""
    variants = _tta_variants(tta)
    base = create_super_volume(trainer, images, labels=labels, **kwargs)
    with span("serve.finalize"):
        acc = base["upsampled_image"].astype(np.float64).copy()
    for fwd, inv in variants[1:]:
        with span("serve.prep"):
            img = fwd(np.asarray(images, np.float32))
            lbl = None if labels is None else fwd(np.asarray(labels))
        res = create_super_volume(trainer, img, labels=lbl, **kwargs)
        with span("serve.finalize"):
            acc += inv(res["upsampled_image"]).astype(np.float64)
    with span("serve.finalize"):
        base["upsampled_image"] = np.clip(
            acc / len(variants), 0.0, 1.0).astype(np.float32)
    return base


def _one_volume(trainer, images, labels, *, alpha_range, use_original,
                downsample_steps, generate_inbetween_slices, pad_to_bucket,
                decode_batch, num_devices, latent_interp,
                readback_dtype) -> Dict[str, np.ndarray]:
    """``create_super_volume`` of one volume without test-time
    augmentation."""
    with span("serve.prep"):
        images = np.asarray(images, np.float32)
        check_vae_size(trainer._ae_model(), *images.shape[1:])
        alpha_range, downsample_steps = _alpha_grid(
            alpha_range, downsample_steps, generate_inbetween_slices)
        orig_images = images
        orig_num_slices = images.shape[0]
        remain = 0
        if downsample_steps is not None or generate_inbetween_slices:
            images, remain = kept_slice_grid(images, downsample_steps)

        kept = images[:, None]                       # [K, 1, H, W]
        needs_label_channel, decodes_labels = model_label_semantics(trainer)
        if needs_label_channel:
            lbl_in = make_kept_label_channel(
                images, labels, downsample_steps, remain,
                "create_super_volume")
            kept = np.concatenate(
                [kept, np.asarray(lbl_in, np.float32)[:, None]], axis=1)
        k_true = kept.shape[0]
        a_n = int(len(alpha_range))
        n_dev = int(num_devices or 1)
        k_pad = bucket_size(k_true) if pad_to_bucket else k_true
        # slice-axis sharding needs the kept count divisible by the mesh
        k_pad = -(-k_pad // n_dev) * n_dev
        kept = _pad_kept(kept, k_pad, latent_interp)

        if decode_batch == "auto":
            depth = getattr(getattr(trainer, "model_config", None), "depth",
                            32)
            # reconstructions and interpolants decode together: budget the
            # sum
            decode_batch = _auto_decode_batch(k_pad + (k_pad - 1) * a_n,
                                              kept.shape[2], kept.shape[3],
                                              depth)
        if n_dev > 1 and decode_batch is not None:
            # the budget is per device
            decode_batch = max(32, int(decode_batch) // n_dev)

    dev = trainer.device
    with span("serve.upload"):
        kept_t = torch.from_numpy(np.ascontiguousarray(kept)).to(dev)
        alphas_t = torch.from_numpy(alpha_range).to(dev)
    if getattr(trainer, "params_sr", None) is not None:
        vol = _combo_volume(trainer, kept_t, alphas_t, k_true, use_original,
                            decode_batch, latent_interp, decodes_labels,
                            n_dev)
    else:
        out = _get_core(trainer, decode_batch, latent_interp,
                        num_devices=n_dev)(
            kept_t, alphas_t, use_original=use_original, interleave=True)
        # valid prefix of the padded interleaved volume: the image plane,
        # and the decoded labels' plane of a MultiChannelAE
        planes = 2 if decodes_labels else 1
        vol = out["volume"][:(k_true - 1) * (a_n + 1) + 1, :planes]
    image, ids = _read_volume(vol, readback_dtype)
    with span("serve.finalize"):
        return _finalize_volume_outputs(
            image, ids, orig_images=orig_images, labels=labels,
            alpha_range=alpha_range, downsample_steps=downsample_steps,
            generate_inbetween_slices=generate_inbetween_slices,
            remain=remain, k_true=k_true, orig_num_slices=orig_num_slices)


def _finalize_volume_outputs(new_volume: np.ndarray,
                             dec_labels: Optional[np.ndarray], *,
                             orig_images, labels, alpha_range,
                             downsample_steps, generate_inbetween_slices,
                             remain: int, k_true: int,
                             orig_num_slices: int) -> Dict[str, np.ndarray]:
    """Host post-processing shared by create_super_volume(s): verbatim
    tail re-append, pred_alphas, and the labels: decoded by a
    MultiChannelAE, else riding along. ``new_volume`` is the image plane
    [S', H, W] as read back, clamped on the device, with the kept-slice
    padding stripped (S' = (k_true-1)*(len(alpha_range)+1)+1), and is
    returned as given unless a tail is re-appended; ``dec_labels`` the
    decoded class ids [S', H, W], or None. The tail, which the device
    never saw, is the one part clamped here."""
    a_n = int(len(alpha_range))
    if generate_inbetween_slices and remain != 0:
        new_volume = np.concatenate(
            [new_volume, np.clip(orig_images[-remain:], 0.0, 1.0)], axis=0)
        if dec_labels is not None:
            # the verbatim tail keeps its input labels (zeros without)
            tail = (np.asarray(labels, np.float32)[-remain:]
                    if labels is not None
                    else np.zeros((remain,) + dec_labels.shape[1:],
                                  dec_labels.dtype))
            dec_labels = np.concatenate([dec_labels, tail], axis=0)
    k1 = k_true - 1
    pred_alphas = np.repeat(alpha_range[None, :], k1, axis=0).reshape(-1)

    # labels ride along by nearest-neighbour z lookup (round half up)
    upsampled_labels = None
    if dec_labels is not None:
        # integer class ids; rint guards a float round trip
        out_dtype = (np.asarray(labels).dtype if labels is not None
                     else np.int32)
        upsampled_labels = np.rint(dec_labels).astype(out_dtype)
    elif labels is not None:
        labels = np.asarray(labels)
        n_out = new_volume.shape[0]
        if n_out == labels.shape[0]:
            upsampled_labels = labels
        else:
            a_n1 = a_n + 1
            ds_eff = float(downsample_steps) if (
                downsample_steps is not None) else 1.0
            synth_len = (k_true - 1) * a_n1 + 1
            pos = np.arange(min(synth_len, n_out),
                            dtype=np.float64) * ds_eff / a_n1
            if n_out > synth_len:  # re-appended tail (remain slices)
                pos = np.concatenate([
                    pos,
                    np.arange(orig_num_slices - (n_out - synth_len),
                              orig_num_slices, dtype=np.float64)])
            src = np.clip(np.floor(pos + 0.5).astype(np.int64), 0,
                          labels.shape[0] - 1)
            upsampled_labels = labels[src]
    return {"upsampled_image": new_volume,
            "upsampled_labels": upsampled_labels,
            "pred_alphas": pred_alphas}


def create_super_volumes(trainer, images_list: Sequence,
                         alpha_range=None,
                         use_original: bool = False,
                         downsample_steps: Optional[int] = None,
                         generate_inbetween_slices: bool = False,
                         labels_list: Optional[Sequence] = None,
                         pad_to_bucket: bool = True,
                         decode_batch="auto",
                         num_devices: int = 1,
                         tta: Optional[str] = None,
                         latent_interp: str = "linear",
                         readback_dtype: Optional[str] = None
                         ) -> list:
    """Batched multi-volume synthesis: the results of one
    ``create_super_volume`` call per volume, but same-shaped volumes run
    as one flat [B*K] batch per shape group (at most ``max_b`` volumes a
    call, from ``_batch_volume_cap``). TTA and lone volumes take the
    per-volume path, and so does the AE+CAISR combo. Returns per-volume
    result dicts in input order."""
    _check_serving_options(trainer, readback_dtype)
    images_list = list(images_list)
    if labels_list is None:
        labels_list = [None] * len(images_list)
    labels_list = list(labels_list)
    if len(labels_list) != len(images_list):
        raise ValueError(
            f"labels_list has {len(labels_list)} entries for "
            f"{len(images_list)} volumes")
    kwargs = dict(alpha_range=alpha_range, use_original=use_original,
                  downsample_steps=downsample_steps,
                  generate_inbetween_slices=generate_inbetween_slices,
                  pad_to_bucket=pad_to_bucket, decode_batch=decode_batch,
                  num_devices=num_devices, tta=tta,
                  latent_interp=latent_interp,
                  readback_dtype=readback_dtype)
    with span("serve.request", volumes=len(images_list)):
        if (tta or getattr(trainer, "params_sr", None) is not None
                or len(images_list) <= 1):
            return [create_super_volume(trainer, img, labels=lbl, **kwargs)
                    for img, lbl in zip(images_list, labels_list)]
        # the work runs in a callee, so that its host buffers are freed
        # inside the request's span
        return _batched_volumes(trainer, images_list, labels_list, kwargs,
                                **kwargs)


def _batched_volumes(trainer, images_list: list, labels_list: list,
                     kwargs: Dict, *, alpha_range, use_original,
                     downsample_steps, generate_inbetween_slices,
                     pad_to_bucket, decode_batch, num_devices, tta,
                     latent_interp, readback_dtype) -> list:
    """``create_super_volumes`` of two or more volumes without TTA or the
    combo, ``kwargs`` its options for the per-volume path."""
    with span("serve.prep"):
        alpha_range, downsample_steps = _alpha_grid(
            alpha_range, downsample_steps, generate_inbetween_slices)
        a_n = int(len(alpha_range))
        needs_label_channel, decodes_labels = model_label_semantics(trainer)
        planes = 2 if decodes_labels else 1
        depth = getattr(getattr(trainer, "model_config", None), "depth", 32)

        # per-volume prep mirrors create_super_volume exactly
        groups: Dict[tuple, list] = {}
        for idx, (img, lbl) in enumerate(zip(images_list, labels_list)):
            img = np.asarray(img, np.float32)
            check_vae_size(trainer._ae_model(), *img.shape[1:])
            orig_images, orig_num_slices, remain = img, img.shape[0], 0
            if downsample_steps is not None or generate_inbetween_slices:
                img, remain = kept_slice_grid(img, downsample_steps)
            kept = img[:, None]
            if needs_label_channel:
                lbl_in = make_kept_label_channel(
                    img, lbl, downsample_steps, remain,
                    "create_super_volumes")
                kept = np.concatenate(
                    [kept, np.asarray(lbl_in, np.float32)[:, None]], axis=1)
            k_true = kept.shape[0]
            k_pad = bucket_size(k_true) if pad_to_bucket else k_true
            kept = _pad_kept(kept, k_pad, latent_interp)
            meta = dict(index=idx, orig_images=orig_images, labels=lbl,
                        remain=remain, k_true=k_true,
                        orig_num_slices=orig_num_slices)
            groups.setdefault(kept.shape, []).append((kept, meta))

    results: list = [None] * len(images_list)
    dev = trainer.device
    with span("serve.upload"):
        alphas_dev = torch.from_numpy(alpha_range).to(dev)
    nd = int(num_devices or 1)
    for (k_pad, c, h, w), items in groups.items():
        if nd > 1 and len(items) == 1:
            # a lone shape under a mesh: the slice-sharded single path
            meta = items[0][1]
            results[meta["index"]] = create_super_volume(
                trainer, images_list[meta["index"]], labels=meta["labels"],
                **kwargs)
            continue
        db, max_b = _batch_volume_cap(k_pad, a_n, h, w, depth,
                                      decode_batch=decode_batch, channels=c)
        if nd > 1:
            # the volume axis sharded over the mesh: chunks of a multiple
            # of N volumes (the budget is per device), the last one padded
            # by repeating its final volume
            synth = _get_core(trainer, db, latent_interp, num_devices=nd,
                              batched=True)
            b = min(max_b, -(-len(items) // nd)) * nd
        else:
            core = _get_core(trainer, db, latent_interp)
            b = max_b
        for start in range(0, len(items), b):
            part = items[start:start + b]
            with span("serve.upload"):
                stacked = [it[0] for it in part]
                if nd > 1:
                    stacked += [part[-1][0]] * (b - len(part))
                stack = torch.from_numpy(np.stack(stacked)).to(dev)
            if nd > 1:
                vols = synth(stack, alphas_dev, use_original)[:len(part)]
            else:
                vols = core(stack, alphas_dev, use_original=use_original,
                            interleave=True)["volume"]
            for j, (_kept, meta) in enumerate(part):
                # each volume's valid prefix in a block of its own
                s_j = (meta["k_true"] - 1) * (a_n + 1) + 1
                image, ids = _read_volume(vols[j, :s_j, :planes],
                                          readback_dtype)
                with span("serve.finalize"):
                    results[meta["index"]] = _finalize_volume_outputs(
                        image, ids, orig_images=meta["orig_images"],
                        labels=meta["labels"], alpha_range=alpha_range,
                        downsample_steps=downsample_steps,
                        generate_inbetween_slices=generate_inbetween_slices,
                        remain=meta["remain"], k_true=meta["k_true"],
                        orig_num_slices=meta["orig_num_slices"])
    return results


# ---------------------------------------------------------------------------
# conventional interpolation baselines (SimpleITK ExpandImageFilter port),
# numpy + scipy on the host, copied from the JAX package
# ---------------------------------------------------------------------------

def _interp_weights(method: str, frac: np.ndarray):
    """Per-output-sample kernel taps (offsets, weights) for 1-D z interp."""
    if method == "nearest":
        # ITK nearest rounds half UP (Math::RoundHalfIntegerUp);
        # np.round's banker's rounding would pick the earlier slice at
        # exact midpoints (every odd output slice for even factors)
        offs = np.floor(frac + 0.5).astype(np.int64)
        return offs[:, None], np.ones((len(frac), 1), np.float32)
    if method == "linear":
        w1 = frac.astype(np.float32)
        return (np.stack([np.zeros_like(w1, dtype=np.int64),
                          np.ones_like(w1, dtype=np.int64)], 1),
                np.stack([1.0 - w1, w1], 1))
    if method == "bspline":
        # cubic B-spline kernel taps at offsets -1..2
        t = frac.astype(np.float64)
        offs = np.stack([np.full_like(t, o, dtype=np.float64)
                         for o in (-1, 0, 1, 2)], 1)
        x = np.abs(offs - t[:, None])
        w = np.where(x < 1, (4 - 6 * x ** 2 + 3 * x ** 3) / 6.0,
                     np.where(x < 2, ((2 - x) ** 3) / 6.0, 0.0))
        return offs.astype(np.int64), (w / w.sum(1, keepdims=True)).astype(np.float32)
    if method == "lanczos":
        radius = 3
        t = frac.astype(np.float64)
        offs = np.stack([np.full_like(t, o)
                         for o in range(-radius + 1, radius + 1)], 1)
        x = offs - t[:, None]

        def lanczos(x):
            x = np.where(x == 0, 1e-12, x)
            px = np.pi * x
            return np.where(np.abs(x) < radius,
                            radius * np.sin(px) * np.sin(px / radius)
                            / (px * px), 0.0)

        w = lanczos(x)
        w = w / w.sum(1, keepdims=True)
        return offs.astype(np.int64), w.astype(np.float32)
    raise ValueError(f"unknown interpolation method {method!r}")


def simple_interpolation(volume: np.ndarray, expand_factor: int,
                         method: str = "lanczos") -> np.ndarray:
    """z-axis expansion by integer factor, matching SimpleITK's
    ExpandImageFilter geometry: output slice j samples input coordinate
    j / expand_factor (reference: evaluate/common.py:114-118).
    Runs as one vectorised gather+weighted-sum.
    """
    s = volume.shape[0]
    out_n = s * expand_factor
    pos = np.arange(out_n, dtype=np.float64) / expand_factor
    base = np.floor(pos).astype(np.int64)
    frac = pos - base
    offs, w = _interp_weights(method, frac)
    if method == "bspline":
        # interpolating B-spline needs the coefficient prefilter
        # (ITK's BSplineInterpolateImageFunction computes spline
        # coefficients first); applying the smoothing kernel to raw
        # samples would blur on-grid slices instead of reproducing them
        import scipy.ndimage
        volume = scipy.ndimage.spline_filter1d(
            np.asarray(volume, np.float64), order=3, axis=0,
            mode="mirror")
    idx = np.clip(base[:, None] + offs, 0, s - 1)     # [out_n, taps]
    taps = volume[idx]                                # [out_n, taps, H, W]
    out = np.einsum("ot,othw->ohw", w.astype(volume.dtype), taps)
    return out.astype(np.float32)


def create_simple_interpolation(images: np.ndarray, expand_factor: int,
                                method: str = "lanczos",
                                generate_inbetween_slices: bool = False
                                ) -> np.ndarray:
    """Conventional-interpolation baseline with the reference's
    strip-tails-then-upsample semantics (evaluate/common.py:74-111)."""
    images = np.asarray(images, np.float32)
    if not generate_inbetween_slices:
        return simple_interpolation(images, expand_factor, method)
    orig = images
    orig_n = images.shape[0]
    ds = int(expand_factor)
    last_slice_id = np.arange(orig_n)[::ds][-1]
    remain = (orig_n - 1) % ds
    kept = images[:-remain] if remain else images
    kept = kept[::ds]
    up = simple_interpolation(kept, ds, method)
    up = up[:last_slice_id + 1]
    if remain > 0:
        up = np.concatenate([up, orig[-remain:]], axis=0)
    return up


def apply_blur_filter(img: np.ndarray, sigma: float = 1.0) -> np.ndarray:
    """Per-slice 2-D gaussian post-blur of an SR volume
    (reference: evaluate/common.py:121-127 apply_blur_filter /
    generate_blurred_sr_image — one vectorised call, not a slice loop)."""
    import scipy.ndimage
    return scipy.ndimage.gaussian_filter(
        np.asarray(img, np.float32), (0.0, sigma, sigma))


def rescale_volume(vol: np.ndarray) -> np.ndarray:
    """Min-max rescale + clamp (reference: evaluate/common.py:129-133
    rescale_tensor)."""
    vol = np.asarray(vol, np.float32)
    rng = vol.max() - vol.min()
    if rng == 0:
        return np.zeros_like(vol)
    return np.clip((vol - vol.min()) / rng, 0.0, 1.0)
