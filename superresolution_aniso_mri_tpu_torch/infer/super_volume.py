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

Not ported in this slice (each raises): ``num_devices > 1``, the
AE+CAISR combo (``trainer.params_sr``), multichannel/VAE models and the
packed decoder (``packed=True``).
"""
from __future__ import annotations

from functools import partial
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ..device import f32_exact
from ..models import VanillaACAI
from ..ops.losses import (LANCZOS3_OFFSETS, catmull_rom_weights,
                          lanczos3_weights)
from .latent_taps import (fitted_tap_weights, fitted_table_path,
                          is_fitted_mode, latent_interp_cache_token,
                          load_latent_taps)

LATENT_INTERP_MODES = ("linear", "cubic", "lanczos3", "fitted")
_LATENT_TAP_OFFSETS = {"cubic": (-1, 0, 1, 2), "lanczos3": LANCZOS3_OFFSETS}
READBACK_DTYPES = (None, "float32", "bfloat16")

_NOT_PORTED = "not ported to the PyTorch package yet (ROADMAP.md, {item})"


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
    takes [image, label] input planes; only the (not yet ported)
    MultiChannelAE decodes class ids."""
    colors = int(getattr(getattr(trainer, "model_config", None),
                         "colors", 1) or 1)
    return colors >= 2, False


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


def make_synthesis_core(model, decode_batch: Optional[int] = None,
                        packed: bool = False,
                        latent_interp: str = "linear"):
    """core(kept [K,C,H,W] or [B,K,C,H,W], alphas [A], use_original,
    interleave) → {'recon', 'interp'[, 'volume']}, with a leading volume
    axis on every output when the input had one.

    Multi-tap schemes read z[clip(pair + offset, 0, K-1)]: callers that
    pad the kept stack must edge-replicate (create_super_volume does)."""
    if packed:
        raise NotImplementedError(
            "packed=True: " + _NOT_PORTED.format(item="A11"))
    if not isinstance(model, VanillaACAI):
        raise NotImplementedError(
            f"{type(model).__name__}: only VanillaACAI serves; "
            "multichannel/VAE models are "
            + _NOT_PORTED.format(item="S4"))
    cfg = model.config
    if is_fitted_mode(latent_interp):
        table = load_latent_taps(fitted_table_path(latent_interp))
        tap_offsets = tuple(int(o) for o in table["offsets"])
        tap_weight_fn = partial(fitted_tap_weights, table["alphas"],
                                table["weights"])
    elif latent_interp in _LATENT_TAP_OFFSETS:
        tap_offsets = _LATENT_TAP_OFFSETS[latent_interp]
        tap_weight_fn = partial(latent_tap_weights, latent_interp)
    elif latent_interp == "linear":
        tap_offsets = tap_weight_fn = None
    else:
        raise ValueError(f"latent_interp must be one of "
                         f"{LATENT_INTERP_MODES} (fitted as "
                         f"'fitted:<table path>'), got {latent_interp!r}")

    @torch.inference_mode()
    def core(kept: torch.Tensor, alphas: torch.Tensor,
             use_original: bool = False,
             interleave: bool = False) -> Dict[str, torch.Tensor]:
        with f32_exact():
            return _core(kept, alphas, use_original, interleave)

    def _core(kept, alphas, use_original, interleave):
        single = kept.ndim == 4
        if single:
            kept = kept[None]
        b, k = kept.shape[0], kept.shape[1]

        # in-plane sizes not divisible by the encoder's total stride
        # come back smaller from the decoder: reflect-pad, crop back
        h, w = kept.shape[3], kept.shape[4]
        div = 2 ** cfg.scales
        ph, pw = (-h) % div, (-w) % div
        if ph or pw:
            flat = torch.nn.functional.pad(kept.flatten(0, 1), (0, pw, 0, ph),
                                           mode="reflect")
            kept = flat.unflatten(0, (b, k))

        z = _chunked_call_pervol(model.encode, kept, decode_batch)
        # the latent carries the compute dtype through the mix
        z = z.to(cfg.dtype)
        a_n = alphas.shape[0]
        if tap_offsets is not None:
            # weights in float32, then the mix in the latent's dtype
            wts = tap_weight_fn(alphas).to(z.dtype)       # [A, n_taps]
            pair = torch.arange(k - 1, device=z.device)
            z_mix = torch.zeros((b, k - 1, a_n) + z.shape[2:], dtype=z.dtype,
                                device=z.device)
            for ti, off in enumerate(tap_offsets):
                tap = z.index_select(1, (pair + off).clamp(0, k - 1))
                z_mix = (z_mix + wts[:, ti].view(1, 1, a_n, 1, 1, 1)
                         * tap[:, :, None])
        else:
            a = alphas.to(z.dtype).view(1, 1, a_n, 1, 1, 1)
            one = torch.ones((), dtype=z.dtype, device=z.device)
            z_mix = a * z[:, 1:, None] + (one - a) * z[:, :-1, None]
        k1 = k - 1
        z_flat = z_mix.flatten(1, 2)                       # [B, k1*A, ...]
        if use_original:
            dec = _chunked_call_pervol(model.decode, z_flat, decode_batch)
            recon = kept
            interp = dec.unflatten(1, (k1, a_n))
        else:
            dec = _chunked_call_pervol(model.decode,
                                       torch.cat([z, z_flat], dim=1),
                                       decode_batch)
            recon = dec[:, :k]
            interp = dec[:, k:].unflatten(1, (k1, a_n))
        if ph or pw:
            recon = recon[..., :h, :w]
            interp = interp[..., :h, :w]
        out = {"recon": recon, "interp": interp}
        if interleave:
            out["volume"] = clip_with_label_channel(
                interleave_volume(recon, interp), False)
        if single:
            out = {key: val[0] for key, val in out.items()}
        return out

    return core


def _get_core(trainer, decode_batch: Optional[int], latent_interp: str):
    """The synthesis core for ``trainer``'s model, cached on the trainer
    per (decode_batch, latent_interp table version)."""
    key = (decode_batch, latent_interp_cache_token(latent_interp))
    cache = trainer.synth_cache
    if key not in cache:
        cache[key] = make_synthesis_core(trainer._ae_model(), decode_batch,
                                         latent_interp=latent_interp)
    return cache[key]


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


def _check_serving_options(trainer, num_devices, readback_dtype) -> None:
    if num_devices and int(num_devices) > 1:
        raise NotImplementedError(
            "num_devices > 1: multi-GPU serving is "
            + _NOT_PORTED.format(item="S5"))
    if getattr(trainer, "params_sr", None) is not None:
        raise NotImplementedError(
            "trainer.params_sr: the AE+CAISR combo is "
            + _NOT_PORTED.format(item="S3"))
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


def _readback(vol: torch.Tensor, readback_dtype) -> np.ndarray:
    """Device → host float32 numpy; 'bfloat16' casts on the device and
    widens on the host (half the transfer)."""
    if readback_dtype == "bfloat16":
        return vol.to(torch.bfloat16).cpu().to(torch.float32).numpy()
    return vol.to(torch.float32).cpu().numpy()


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
    _check_serving_options(trainer, num_devices, readback_dtype)
    if tta:
        variants = _tta_variants(tta)
        kwargs = dict(alpha_range=alpha_range, use_original=use_original,
                      downsample_steps=downsample_steps,
                      generate_inbetween_slices=generate_inbetween_slices,
                      pad_to_bucket=pad_to_bucket,
                      decode_batch=decode_batch, num_devices=num_devices,
                      tta=None, latent_interp=latent_interp,
                      readback_dtype=readback_dtype)
        base = create_super_volume(trainer, images, labels=labels, **kwargs)
        acc = base["upsampled_image"].astype(np.float64).copy()
        for fwd, inv in variants[1:]:
            res = create_super_volume(
                trainer, fwd(np.asarray(images, np.float32)),
                labels=None if labels is None else fwd(np.asarray(labels)),
                **kwargs)
            acc += inv(res["upsampled_image"]).astype(np.float64)
        base["upsampled_image"] = np.clip(
            acc / len(variants), 0.0, 1.0).astype(np.float32)
        return base

    images = np.asarray(images, np.float32)
    alpha_range, downsample_steps = _alpha_grid(
        alpha_range, downsample_steps, generate_inbetween_slices)
    orig_images = images
    orig_num_slices = images.shape[0]
    remain = 0
    if downsample_steps is not None or generate_inbetween_slices:
        images, remain = kept_slice_grid(images, downsample_steps)

    kept = images[:, None]                       # [K, 1, H, W]
    needs_label_channel, _ = model_label_semantics(trainer)
    if needs_label_channel:
        lbl_in = make_kept_label_channel(
            images, labels, downsample_steps, remain, "create_super_volume")
        kept = np.concatenate(
            [kept, np.asarray(lbl_in, np.float32)[:, None]], axis=1)
    k_true = kept.shape[0]
    a_n = int(len(alpha_range))
    k_pad = bucket_size(k_true) if pad_to_bucket else k_true
    kept = _pad_kept(kept, k_pad, latent_interp)

    if decode_batch == "auto":
        depth = getattr(getattr(trainer, "model_config", None), "depth", 32)
        # reconstructions and interpolants decode together: budget the sum
        decode_batch = _auto_decode_batch(k_pad + (k_pad - 1) * a_n,
                                          kept.shape[2], kept.shape[3], depth)

    core = _get_core(trainer, decode_batch, latent_interp)
    dev = trainer.device
    out = core(torch.from_numpy(np.ascontiguousarray(kept)).to(dev),
               torch.from_numpy(alpha_range).to(dev),
               use_original=use_original, interleave=True)
    # valid prefix of the padded interleaved volume, image channel
    vol = out["volume"][:(k_true - 1) * (a_n + 1) + 1, 0]
    return _finalize_volume_outputs(
        _readback(vol, readback_dtype), orig_images=orig_images,
        labels=labels, alpha_range=alpha_range,
        downsample_steps=downsample_steps,
        generate_inbetween_slices=generate_inbetween_slices,
        remain=remain, k_true=k_true, orig_num_slices=orig_num_slices)


def _finalize_volume_outputs(new_volume: np.ndarray, *, orig_images, labels,
                             alpha_range, downsample_steps,
                             generate_inbetween_slices, remain: int,
                             k_true: int,
                             orig_num_slices: int) -> Dict[str, np.ndarray]:
    """Host post-processing shared by create_super_volume(s): verbatim
    tail re-append, clamp, pred_alphas and the label ride-along.
    ``new_volume`` is the image channel [S', H, W] with the kept-slice
    padding stripped (S' = (k_true-1)*(len(alpha_range)+1)+1)."""
    a_n = int(len(alpha_range))
    if generate_inbetween_slices and remain != 0:
        new_volume = np.concatenate([new_volume, orig_images[-remain:]],
                                    axis=0)
    new_volume = np.clip(new_volume, 0.0, 1.0)
    k1 = k_true - 1
    pred_alphas = np.repeat(alpha_range[None, :], k1, axis=0).reshape(-1)

    # labels ride along by nearest-neighbour z lookup (round half up)
    upsampled_labels = None
    if labels is not None:
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
    per-volume path. Returns per-volume result dicts in input order."""
    _check_serving_options(trainer, num_devices, readback_dtype)
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
    if tta or len(images_list) <= 1:
        return [create_super_volume(trainer, img, labels=lbl, **kwargs)
                for img, lbl in zip(images_list, labels_list)]

    alpha_range, downsample_steps = _alpha_grid(
        alpha_range, downsample_steps, generate_inbetween_slices)
    a_n = int(len(alpha_range))
    needs_label_channel, _ = model_label_semantics(trainer)
    depth = getattr(getattr(trainer, "model_config", None), "depth", 32)

    # per-volume prep mirrors create_super_volume exactly
    groups: Dict[tuple, list] = {}
    for idx, (img, lbl) in enumerate(zip(images_list, labels_list)):
        img = np.asarray(img, np.float32)
        orig_images, orig_num_slices, remain = img, img.shape[0], 0
        if downsample_steps is not None or generate_inbetween_slices:
            img, remain = kept_slice_grid(img, downsample_steps)
        kept = img[:, None]
        if needs_label_channel:
            lbl_in = make_kept_label_channel(
                img, lbl, downsample_steps, remain, "create_super_volumes")
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
    alphas_dev = torch.from_numpy(alpha_range).to(dev)
    for (k_pad, c, h, w), items in groups.items():
        db, max_b = _batch_volume_cap(k_pad, a_n, h, w, depth,
                                      decode_batch=decode_batch, channels=c)
        core = _get_core(trainer, db, latent_interp)
        for start in range(0, len(items), max_b):
            part = items[start:start + max_b]
            stack = torch.from_numpy(np.stack([it[0] for it in part])).to(dev)
            vols = core(stack, alphas_dev, use_original=use_original,
                        interleave=True)["volume"]
            s_max = max((it[1]["k_true"] - 1) * (a_n + 1) + 1 for it in part)
            vols = _readback(vols[:, :s_max, 0], readback_dtype)
            for j, (_kept, meta) in enumerate(part):
                s_j = (meta["k_true"] - 1) * (a_n + 1) + 1
                results[meta["index"]] = _finalize_volume_outputs(
                    vols[j, :s_j], orig_images=meta["orig_images"],
                    labels=meta["labels"], alpha_range=alpha_range,
                    downsample_steps=downsample_steps,
                    generate_inbetween_slices=generate_inbetween_slices,
                    remain=meta["remain"], k_true=meta["k_true"],
                    orig_num_slices=meta["orig_num_slices"])
    return results
