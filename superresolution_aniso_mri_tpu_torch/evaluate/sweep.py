"""Batched epoch evaluation for checkpoint sweeps (``--batched``).

Port of ``superresolution_aniso_mri_tpu/evaluate/sweep.py``. Per chunk
of same-shaped validation volumes, one batched synthesis
(``infer.make_batched_synthesizer``) and the per-slice SSIM / PSNR /
VIF / MSE of every volume of the chunk at once; the host applies the
synth and valid slice masks and averages. The per-slice SSIM of the
chunk's ``[B, S, H, W]`` stack is ONE call of
``ops.cuda_kernels.ssim_volume_fused`` on the flattened ``[B·S, H, W]``
stack: one kernel launch per chunk on the card. (The JAX sweep computes
the same per-slice SSIM with the plain ``ssim_volume``, of which the
kernel is the port.)

Volumes whose slice count leaves a remainder ((S-1) % ds != 0) have
their tail slices copied verbatim by synthesis; this evaluator and
``create_hr_images`` both score only the model-generated region.

``prepare_sweep_batches`` builds the padded shape-group stacks ONCE and
``evaluate_prepared`` re-scores them per checkpoint: only the weights
change between epochs.
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Optional

import numpy as np
import torch

from ..device import f32_exact
from ..infer.latent_taps import latent_interp_cache_token
from ..infer.super_volume import (_DECODE_ACT_BUDGET_BYTES,
                                  _auto_decode_batch, bucket_size,
                                  kept_slice_grid, make_batched_synthesizer,
                                  make_kept_label_channel,
                                  model_label_semantics)
from ..ops.cuda_kernels import ssim_volume_fused
from ..ops.metrics import psnr_volume, synth_slice_mask, vif_volume
from ..utils.profiling import span
from .metrics_driver import IdUniquifier


def make_sweep_evaluator(model, decode_batch: Optional[int] = None,
                         latent_interp: str = "linear"):
    """evaluate(kept [B,K,C,H,W], hr [B,S,H,W], alphas [A]) → per-slice
    metric stacks {'ssim','psnr','vif','sq'}, each [B, min(S,
    (K-1)(A+1)+1)], on the tensors' device. ``decode_batch`` bounds
    per-volume decoder activations like create_super_volume's auto
    path."""
    synthesize = make_batched_synthesizer(model, decode_batch,
                                          latent_interp=latent_interp)

    def evaluate(kept: torch.Tensor, hr: torch.Tensor,
                 alphas: torch.Tensor) -> Dict[str, torch.Tensor]:
        vols = synthesize(kept, alphas)[:, :, 0]            # [B, S', H, W]
        n = min(vols.shape[1], hr.shape[1])
        r, u = hr[:, :n].contiguous(), vols[:, :n].to(torch.float32)
        b, _, h, w = r.shape
        win = 7 if min(h, w) >= 8 else 5
        with torch.inference_mode(), f32_exact():
            with span("score.ssim"):
                ssim = ssim_volume_fused(r.reshape(b * n, h, w),
                                         u.reshape(b * n, h, w), 1.0, win)
            with span("score.psnr"):
                psnr = psnr_volume(r, u, 1.0)
            with span("score.vif"):
                vif = vif_volume(r, u)
            return {"ssim": ssim.view(b, n), "psnr": psnr, "vif": vif,
                    "sq": ((r - u) ** 2).mean(dim=(2, 3))}

    return evaluate


def _get_evaluator(trainer, decode_batch: Optional[int] = None,
                   latent_interp: str = "linear"):
    """The sweep evaluator of ``trainer``'s model, cached on the trainer
    beside its synthesis cores."""
    key = ("sweep", decode_batch, latent_interp_cache_token(latent_interp))
    cache = trainer.synth_cache
    if key not in cache:
        with span("build.core"):
            cache[key] = make_sweep_evaluator(trainer._ae_model(),
                                              decode_batch, latent_interp)
    return cache[key]


def prepare_sweep_batches(trainer, volumes: Iterable,
                          downsample_steps: int,
                          alpha_range=None) -> Dict:
    """Group/pad/stack the validation volumes once for repeated scoring.

    Returns an opaque dict for ``evaluate_prepared``: a list of
    (kept_stack, hr_stack, meta) chunks whose size bounds the in-flight
    decoder activations under the same budget as create_super_volume's
    auto decode path (model depth included). Stacks are host numpy;
    each evaluate_prepared call uploads them."""
    if alpha_range is None:
        alpha_range = np.linspace(0, 1, downsample_steps + 1)[1:-1]
    a_n = len(alpha_range)
    ds = int(downsample_steps)
    if a_n + 1 != ds:
        # interleaved-output stride is a_n+1; HR slice positions only
        # align when that equals the downsample stride
        raise ValueError(
            f"len(alpha_range)={a_n} must be downsample_steps-1={ds - 1} "
            "so synthesized slices align with the HR grid")

    # colors>=2 encoders take an image+label input channel pair — ride
    # the volume's labels along the kept grid (zeros when absent)
    needs_label_channel, _ = model_label_semantics(trainer)
    depth = getattr(getattr(trainer, "model_config", None), "depth", 32)

    groups: Dict[tuple, List] = {}
    frame_counts: Dict[str, int] = {}
    uniq = IdUniquifier()
    for vol in volumes:
        hr_full = np.asarray(
            vol.image_hr if vol.image_hr is not None else vol.image,
            np.float32)
        img_full = np.asarray(vol.image, np.float32)
        lbl_full = (np.asarray(vol.labels, np.float32)
                    if getattr(vol, "labels", None) is not None else None)
        if lbl_full is not None and lbl_full.shape != img_full.shape:
            lbl_full = None
        pid = uniq.take(vol.patient_id)
        # 4D cardiac volumes score frame by frame
        if img_full.ndim == 4:
            frames = [(f"{pid}@{t}", img_full[t], hr_full[t],
                       None if lbl_full is None else lbl_full[t])
                      for t in range(img_full.shape[0])]
            frame_counts[pid] = img_full.shape[0]
        else:
            frames = [(pid, img_full, hr_full, lbl_full)]
        for pid, img, hr, lbl in frames:
            kept, remain = kept_slice_grid(img, ds)
            if needs_label_channel:
                klb = make_kept_label_channel(kept, lbl, ds, remain,
                                              "evaluate_volumes_batched")
                kept = np.stack([kept, klb], axis=1)     # [K, 2, H, W]
            else:
                kept = kept[:, None]                     # [K, 1, H, W]
            k_true = kept.shape[0]
            k_pad = bucket_size(k_true)
            n_out = (k_pad - 1) * (a_n + 1) + 1
            # edge-replicated padding: multi-tap boundary taps read the
            # clamped edge latent, as create_super_volume pads
            kept_p = np.empty((k_pad,) + kept.shape[1:], np.float32)
            kept_p[:k_true] = kept
            kept_p[k_true:] = kept[-1]
            hr_p = np.zeros((n_out,) + hr.shape[1:], np.float32)
            n_valid = min((k_true - 1) * (a_n + 1) + 1, hr.shape[0])
            hr_p[:n_valid] = hr[:n_valid]
            key = (k_pad, img.shape[1], img.shape[2])
            groups.setdefault(key, []).append((pid, kept_p, hr_p, n_valid))

    chunks = []
    for key, items in groups.items():
        k_pad, h, w = key
        n_dec = k_pad + (k_pad - 1) * a_n
        decode_batch = _auto_decode_batch(n_dec, h, w, depth)
        in_flight = n_dec if decode_batch is None else decode_batch
        per_vol = in_flight * h * w * max(depth, 32) * 4 * 4
        max_b = max(1, int(_DECODE_ACT_BUDGET_BYTES // max(per_vol, 1)))
        for start in range(0, len(items), max_b):
            part = items[start:start + max_b]
            chunks.append({
                "kept": np.stack([it[1] for it in part]),
                "hr": np.stack([it[2] for it in part]),
                "meta": [(it[0], it[3]) for it in part],
                "decode_batch": decode_batch,
            })
    return {"chunks": chunks, "frame_counts": frame_counts,
            "alphas": np.asarray(alpha_range, np.float32), "ds": ds}


def evaluate_prepared(trainer, prep: Dict,
                      latent_interp: str = "linear") -> Dict[str, Dict]:
    """Score prepared batches against the trainer's CURRENT weights on
    its device. Returns per-frame entries (``pid@t`` keys for 4D
    volumes)."""
    with span("score.request",
              volumes=sum(len(c["meta"]) for c in prep["chunks"])):
        ds = prep["ds"]
        dev = trainer.device
        alphas = torch.from_numpy(prep["alphas"]).to(dev)
        results: Dict[str, Dict] = {}
        for chunk in prep["chunks"]:
            evaluator = _get_evaluator(trainer, chunk["decode_batch"],
                                       latent_interp)
            with span("score.upload"):
                kept = torch.from_numpy(chunk["kept"]).to(dev)
                hr = torch.from_numpy(chunk["hr"]).to(dev)
            per_slice = evaluator(kept, hr, alphas)
            with span("score.readback"):
                per_slice = {k: v.cpu().numpy() for k, v in per_slice.items()}
            with span("score.means"):
                for j, (pid, n_valid) in enumerate(chunk["meta"]):
                    valid = np.zeros(per_slice["ssim"].shape[1], bool)
                    valid[:n_valid] = True
                    synth = synth_slice_mask(per_slice["ssim"].shape[1], ds,
                                             conv_interpol=False) & valid
                    m = {}
                    for name in ("ssim", "psnr", "vif"):
                        vals = per_slice[name][j]
                        # non-finite per-slice values (NaN VIF on uniform
                        # slices, inf PSNR on exact copies) drop out, like
                        # masked_mean
                        m[name] = _finite_mean(vals[valid])
                        m[name + "_synth"] = _finite_mean(vals[synth])
                    m["mse"] = float(np.mean(per_slice["sq"][j][valid]))
                    results[pid] = m
        return results


def evaluate_volumes_batched(trainer, volumes: Iterable,
                             downsample_steps: int,
                             alpha_range=None,
                             per_frame: bool = False,
                             latent_interp: str = "linear"
                             ) -> Dict[str, Dict]:
    """Score a dataset of volumes against the trainer's current weights,
    one batched synthesis and one SSIM launch per chunk. Returns
    {patient_id: metrics} with the create_hr_images metric keys;
    ``per_frame=True`` keeps 4D volumes' per-frame entries (``pid@t``)."""
    prep = prepare_sweep_batches(trainer, volumes, downsample_steps,
                                 alpha_range)
    results = evaluate_prepared(trainer, prep, latent_interp)
    if not per_frame:
        for pat, n_frames in prep["frame_counts"].items():
            frames = [results.pop(f"{pat}@{t}") for t in range(n_frames)]
            results[pat] = {k: float(np.mean([f[k] for f in frames]))
                            for k in frames[0]}
    return results


def _finite_mean(vals: np.ndarray) -> float:
    """Host-side twin of ops.masked_mean's semantics (non-finite entries
    dropped, NaN when nothing remains)."""
    vals = vals[np.isfinite(vals)]
    return float(np.mean(vals)) if vals.size else float("nan")
