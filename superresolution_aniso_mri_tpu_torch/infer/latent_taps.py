"""Fitted per-alpha latent tap weights: a learned z-mixing scheme.

Port of ``superresolution_aniso_mri_tpu/infer/latent_taps.py``. The
synthesized latent is ``sum_t W[alpha, t] * z[clip(pair + offset_t)]``;
the analytic schemes (linear, cubic, lanczos3) are fixed tables of this
family. ``fit_latent_taps`` learns the ``[A, n_taps]`` table on the
validation split through the frozen decoder against the true in-between
slices, ``save_latent_taps`` writes it as ``{'offsets', 'alphas',
'weights'}`` (the JAX package's file), and it serves through
``latent_interp="fitted:<path>"``; rows are interpolated linearly in
alpha. The CLIs expand a bare ``fitted`` to the experiment's
``models/latent_taps.npz`` (``resolve_latent_interp``).
"""
from __future__ import annotations

import os
from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ..device import f32_exact
from ..ops.losses import LANCZOS3_OFFSETS, lanczos3_weights

# the default taps are lanczos3's support: radius 3 around the pair
DEFAULT_OFFSETS = LANCZOS3_OFFSETS

FITTED_PREFIX = "fitted"


def is_fitted_mode(mode: str) -> bool:
    return mode == FITTED_PREFIX or mode.startswith(FITTED_PREFIX + ":")


def fitted_table_path(mode: str) -> str:
    """'fitted:<path>' → path; bare 'fitted' needs a table path."""
    if ":" not in mode:
        raise ValueError(
            "latent_interp='fitted' needs a weight table: run the "
            "fit-latent-taps command on the experiment to create "
            "<exper>/models/latent_taps.npz, then pass 'fitted:<path>' "
            "(the CLIs expand bare 'fitted' to the experiment's table)")
    return mode.split(":", 1)[1]


def resolve_latent_interp(mode: str, exper_dir: Optional[str] = None) -> str:
    """Expand bare 'fitted' to 'fitted:<exper>/models/latent_taps.npz';
    other modes pass through untouched."""
    if mode != FITTED_PREFIX:
        return mode
    if not exper_dir:
        fitted_table_path(mode)  # raises with the how-to message
    path = os.path.join(exper_dir, "models", "latent_taps.npz")
    if not os.path.isfile(path):
        raise FileNotFoundError(
            f"latent_interp='fitted' but no weight table at {path} — run "
            f"`python -m superresolution_aniso_mri_tpu_torch.cli "
            f"fit-latent-taps --exper_dir {exper_dir}` first (fits the "
            f"tap weights on the validation split)")
    return f"{FITTED_PREFIX}:{path}"


def save_latent_taps(path: str, offsets: Sequence[int],
                     alphas: np.ndarray, weights: np.ndarray,
                     meta: Optional[Dict] = None) -> None:
    """Write the fitted table, adding the boundary rows of alpha 0 and 1
    (a delta on the pair taps 0 and 1) so that alphas outside the
    fitted grid interpolate toward the kept slices; ``meta`` entries go
    in as ``meta_<key>``."""
    offsets = np.asarray(offsets, np.int32)
    alphas = np.asarray(alphas, np.float32)
    weights = np.asarray(weights, np.float32)
    if weights.shape != (alphas.shape[0], offsets.shape[0]):
        raise ValueError(f"weights {weights.shape} != "
                         f"(n_alphas={alphas.shape[0]}, "
                         f"n_taps={offsets.shape[0]})")
    for tap_offset in (0, 1):
        if not np.any(offsets == tap_offset):
            raise ValueError(
                f"offsets {tuple(offsets)} must include the pair taps 0 "
                f"and 1 — the alpha-0/1 identity boundary rows place "
                f"their delta weight there")
    rows, wrows = [alphas], [weights]
    for boundary, tap_offset in ((0.0, 0), (1.0, 1)):
        if not np.any(np.isclose(alphas, boundary)):
            delta = np.zeros((1, offsets.shape[0]), np.float32)
            delta[0, int(np.where(offsets == tap_offset)[0][0])] = 1.0
            rows.append(np.array([boundary], np.float32))
            wrows.append(delta)
    alphas_full = np.concatenate(rows)
    weights_full = np.concatenate(wrows, axis=0)
    order = np.argsort(alphas_full)
    payload = {"offsets": offsets, "alphas": alphas_full[order],
               "weights": weights_full[order]}
    for k, v in (meta or {}).items():
        payload[f"meta_{k}"] = np.asarray(v)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **payload)
    os.replace(tmp, path)


def load_latent_taps(path: str) -> Dict[str, np.ndarray]:
    """Read a fitted table → {'offsets', 'alphas', 'weights', meta...}."""
    with np.load(path) as z:
        out = {k: z[k] for k in z.files}
    for k in ("offsets", "alphas", "weights"):
        if k not in out:
            raise ValueError(f"{path}: not a latent-taps table "
                             f"(missing '{k}')")
    if out["weights"].shape != (out["alphas"].shape[0],
                                out["offsets"].shape[0]):
        raise ValueError(f"{path}: weights {out['weights'].shape} "
                         f"inconsistent with alphas/offsets")
    if not np.all(np.diff(out["alphas"]) > 0):
        raise ValueError(f"{path}: alphas must be strictly ascending")
    return out


def latent_interp_cache_token(mode: str):
    """Cache-key component: 'fitted:<path>' also keys on the table
    file's mtime and size, so a refitted table is not served stale."""
    if is_fitted_mode(mode) and ":" in mode:
        path = fitted_table_path(mode)
        try:
            st = os.stat(path)
            return (mode, st.st_mtime_ns, st.st_size)
        except OSError:
            return (mode, None, None)
    return mode


def fitted_tap_weights(table_alphas, table_weights,
                       alphas: torch.Tensor) -> torch.Tensor:
    """[A] requested alphas → [A, n_taps] float32 rows, linearly
    interpolated in alpha from the table; alphas outside the table's
    range take its end rows (``jnp.interp`` semantics)."""
    grid = torch.as_tensor(np.asarray(table_alphas, np.float32),
                           device=alphas.device)
    w = torch.as_tensor(np.asarray(table_weights, np.float32),
                        device=alphas.device)
    a = alphas.to(torch.float32).clamp(grid[0], grid[-1])
    hi = torch.searchsorted(grid, a, right=True).clamp(1, len(grid) - 1)
    lo = hi - 1
    frac = ((a - grid[lo]) / (grid[hi] - grid[lo]))[:, None]
    return w[lo] + frac * (w[hi] - w[lo])


# ---------------------------------------------------------------------------
# fitting
# ---------------------------------------------------------------------------

_ENCODE_CHUNK = 64   # slices encoded at once while gathering the pairs


def _gather_pairs(trainer, volumes, downsample_steps: int,
                  offsets: Sequence[int]):
    """The fitting set of ``volumes`` (the validation split):
    (taps [P, n_taps, C, lh, lw], targets [P, A, H, W]) on the model's
    device. For every kept-slice pair of every 3-D volume (or frame of a
    4-D one), the edge-clamped neighbour latents and the TRUE slices at
    the in-between positions: the volume's ``image_hr`` when it has one,
    else its own removed slices. Pairs are stacked, so ragged in-plane
    shapes keep the dominant one and skip the rest with a warning."""
    from .super_volume import (kept_slice_grid, latent_encoder,
                               model_label_semantics, synthesis_model)

    if model_label_semantics(trainer)[0]:
        raise NotImplementedError(
            "fitted latent taps are wired for single-channel encoders; "
            "the multichannel (image+label input) family would need "
            "label-channel supervision in the fitting set")
    # the AE+CAISR combo fits through the SR model, which synthesizes
    model = synthesis_model(trainer)
    dev = next(model.parameters()).device
    ds = int(downsample_steps)
    div = 2 ** model.config.scales

    @torch.no_grad()
    def encode(kept: np.ndarray) -> torch.Tensor:
        # reflect-pad in-plane to the encoder's total stride, as the
        # synthesis core does; chunked, so a long volume never holds
        # every encoder activation at once
        x = torch.from_numpy(np.ascontiguousarray(kept[:, None])).to(dev)
        h, w = x.shape[2], x.shape[3]
        ph, pw = (-h) % div, (-w) % div
        if ph or pw:
            x = F.pad(x, (0, pw, 0, ph), mode="reflect")
        with f32_exact():
            return torch.cat([latent_encoder(model)(x[i:i + _ENCODE_CHUNK])
                              for i in range(0, x.shape[0], _ENCODE_CHUNK)])

    taps_by_shape: Dict[tuple, list] = {}
    tgt_by_shape: Dict[tuple, list] = {}
    for vol in volumes:
        img = np.asarray(vol.image, np.float32)
        hr = (np.asarray(vol.image_hr, np.float32)
              if getattr(vol, "image_hr", None) is not None else img)
        frames = img[None] if img.ndim == 3 else img
        hr_frames = hr[None] if hr.ndim == 3 else hr
        for img3d, hr3d in zip(frames, hr_frames):
            kept, _remain = kept_slice_grid(img3d, ds)
            k = kept.shape[0]
            if k < 2:
                continue
            z = encode(kept)
            pair = torch.arange(k - 1, device=dev)
            taps = torch.stack([z[(pair + o).clamp(0, k - 1)]
                                for o in offsets], dim=1)
            # the target of pair j at alpha index m-1 is HR slice j*ds + m
            idx = np.arange(k - 1)
            tgt = np.stack([hr3d[idx * ds + m] for m in range(1, ds)], axis=1)
            shape = img3d.shape[1:]
            taps_by_shape.setdefault(shape, []).append(taps)
            tgt_by_shape.setdefault(shape, []).append(tgt)
    if not taps_by_shape:
        raise ValueError("no kept-slice pairs in the fitting volumes")
    best = max(taps_by_shape,
               key=lambda s: sum(t.shape[0] for t in taps_by_shape[s]))
    if len(taps_by_shape) > 1:
        skipped = sorted(s for s in taps_by_shape if s != best)
        print(f"[fit_taps] WARNING: ragged in-plane shapes — fitting on "
              f"the dominant {best}, skipping volumes of {skipped}",
              flush=True)
    return (torch.cat(taps_by_shape[best]),
            torch.from_numpy(np.concatenate(tgt_by_shape[best])).to(dev))


def fit_latent_taps(trainer, volumes, downsample_steps: int, *,
                    steps: int = 300, lr: float = 0.02,
                    batch_pairs: int = 16, seed: int = 0,
                    offsets: Sequence[int] = DEFAULT_OFFSETS,
                    l2_to_init: float = 0.0,
                    holdout_frac: float = 0.2,
                    verbose: bool = False) -> Dict:
    """Fit the [A, n_taps] tap-weight table through the frozen decoder
    of ``trainer`` (a Trainer or ``ServingModel``; its SR model when one
    is loaded, as that one synthesizes) on the device its model lives
    on.

    Starts at the lanczos3 rows and runs Adam (optax's, the port's
    ``train/state.py`` optimizer) on the mean squared error of the
    decoded synthesized slices against the true in-between slices, over
    the kept-slice pairs of ``volumes``. The decoder runs in eval mode
    and only the table gets a gradient. A pair-level holdout
    (``holdout_frac``) is scored every ``steps // 20`` steps and the
    best-holdout table is returned, the analytic init always a
    candidate; ``l2_to_init`` adds ``lambda * ||W - W_lanczos3||^2``.
    The batches are drawn from ``np.random.RandomState(seed)`` in the
    JAX package's order, so both fits see the same pairs. Returns
    {'alphas', 'weights', 'offsets', 'loss_init', 'loss_final' (holdout
    MSEs), 'n_pairs', 'n_holdout'}; save with ``save_latent_taps``."""
    from ..train.state import Optimizer
    from .super_volume import synthesis_model

    ds = int(downsample_steps)
    if ds < 2:
        raise ValueError(f"downsample_steps must be >= 2 to have "
                         f"in-between slices, got {ds}")
    if tuple(offsets) != DEFAULT_OFFSETS:
        raise NotImplementedError(
            "custom tap offsets need a matching analytic init; only the "
            f"lanczos3 support {DEFAULT_OFFSETS} is wired up")
    alphas = np.linspace(0.0, 1.0, ds + 1)[1:-1].astype(np.float32)
    taps_all, tgt_all = _gather_pairs(trainer, volumes, ds, offsets)
    dev = taps_all.device
    w_init = lanczos3_weights(torch.from_numpy(alphas).to(dev))
    n_pairs = taps_all.shape[0]
    rng = np.random.RandomState(seed)
    if n_pairs >= 2 and holdout_frac > 0:
        perm = rng.permutation(n_pairs)
        n_hold = min(max(1, int(round(holdout_frac * n_pairs))),
                     n_pairs - 1)
        hold_idx, train_idx = perm[:n_hold], perm[n_hold:]
    else:
        hold_idx = train_idx = np.arange(n_pairs)

    def take(t, idx):
        return t[torch.as_tensor(idx, device=dev)]

    taps, targets = take(taps_all, train_idx), take(tgt_all, train_idx)
    taps_ho, tgt_ho = take(taps_all, hold_idx), take(tgt_all, hold_idx)
    model = synthesis_model(trainer)

    def pair_losses(w, tap_b, tgt_b):
        """[B] mean squared errors of the pairs' synthesized slices."""
        z_mix = torch.einsum("at,btchw->bachw", w, tap_b)
        out = model.decode(z_mix.flatten(0, 1))
        # the decoder gives the stride-padded size: crop like the core
        out = out[:, 0, :tgt_b.shape[2], :tgt_b.shape[3]]
        err = (out.unflatten(0, tgt_b.shape[:2]) - tgt_b) ** 2
        return err.mean(dim=(1, 2, 3))

    @torch.no_grad()
    def holdout_loss(w) -> float:
        """The exact holdout mean, in chunks of 64 pairs."""
        n = taps_ho.shape[0]
        with f32_exact():
            per_pair = torch.cat([pair_losses(w, taps_ho[i:i + 64],
                                              tgt_ho[i:i + 64])
                                  for i in range(0, n, 64)])
        return float(per_pair.sum() / n)

    opt = Optimizer(lr, momentum=0.9)
    w = w_init.clone()
    opt_state = opt.init({"w": w})
    loss_init = holdout_loss(w)
    best_w, best_loss = w.clone(), loss_init
    eval_every = max(1, steps // 20)
    b = min(batch_pairs, taps.shape[0])
    for i in range(steps):
        idx = torch.from_numpy(rng.randint(0, taps.shape[0], size=(b,))
                               ).to(dev, non_blocking=True)
        wv = w.detach().requires_grad_(True)
        with f32_exact():
            loss = pair_losses(wv, taps[idx], targets[idx]).mean()
            loss = loss + l2_to_init * ((wv - w_init) ** 2).sum()
            (grad,) = torch.autograd.grad(loss, [wv])
        opt.step({"w": w}, {"w": grad}, opt_state)
        if (i + 1) % eval_every == 0 or i == steps - 1:
            ho = holdout_loss(w)
            if ho < best_loss:
                best_w, best_loss = w.clone(), ho
            if verbose and (i % max(1, steps // 10) < eval_every
                            or i == steps - 1):
                print(f"[fit_taps] step {i}: train batch mse "
                      f"{float(loss.detach()):.6f}  holdout mse {ho:.6f}",
                      flush=True)
    return {"alphas": alphas,
            "weights": best_w.cpu().numpy().astype(np.float32),
            "offsets": np.asarray(offsets, np.int32),
            "loss_init": loss_init, "loss_final": best_loss,
            "n_pairs": n_pairs, "n_holdout": int(len(hold_idx))}
