"""Fitted per-alpha latent tap weights: serving side.

Port of ``superresolution_aniso_mri_tpu/infer/latent_taps.py:32-162``
(everything but the fitting, ROADMAP item 14). A table ``{'offsets',
'alphas', 'weights'}`` written by the reference's ``save_latent_taps``
serves through ``latent_interp="fitted:<path>"``; rows are interpolated
linearly in alpha. The CLIs expand a bare ``fitted`` to the
experiment's ``models/latent_taps.npz`` (``resolve_latent_interp``).
"""
from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch

FITTED_PREFIX = "fitted"


def is_fitted_mode(mode: str) -> bool:
    return mode == FITTED_PREFIX or mode.startswith(FITTED_PREFIX + ":")


def fitted_table_path(mode: str) -> str:
    """'fitted:<path>' → path; bare 'fitted' needs a table path."""
    if ":" not in mode:
        raise ValueError(
            "latent_interp='fitted' needs a weight table: pass "
            "'fitted:<path to latent_taps.npz>' (fit one with the JAX "
            "package's fit_latent_taps.py)")
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
            f"latent_interp='fitted' but no weight table at {path} — fit "
            f"one with the JAX package's fit_latent_taps.py first (the "
            f"port's fit-latent-taps is ROADMAP item 14)")
    return f"{FITTED_PREFIX}:{path}"


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
