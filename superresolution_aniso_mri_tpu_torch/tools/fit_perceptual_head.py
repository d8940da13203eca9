"""Build the encoder-backbone perceptual artifact
(``weights/perceptual_enc.npz``) from a trained experiment.

Port of the JAX package's ``tools/fit_perceptual_head.py``. The
backbone is the experiment's frozen SR encoder (``ops/perceptual.py``);
the tool fits the non-negative per-channel "lin" weights on a
2AFC-style ranking task over an anatomy-DISJOINT distortion set
(``lpips_gap_study``'s suite at seed_base=1000 — the gap study itself
evaluates at seed_base=0, so fit and gate never share a phantom), then
calibrates the overall scale so the mean distance matches the mean MSE
of the same pairs (a drop-in loss magnitude: the existing loss weights
and learning rates keep working). The oracle of the ranking fit is
1 - MS-SSIM.

The fit runs on the device: ``w = softplus(θ)``, the pairwise logistic
ranking loss, and the port's own Adam (``train/state.py::Optimizer``,
optax's ``adam`` in optax's order of operations, eps 1e-8), not
``torch.optim.Adam``, whose ``sqrt(ν) / sqrt(1 - β₂ᵗ)`` rounds
differently from optax's ``sqrt(ν / (1 - β₂ᵗ))``. The artifact loads in
both packages' ``load_enc_perceptual``. Usage:

    python -m superresolution_aniso_mri_tpu_torch.cli fit-perceptual-head \\
        --exper_dir <trained exper> [--model_nbr caisr] \\
        [--out weights/perceptual_enc.npz] [--lins uniform|fitted] \\
        [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import os
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..device import f32_exact, resolve_device
from ..models.convert import torch_to_flax
from ..ops.metrics import msssim_volume
from ..ops.perceptual import (_ENC_NPZ, enc_feature_diff_vectors,
                              enc_lpips_distance, enc_perceptual_params,
                              save_enc_perceptual, uniform_lins)
from ..train import get_trainer
from ..train.state import Optimizer
from .lpips_gap_study import (distorted, distortion_suite, msssim_levels,
                              reference_slices)


def harvest_encoder(exper_dir: str, model_nbr, device=None):
    """(AEConfig, encoder flax variables, model family) of a trained
    experiment directory (either package's): the ``enc`` subtree of the
    autoencoder (the ``ae`` of the acai and alpha families), with its
    BatchNorm statistics where it has them."""
    trainer = get_trainer(exper_dir, model_nbr=model_nbr, device=device)
    params, stats = torch_to_flax(trainer._ae_model().state_dict())
    if "enc" not in params:
        raise SystemExit(
            f"experiment {exper_dir} has no 'enc' subtree (model "
            f"{trainer.args.get('model')}) — the perceptual backbone "
            f"needs an Encoder-bearing family")
    variables = {"params": params["enc"]}
    if stats.get("enc"):
        variables["batch_stats"] = stats["enc"]
    return trainer.model_config, variables, trainer.args.get("model")


def _pair_batch(sl: np.ndarray, dists: np.ndarray, device):
    """(reference, distorted) as [D, 1, H, W] tensors on ``device``."""
    batch = torch.from_numpy(np.ascontiguousarray(dists)).to(device)[:, None]
    ref = torch.from_numpy(np.ascontiguousarray(sl)).to(device)
    return ref.expand_as(batch).contiguous(), batch


def build_fit_set(n_slices: int, size: int, seed_base: int = 1000,
                  device=None):
    """Per slice ``(slice, distortions [D, H, W], 1 - MS-SSIM oracle
    [D], MSE [D])``; the oracle of a slice's D pairs is one MS-SSIM call
    on ``device`` (None: the CUDA device)."""
    dev = resolve_device(device)
    rs = np.random.RandomState(7)
    suite = distortion_suite(rs)
    slices = reference_slices(n_slices, size, seed_base=seed_base)
    levels = msssim_levels(size)
    data = []
    for sl in slices:
        dists = distorted(sl, suite)
        ref, batch = _pair_batch(sl, dists, dev)
        ms = msssim_volume(ref[:, 0], batch[:, 0], levels=levels)
        oracle = [1.0 - float(m) for m in ms.cpu().numpy()]
        mses = [float(np.mean((sl - d) ** 2)) for d in dists]
        data.append((sl, dists, np.asarray(oracle), np.asarray(mses)))
    return data


def fit_lins(enc_params, data, iters: int = 400, lr: float = 0.05,
             margin: float = 0.005, seed: int = 0):
    """Non-negative lin weights via pairwise logistic ranking.

    For every within-slice distortion pair whose oracle severities
    differ by > margin, the weighted feature distance must order the
    pair the same way. Runs on the device of ``enc_params``. Returns
    (w [F] float32 numpy, fit diagnostics)."""
    dev = enc_params["lins"][0].device
    yi, yj, sign = [], [], []
    rows = []
    for sl, dists, oracle, _ in data:
        ref, batch = _pair_batch(sl, dists, dev)
        base = sum(len(r) for r in rows)
        rows.append(enc_feature_diff_vectors(enc_params, ref, batch))
        n = len(oracle)
        for i in range(n):
            for j in range(i + 1, n):
                if abs(oracle[i] - oracle[j]) <= margin:
                    continue
                yi.append(base + i)
                yj.append(base + j)
                sign.append(1.0 if oracle[i] > oracle[j] else -1.0)
    V = torch.cat(rows).detach()                     # [N, F]
    ii = torch.tensor(yi, dtype=torch.long, device=dev)
    jj = torch.tensor(yj, dtype=torch.long, device=dev)
    sg = torch.tensor(sign, dtype=torch.float32, device=dev)

    # parametrize w = softplus(theta): positivity without projection
    theta = torch.zeros(V.shape[1], dtype=torch.float32, device=dev)
    with f32_exact():
        # fixed logistic sharpness chosen from the raw distance scale
        d0 = (V @ F.softplus(theta)).cpu().numpy()
        with np.errstate(all="ignore"):
            scale = float(1.0 / (np.quantile(np.abs(d0), 0.9) + 1e-12))
        opt = Optimizer(lr)
        state = opt.init({"theta": theta})
        val = None
        for _ in range(iters):
            th = theta.detach().requires_grad_(True)
            d = V @ F.softplus(th)
            delta = (d[ii] - d[jj]) * sg
            val = F.softplus(-scale * delta).mean()
            (g,) = torch.autograd.grad(val, th)
            opt.step({"theta": theta}, {"theta": g}, state)
        w_t = F.softplus(theta)
        d = (V @ w_t).cpu().numpy()
    w = w_t.cpu().numpy().astype(np.float32)
    delta = (d[np.asarray(yi)] - d[np.asarray(yj)]) * np.asarray(sign)
    diag = {
        "pairs": int(len(sign)),
        "rank_accuracy": float(np.mean(delta > 0)),
        "final_loss": (float(val.detach()) if val is not None
                       else float("nan")),
    }
    return w, diag


def scale_calibration(enc_params, data) -> float:
    """The factor that makes the mean distance over the fit pairs equal
    the mean MSE of the same pairs (a drop-in loss magnitude)."""
    dev = enc_params["lins"][0].device
    dsum, msum = 0.0, 0.0
    for sl, dists, _, mses in data:
        ref, batch = _pair_batch(sl, dists, dev)
        d = enc_lpips_distance(enc_params, ref, batch).cpu().numpy()
        dsum += float(np.sum(d))
        msum += float(np.sum(mses))
    return msum / max(dsum, 1e-12)


def split_lins(w: np.ndarray, chans: List[int]) -> List[np.ndarray]:
    """The flat weight vector back into per-tap lins."""
    out, off = [], 0
    for c in chans:
        out.append(w[off:off + c])
        off += c
    return out


def main(argv=None) -> Tuple[Dict, List[np.ndarray]]:
    """The ``fit-perceptual-head`` command; returns (meta, lins) of the
    artifact it writes."""
    p = argparse.ArgumentParser(
        description="Fit the encoder-perceptual artifact from an experiment")
    p.add_argument("--exper_dir", required=True)
    p.add_argument("--model_nbr", default="caisr",
                   help="checkpoint to harvest (default: the min-val-"
                        "loss 'caisr' alias)")
    p.add_argument("--out", default=_ENC_NPZ)
    p.add_argument("--lins", choices=("uniform", "fitted"),
                   default="fitted")
    p.add_argument("--n_slices", type=int, default=12)
    p.add_argument("--size", type=int, default=128)
    p.add_argument("--iters", type=int, default=400)
    p.add_argument("--device", type=str, default=None,
                   help="device of the encoder and the fit (default: cuda)")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)

    cfg, variables, family = harvest_encoder(args.exper_dir,
                                             args.model_nbr, dev)
    print(f"[harvest] {family} encoder from {args.exper_dir} "
          f"(depth={cfg.depth}, scales={cfg.scales}, "
          f"bn={cfg.use_batchnorm})", flush=True)

    lins = uniform_lins(cfg)
    chans = [l.shape[0] for l in lins]
    params = enc_perceptual_params(cfg, variables, lins, device=dev)

    data = build_fit_set(args.n_slices, args.size, device=dev)
    diag = {"mode": "uniform"}
    if args.lins == "fitted":
        w, diag = fit_lins(params, data, iters=args.iters)
        diag["mode"] = "fitted"
        lins = split_lins(w, chans)
        params = enc_perceptual_params(cfg, variables, lins, device=dev)
        print(f"[fit] {diag['pairs']} ranking pairs, rank accuracy "
              f"{diag['rank_accuracy']:.3f}", flush=True)

    cal = scale_calibration(params, data)
    lins = [l * cal for l in lins]
    diag["scale_calibration"] = cal

    meta = {"source_exper": os.path.abspath(args.exper_dir),
            "source_family": family, "model_nbr": str(args.model_nbr),
            "fit": diag, "n_slices": args.n_slices, "size": args.size,
            "seed_base": 1000}
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    save_enc_perceptual(args.out, cfg, variables, lins, meta)
    print(f"[write] {args.out}")
    print(json.dumps(meta, indent=2))
    return meta, lins
