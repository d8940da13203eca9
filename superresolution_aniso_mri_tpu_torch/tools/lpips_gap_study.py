"""Bound the fallback-LPIPS gap with a controlled distortion study.

Port of the JAX package's ``tools/lpips_gap_study.py``. Over a suite of
graded MRI-typical distortions (blur, Gaussian / Rician noise, ghosting,
through-plane down-up interpolation, gamma, bias field) it
rank-correlates the LPIPS distance in use (``lpips_weights_info``:
``converted``, ``lin_converted_vgg_random`` or ``random``) and,
with ``--enc_npz``, the encoder-perceptual artifact's distance against
reference-grade full-reference metrics (1 - MS-SSIM, 1 - VIF) and
against plain MSE.

Interpretation contract:
  * high corr(lpips, msssim/vif) -> the distance orders distortions like
    a perceptual metric does (a usable training signal);
  * corr(lpips, ...) ~ corr(mse, ...) -> the features add nothing beyond
    a pixel loss;
  * per-severity monotonicity: within each distortion family the
    distance must increase with severity or it cannot shape training.

The suite, the slices and the tables are numpy, as in JAX; the distances
run on the device, the 16 distortions of a slice in one call of each
metric (``score_suite``). Usage:

    python -m superresolution_aniso_mri_tpu_torch.cli lpips-gap-study \\
        [--n_slices 12] [--size 128] [--enc_npz weights/perceptual_enc.npz] \\
        [--json_out lpips_gap.json] [--device cpu]
"""
from __future__ import annotations

import argparse
import json
from typing import Dict, List, Optional

import numpy as np
import torch
from scipy.ndimage import gaussian_filter, zoom
from scipy.stats import spearmanr

from ..data.synthetic import (add_rician_noise, make_anatomy3d_volume,
                              make_cardiac4d_volume)
from ..device import resolve_device
from ..ops.lpips import get_lpips_params, lpips_distance, lpips_weights_info
from ..ops.metrics import msssim_volume, vif_volume
from ..ops.perceptual import enc_lpips_distance, load_enc_perceptual


# ---------------------------------------------------------------------------
# distortion suite — graded severities, MRI-typical artifact families
# ---------------------------------------------------------------------------

def _downup(img: np.ndarray, factor: int, order: int) -> np.ndarray:
    """Through-plane-style artifact: decimate rows, interpolate back
    (the exact failure mode super-resolution exists to fix)."""
    lo = img[::factor]
    up = zoom(lo, (img.shape[0] / lo.shape[0], 1.0), order=order)
    return up[: img.shape[0]]


def _bias_field(img: np.ndarray, amp: float, rs) -> np.ndarray:
    field = gaussian_filter(rs.randn(*img.shape), img.shape[0] / 4.0)
    field = field / (np.abs(field).max() + 1e-8)
    return img * (1.0 + amp * field)


def distortion_suite(rs):
    """[(name, family, severity_rank, fn)] — severity_rank orders
    members WITHIN a family for the monotonicity check. The functions
    draw from ``rs`` when they are applied, in suite order."""

    def ghost(img, alpha):
        sh = np.roll(img, img.shape[1] // 3, axis=1)
        return (1 - alpha) * img + alpha * sh

    def rician(img, s):
        return add_rician_noise(img, s, seed=int(rs.randint(2 ** 31)))

    return [
        ("blur0.5", "blur", 0, lambda x: gaussian_filter(x, 0.5)),
        ("blur1.0", "blur", 1, lambda x: gaussian_filter(x, 1.0)),
        ("blur2.0", "blur", 2, lambda x: gaussian_filter(x, 2.0)),
        ("noise0.01", "noise", 0, lambda x: x + rs.randn(*x.shape) * 0.01),
        ("noise0.03", "noise", 1, lambda x: x + rs.randn(*x.shape) * 0.03),
        ("noise0.07", "noise", 2, lambda x: x + rs.randn(*x.shape) * 0.07),
        ("rician0.03", "rician", 0, lambda x: rician(x, 0.03)),
        ("rician0.07", "rician", 1, lambda x: rician(x, 0.07)),
        ("ghost0.05", "ghost", 0, lambda x: ghost(x, 0.05)),
        ("ghost0.15", "ghost", 1, lambda x: ghost(x, 0.15)),
        ("downup2lin", "downup", 0, lambda x: _downup(x, 2, 1)),
        ("downup4lin", "downup", 1, lambda x: _downup(x, 4, 1)),
        ("downup2nn", "downup_nn", 0, lambda x: _downup(x, 2, 0)),
        # gamma up/down are different distortions, not graded severities
        # of one family — keep them out of the monotonicity check
        ("gamma0.7", "gamma_dn", 0, lambda x: np.clip(x, 0, 1) ** 0.7),
        ("gamma1.4", "gamma_up", 0, lambda x: np.clip(x, 0, 1) ** 1.4),
        ("bias0.3", "bias", 0, lambda x: _bias_field(x, 0.3, rs)),
    ]


def reference_slices(n_slices: int, size: int, seed_base: int = 0):
    """Mixed brain-anatomy + cardiac phantom slices, [0,1] floats.

    ``seed_base`` shifts every phantom seed so a FIT set
    (``fit_perceptual_head.py``, seed_base=1000) is anatomy-disjoint
    from this study's evaluation set (seed_base=0)."""
    out = []
    i = 0
    while len(out) < n_slices:
        if i % 2 == 0:
            vol = make_anatomy3d_volume(size=size, num_slices=9,
                                        seed=100 + seed_base + i).image
            out.append(np.asarray(vol[4], np.float32))
        else:
            v4 = make_cardiac4d_volume(size=size, num_slices=7,
                                       num_frames=2,
                                       seed=200 + seed_base + i)
            out.append(np.asarray(v4[0, 3], np.float32))
        i += 1
    return out


def distorted(sl: np.ndarray, suite) -> np.ndarray:
    """[D, H, W] float32: every distortion of the suite applied to
    ``sl`` in order, clipped to the training range [0, 1] (MS-SSIM is
    scored at data_range 1 and VIF quantizes to the [0,1]->uint8 grid,
    so over-range values would saturate those references)."""
    return np.stack([np.clip(fn(sl), 0.0, 1.0).astype(np.float32)
                     for _, _, _, fn in suite])


def msssim_levels(size: int) -> int:
    """The largest dyadic pyramid a ``size``² slice supports with the
    7-pixel window (``msssim_volume``'s guard), at most 5."""
    return min(5, int(np.log2(size / 7)) + 1)


def spearman(a, b) -> float:
    return float(spearmanr(a, b).statistic)


def pairwise_agreement(a, b) -> float:
    """Fraction of distortion pairs ordered the same way (2AFC proxy)."""
    a, b = np.asarray(a), np.asarray(b)
    n = len(a)
    agree = tot = 0
    for i in range(n):
        for j in range(i + 1, n):
            if a[i] == a[j] or b[i] == b[j]:
                continue
            tot += 1
            agree += int((a[i] > a[j]) == (b[i] > b[j]))
    return agree / max(tot, 1)


def score_suite(sl: np.ndarray, dists: np.ndarray, params: Dict,
                enc_params: Optional[Dict], levels: int,
                device) -> Dict[str, List[float]]:
    """The per-pair distances of one reference slice ``sl`` [H, W]
    against its distortions ``dists`` [D, H, W]: ``lpips``, ``msssim``
    (1 - MS-SSIM), ``vif`` (1 - VIF), ``mse`` and, with ``enc_params``,
    ``enc`` — each a list of D floats. One call of each metric on the
    device scores the D pairs."""
    ref = torch.from_numpy(np.ascontiguousarray(sl)).to(device)
    dis = torch.from_numpy(np.ascontiguousarray(dists)).to(device)
    refs = ref.expand_as(dis).contiguous()
    in0, in1 = refs[:, None], dis[:, None]
    out = {"lpips": lpips_distance(params, in0, in1),
           "msssim": msssim_volume(refs, dis, levels=levels),
           "vif": vif_volume(refs, dis)}
    if enc_params is not None:
        out["enc"] = enc_lpips_distance(enc_params, in0, in1)
    res = {k: [float(x) for x in v.detach().cpu().numpy()]
           for k, v in out.items()}
    # 1 - x in float64, as the JAX tool takes it from the float32 score
    for k in ("msssim", "vif"):
        res[k] = [1.0 - x for x in res[k]]
    res["mse"] = [float(np.mean((sl - d) ** 2)) for d in dists]
    return res


def run_study(n_slices: int = 12, size: int = 128, seed: int = 0,
              enc_npz: str = None, device=None):
    """``enc_npz``: optionally also score the encoder-backbone
    perceptual metric (``ops/perceptual.py``, the artifact built by
    ``fit-perceptual-head``) on the same held-out suite — the acceptance
    gate for replacing the random-VGG fallback. The distances run on
    ``device`` (None: the CUDA device)."""
    dev = resolve_device(device)
    enc_params = load_enc_perceptual(enc_npz, dev) if enc_npz else None

    rs = np.random.RandomState(seed)
    suite = distortion_suite(rs)
    slices = reference_slices(n_slices, size)
    params = get_lpips_params(device=dev)
    info = lpips_weights_info()
    levels = msssim_levels(size)

    names = [n for n, _, _, _ in suite]
    per_slice = {"lpips": [], "msssim": [], "vif": [], "mse": []}
    if enc_params is not None:
        per_slice["enc"] = []
    for sl in slices:
        d = score_suite(sl, distorted(sl, suite), params, enc_params,
                        levels, dev)
        for k in per_slice:
            per_slice[k].append(d[k])

    rows = {k: np.asarray(v) for k, v in per_slice.items()}  # [S, D]

    def corr_stats(xa, xb, fn):
        vals = [fn(xa[s], xb[s]) for s in range(len(slices))]
        return float(np.mean(vals)), float(np.std(vals))

    result = {
        "lpips_mode": info.get("mode"),
        "n_slices": n_slices, "size": size,
        "distortions": names,
        "spearman": {}, "pairwise_agreement": {},
        "monotonic_families": {},
    }
    srcs = ["lpips", "mse"] + (["enc"] if enc_params is not None else [])
    for target in ("msssim", "vif"):
        for src in srcs:
            m, s = corr_stats(rows[src], rows[target], spearman)
            result["spearman"][f"{src}_vs_{target}"] = {
                "mean": round(m, 4), "std": round(s, 4)}
            m, s = corr_stats(rows[src], rows[target], pairwise_agreement)
            result["pairwise_agreement"][f"{src}_vs_{target}"] = {
                "mean": round(m, 4), "std": round(s, 4)}
    m, s = corr_stats(rows["lpips"], rows["mse"], spearman)
    result["spearman"]["lpips_vs_mse"] = {"mean": round(m, 4),
                                          "std": round(s, 4)}
    if enc_params is not None:
        m, s = corr_stats(rows["enc"], rows["mse"], spearman)
        result["spearman"]["enc_vs_mse"] = {"mean": round(m, 4),
                                            "std": round(s, 4)}
        result["enc_meta"] = enc_params.get("meta", {})

    # within-family severity monotonicity of the distances
    fams = {}
    for idx, (_, fam, rank, _) in enumerate(suite):
        fams.setdefault(fam, []).append((rank, idx))
    for fam, members in fams.items():
        if len(members) < 2:
            continue
        members.sort()
        idxs = [i for _, i in members]
        mono = [bool(np.all(np.diff(rows["lpips"][s][idxs]) > 0))
                for s in range(len(slices))]
        result["monotonic_families"][fam] = round(float(np.mean(mono)), 3)
        if enc_params is not None:
            mono_e = [bool(np.all(np.diff(rows["enc"][s][idxs]) > 0))
                      for s in range(len(slices))]
            result.setdefault("monotonic_families_enc", {})[fam] = (
                round(float(np.mean(mono_e)), 3))
    return result


def main(argv=None):
    """The ``lpips-gap-study`` command; returns the study's dict."""
    p = argparse.ArgumentParser(
        description="Rank-correlate the LPIPS fallback (and an encoder-"
                    "perceptual artifact) on a distortion suite")
    p.add_argument("--n_slices", type=int, default=12)
    p.add_argument("--size", type=int, default=128)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--json_out", type=str, default=None)
    p.add_argument("--enc_npz", type=str, default=None,
                   help="also gate the encoder-backbone perceptual "
                        "metric (weights/perceptual_enc.npz) on the "
                        "held-out suite")
    p.add_argument("--device", type=str, default=None,
                   help="device of the distances (default: cuda)")
    args = p.parse_args(argv)

    r = run_study(args.n_slices, args.size, args.seed,
                  enc_npz=args.enc_npz, device=args.device)
    print(f"\n=== fallback-LPIPS gap study (mode={r['lpips_mode']}, "
          f"{r['n_slices']} slices @ {r['size']}^2, "
          f"{len(r['distortions'])} distortions) ===")
    print(f"{'pair':>18} | {'spearman':>14} | {'2AFC agree':>12}")
    for k in r["spearman"]:
        sp = r["spearman"][k]
        pa = r["pairwise_agreement"].get(k)
        pa_s = f"{pa['mean']:.3f}" if pa else "-"
        print(f"{k:>18} | {sp['mean']:6.3f} ±{sp['std']:5.3f} | {pa_s:>12}")
    print("severity-monotone fraction per family "
          "(fallback LPIPS increases with severity):")
    for fam, frac in r["monotonic_families"].items():
        print(f"  {fam:>10}: {frac:.2f}")
    if "monotonic_families_enc" in r:
        print("severity-monotone fraction per family (encoder metric):")
        for fam, frac in r["monotonic_families_enc"].items():
            print(f"  {fam:>10}: {frac:.2f}")
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(r, f, indent=1)
        print(f"wrote {args.json_out}")
    return r
