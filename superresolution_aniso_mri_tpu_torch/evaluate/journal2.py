"""Journal-2 per-paper figure layouts (port of
``superresolution_aniso_mri_tpu/evaluate/journal2.py``, the same pages).

Reference: evaluate/plots/journal2/* (~1,100 LoC of paper-specific
compositions). The generic figure families live in evaluate/plots.py;
this module reproduces the SPECIFIC page layouts of the second journal
paper so a reference user finds the same figures:

  * three-panel SSIM/PSNR/VIF vs upsampling factor with conventional
    baselines (compare_upsampling_factors.py:46-89 upsample_compare);
  * three-panel lambda sweep with twin recon/synth axes
    (compare_upsampling_factors.py:91-160 lambda_compare);
  * methods-comparison page: rows = methods with interleaved
    difference-map rows (evaluate_qualitatively.py:50-130
    compare_methods_slices);
  * interpolation sequence with zoom insets
    (synthesis.py:15-92 plot_inset/plot_interpol_sequence);
  * per-method reconstruction page (reconstructions.py:29-130);
  * 2x3 recon+synth metric boxplot page (metric_boxplots.py:26-182);
  * LAX views page: methods x long-axis cuts of 4-D cardiac volumes
    (cardiac_lax_view.py:13-60 generate_lax_views).

All layouts are re-derived compositions over this framework's data
structures (no torch/cv2); every entry point returns the figure and
optionally saves it.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np

from .plots import _plt

METRIC_TITLES = (("ssim", "SSIM"), ("psnr", "PSNR"), ("vif", "VIF"))


def _finish(fig, plt, save_path, dpi=150):
    fig.tight_layout()
    if save_path:
        fig.savefig(save_path, dpi=dpi, bbox_inches="tight")
        plt.close(fig)
    return fig


def upsample_factor_page(model_results: Dict[int, Dict[str, Sequence[float]]],
                         conventional: Optional[Dict[str, Dict[int, Dict[str, Sequence[float]]]]] = None,
                         metric_suffix: str = "_synth",
                         save_path: Optional[str] = None):
    """Three panels (SSIM | PSNR | VIF), metric vs upsampling factor K:
    the model as orange errorbars + line, conventional methods as extra
    series (reference layout: subplot2grid 2x6, three rowspan-2 panels).

    ``model_results``: {K: {metric: per-volume values}};
    ``conventional``: {method: {K: {metric: values}}}.
    """
    plt = _plt(save_path)
    fig, axes = plt.subplots(1, 3, figsize=(16, 5))
    factors = sorted(model_results)
    xs = [str(k) for k in factors]
    for ax, (mkey, title) in zip(axes, METRIC_TITLES):
        key = mkey + metric_suffix
        means = [float(np.nanmean(model_results[k][key])) for k in factors]
        errs = [float(np.nanstd(model_results[k][key])) for k in factors]
        ax.errorbar(xs, means, yerr=errs, c="orange", fmt="o",
                    capsize=10, markersize=10, label="AISR")
        ax.plot(xs, means, c="orange")
        for method, per_k in (conventional or {}).items():
            # a baseline evaluated at a subset of the model's factors
            # plots NaN (gap) there instead of KeyError-ing the page
            cm = [float(np.nanmean(per_k[k][key]))
                  if k in per_k and key in per_k[k] else float("nan")
                  for k in factors]
            ce = [float(np.nanstd(per_k[k][key]))
                  if k in per_k and key in per_k[k] else float("nan")
                  for k in factors]
            eb = ax.errorbar(xs, cm, yerr=ce, fmt="s", capsize=6,
                             label=method)
            # keep the dashed line in the SAME prop-cycle color as the
            # markers (a bare plot() would consume the next color)
            ax.plot(xs, cm, linestyle="--", c=eb.lines[0].get_color())
        ax.set_title(title)
        ax.set_xlabel("Upsampling factor (K)")
        ax.yaxis.grid(True)
        if mkey == "ssim":
            ax.legend(loc="lower left")
    return _finish(fig, plt, save_path)


def lambda_page(lambda_results: Dict[float, Dict[str, Sequence[float]]],
                save_path: Optional[str] = None):
    """Three panels, each with twin y-axes: reconstruction metric
    (orange, left) and synthesis metric (cornflowerblue, right) vs the
    synthesis-loss weight lambda (reference: lambda_compare).

    ``lambda_results``: {lambda: {'ssim': .., 'ssim_synth': .., ...}}.
    """
    plt = _plt(save_path)
    fig, axes = plt.subplots(1, 3, figsize=(16, 5))
    lams = sorted(lambda_results)
    xs = [str(v) for v in lams]
    for ax, (mkey, title) in zip(axes, METRIC_TITLES):
        rec = [float(np.nanmean(lambda_results[v][mkey])) for v in lams]
        rec_e = [float(np.nanstd(lambda_results[v][mkey])) for v in lams]
        syn = [float(np.nanmean(lambda_results[v][mkey + "_synth"]))
               for v in lams]
        syn_e = [float(np.nanstd(lambda_results[v][mkey + "_synth"]))
                 for v in lams]
        ax.errorbar(xs, rec, yerr=rec_e, c="orange", fmt="o", capsize=6,
                    label="Reconstructed")
        ax.plot(xs, rec, c="orange")
        ax.set_ylabel("Reconstructed")
        ax.set_xlabel(r"$\lambda$")
        twin = ax.twinx()
        twin.errorbar(xs, syn, yerr=syn_e, c="cornflowerblue", fmt="o",
                      capsize=6, label="Synthesized")
        twin.plot(xs, syn, c="cornflowerblue")
        twin.set_ylabel("Synthesized")
        ax.set_title(title)
        ax.yaxis.grid(True)
    return _finish(fig, plt, save_path)


def methods_comparison_page(reference_vol: np.ndarray,
                            method_vols: Dict[str, np.ndarray],
                            slice_ids: Optional[Sequence[int]] = None,
                            with_diff_rows: bool = True,
                            save_path: Optional[str] = None):
    """Qualitative page: reference row on top, then per method an image
    row and (optionally) an interleaved |difference| row with a shared
    scale (reference: evaluate_qualitatively.py compare_methods_slices +
    get_diff_images)."""
    plt = _plt(save_path)
    # method volumes may be shorter than the reference (e.g. tail-less
    # synthesis) — restrict the default slice picks to the common range
    s = min([reference_vol.shape[0]]
            + [v.shape[0] for v in method_vols.values()])
    if slice_ids is None:
        slice_ids = np.linspace(1, s - 2, 4).astype(int)
    n_rows = 1 + len(method_vols) * (2 if with_diff_rows else 1)
    fig, axes = plt.subplots(n_rows, len(slice_ids), squeeze=False,
                             figsize=(2.4 * len(slice_ids), 2.4 * n_rows))
    # materialize each |diff| volume ONCE (shared-scale max + row plots;
    # recomputing per row doubled the dominant array work)
    diffs = ({name: np.abs(v[:s] - reference_vol[:s])
              for name, v in method_vols.items()}
             if with_diff_rows else {})
    diff_max = (max(float(d.max()) for d in diffs.values())
                if diffs else 1.0)

    def _row(r, vol, label, cmap="gray", vmax=1.0):
        for c, sid in enumerate(slice_ids):
            axes[r, c].imshow(vol[sid], cmap=cmap, vmin=0, vmax=vmax)
            axes[r, c].set_xticks([]), axes[r, c].set_yticks([])
        axes[r, 0].set_ylabel(label, fontsize=9)

    _row(0, reference_vol, "reference")
    r = 1
    for name, vol in method_vols.items():
        _row(r, vol, name)
        r += 1
        if with_diff_rows:
            _row(r, diffs[name], f"|Δ| {name}", cmap="magma",
                 vmax=max(diff_max, 1e-6))
            r += 1
    return _finish(fig, plt, save_path)


def interpol_sequence_page(slice_from: np.ndarray,
                           interpolants: np.ndarray,
                           slice_to: np.ndarray,
                           inset: Optional[Sequence[int]] = None,
                           save_path: Optional[str] = None):
    """One row: endpoint, the interpolation sequence, endpoint — each
    panel with a zoom inset of ``inset=(y0, y1, x0, x1)`` (reference:
    synthesis.py:15-92 plot_inset/plot_interpol_sequence)."""
    plt = _plt(save_path)
    panels = [("from", slice_from)] + \
        [(f"α={i + 1}/{len(interpolants) + 1}", im)
         for i, im in enumerate(interpolants)] + [("to", slice_to)]
    fig, axes = plt.subplots(1, len(panels),
                             figsize=(2.4 * len(panels), 2.8))
    h, w = slice_from.shape[:2]
    if inset is None:
        inset = (h // 3, 2 * h // 3, w // 3, 2 * w // 3)
    y0, y1, x0, x1 = inset
    for ax, (title, im) in zip(np.atleast_1d(axes), panels):
        im2 = im[..., 0] if im.ndim == 3 else im
        ax.imshow(im2, cmap="gray", vmin=0, vmax=1)
        ax.set_title(title, fontsize=9)
        ax.axis("off")
        # zoom inset in the lower-right corner
        axins = ax.inset_axes([0.55, 0.0, 0.45, 0.45])
        axins.imshow(im2[y0:y1, x0:x1], cmap="gray", vmin=0, vmax=1)
        axins.set_xticks([]), axins.set_yticks([])
        for sp in axins.spines.values():
            sp.set_color("yellow")
    return _finish(fig, plt, save_path)


def reconstruction_page(reference_vol: np.ndarray,
                        method_vols: Dict[str, np.ndarray],
                        slice_ids: Optional[Sequence[int]] = None,
                        save_path: Optional[str] = None):
    """Per-method reconstruction rows against the reference row
    (reference: reconstructions.py:29-130 plot_separate/grid)."""
    return methods_comparison_page(reference_vol, method_vols,
                                   slice_ids=slice_ids,
                                   with_diff_rows=False,
                                   save_path=save_path)


def boxplot_page(results_per_method: Dict[str, Dict[str, Sequence[float]]],
                 save_path: Optional[str] = None):
    """2x3 page: top row recon SSIM/PSNR/VIF, bottom row synthesized —
    one box per method per panel (reference: metric_boxplots.py:26-182
    make_boxplots)."""
    plt = _plt(save_path)
    methods = list(results_per_method)
    fig, axes = plt.subplots(2, 3, figsize=(15, 8))
    for row, suffix, label in ((0, "", "reconstructed"),
                               (1, "_synth", "synthesized")):
        for col, (mkey, title) in enumerate(METRIC_TITLES):
            ax = axes[row, col]
            key = mkey + suffix
            data = [np.asarray(results_per_method[m].get(key, [np.nan]))
                    for m in methods]
            try:
                ax.boxplot(data, tick_labels=methods, widths=0.5)
            except TypeError:
                ax.boxplot(data, labels=methods, widths=0.5)
            ax.set_title(f"{title} ({label})", fontsize=10)
            ax.tick_params(axis="x", rotation=30, labelsize=8)
            ax.yaxis.grid(True)
    return _finish(fig, plt, save_path)


def cardiac_lax_page(method_vols4d: Dict[str, np.ndarray],
                     frame: int = 0,
                     positions: Optional[Sequence[int]] = None,
                     save_path: Optional[str] = None):
    """LAX-view page for 4-D cardiac volumes: rows = methods (reference
    first when present), columns = long-axis cuts through the
    short-axis stack (reference: cardiac_lax_view.py:13-60
    generate_lax_views, which reslices [t,z,y,x] along y)."""
    plt = _plt(save_path)
    vols = {name: (v[frame] if v.ndim == 4 else v)
            for name, v in method_vols4d.items()}
    # cut positions must be valid for EVERY volume (methods can differ
    # in y-extent) — derive them from the smallest
    min_y = min(v.shape[1] for v in vols.values())
    if positions is None:
        positions = np.linspace(min_y * 0.35, min_y * 0.65,
                                3).astype(int)
    else:
        positions = np.clip(np.asarray(positions, int), 0, min_y - 1)
    fig, axes = plt.subplots(len(vols), len(positions), squeeze=False,
                             figsize=(3.0 * len(positions),
                                      2.2 * len(vols)))
    for r, (name, vol) in enumerate(vols.items()):
        for c, p in enumerate(positions):
            lax = vol[:, p, :]  # [z, x] long-axis cut
            axes[r, c].imshow(lax, cmap="gray", vmin=0, vmax=1,
                              aspect="auto", origin="lower")
            axes[r, c].set_xticks([]), axes[r, c].set_yticks([])
        axes[r, 0].set_ylabel(name, fontsize=9)
    return _finish(fig, plt, save_path)
