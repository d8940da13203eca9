"""Publication-style result plots (port of
``superresolution_aniso_mri_tpu/evaluate/plots.py``, the same figures).
matplotlib is imported inside each function, so the package imports
without it.

Reference: evaluate/plots/** (12 scripts, ~1900 LoC of paper figures for
SPIE2021 / the journal paper). Condensed into a reusable API: metric
boxplots across methods, qualitative slice-comparison grids, long-axis
view strips and Bland-Altman scatter.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np


def _plt(save_path):
    import matplotlib
    if save_path:
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def metric_boxplots(results_per_method: Dict[str, Dict[str, Sequence[float]]],
                    metrics=("ssim_synth", "psnr_synth", "vif_synth"),
                    save_path: Optional[str] = None):
    """Side-by-side boxplots per metric; one box per method.

    ``results_per_method``: {method: {metric: per-volume values}}.
    """
    plt = _plt(save_path)
    methods = list(results_per_method)
    fig, axes = plt.subplots(1, len(metrics),
                             figsize=(4 * len(metrics), 4))
    for ax, metric in zip(np.atleast_1d(axes), metrics):
        data = [np.asarray(results_per_method[m][metric]) for m in methods]
        try:  # tick_labels is matplotlib>=3.9; labels elsewhere
            ax.boxplot(data, tick_labels=methods)
        except TypeError:
            ax.boxplot(data, labels=methods)
        ax.set_title(metric)
        ax.tick_params(axis="x", rotation=30)
    fig.tight_layout()
    if save_path:
        fig.savefig(save_path, dpi=120)
        plt.close(fig)
    return fig


def qualitative_comparison_figure(reference_vol: np.ndarray,
                                  method_vols: Dict[str, np.ndarray],
                                  slice_ids: Optional[Sequence[int]] = None,
                                  save_path: Optional[str] = None):
    """Rows = methods (+ reference), columns = selected slices."""
    plt = _plt(save_path)
    # slice ids must be valid for EVERY volume — a tail-less method
    # volume can be shorter than the reference (same guard as
    # journal2.methods_comparison_page's common range)
    s = min([reference_vol.shape[0]]
            + [v.shape[0] for v in method_vols.values()])
    if slice_ids is None:
        slice_ids = np.linspace(1, s - 2, 4).astype(int)
    rows = {"reference": reference_vol, **method_vols}
    fig, axes = plt.subplots(len(rows), len(slice_ids), squeeze=False,
                             figsize=(2.2 * len(slice_ids),
                                      2.2 * len(rows)))
    for r, (name, vol) in enumerate(rows.items()):
        for c, sid in enumerate(slice_ids):
            axes[r, c].imshow(vol[sid], cmap="gray", vmin=0, vmax=1)
            axes[r, c].axis("off")
            if c == 0:
                axes[r, c].set_ylabel(name)
                axes[r, c].axis("on")
                axes[r, c].set_xticks([])
                axes[r, c].set_yticks([])
    fig.tight_layout()
    if save_path:
        fig.savefig(save_path, dpi=120)
        plt.close(fig)
    return fig


def long_axis_strip(volume: np.ndarray, axis: int = 1,
                    positions: Optional[Sequence[int]] = None,
                    save_path: Optional[str] = None):
    """Cross-sectional (long-axis) views of a [z, y, x] volume — the
    through-plane quality view used throughout the reference's figures."""
    plt = _plt(save_path)
    vol = np.swapaxes(volume, 0, axis)
    if positions is None:
        positions = np.linspace(vol.shape[0] * 0.3, vol.shape[0] * 0.7,
                                4).astype(int)
    fig, axes = plt.subplots(1, len(positions),
                             figsize=(3 * len(positions), 3))
    for ax, p in zip(np.atleast_1d(axes), positions):
        ax.imshow(vol[p], cmap="gray", vmin=0, vmax=1, aspect="auto")
        ax.axis("off")
    fig.tight_layout()
    if save_path:
        fig.savefig(save_path, dpi=120)
        plt.close(fig)
    return fig


def bland_altman_plot(values_a, values_b, label_a="method A",
                      label_b="method B", save_path: Optional[str] = None):
    """Bland-Altman agreement plot (clinical-metric comparisons,
    reference: evaluate/cardiac/compute_clinical_metrics.py figures)."""
    from .clinical import bland_altman_arrays

    plt = _plt(save_path)
    ba = bland_altman_arrays(values_a, values_b)
    fig, ax = plt.subplots(figsize=(5, 4))
    ax.scatter(ba["mean"], ba["diff"], s=18)
    for y, style in ((ba["bias"], "-"), (ba["loa_low"], "--"),
                     (ba["loa_high"], "--")):
        ax.axhline(y, color="r", linestyle=style, linewidth=1)
    ax.set_xlabel(f"mean of {label_a} and {label_b}")
    ax.set_ylabel(f"{label_a} − {label_b}")
    fig.tight_layout()
    if save_path:
        fig.savefig(save_path, dpi=120)
        plt.close(fig)
    return fig


def upsample_factor_compare(results: Dict[str, Dict[int, Sequence[float]]],
                            metric: str = "ssim_synth",
                            save_path: Optional[str] = None):
    """Metric vs upsampling factor, one line per method
    (reference: evaluate/plots/journal2/compare_upsampling_factors.py:46
    upsample_compare). ``results``: {method: {factor: per-volume values}}."""
    plt = _plt(save_path)
    fig, ax = plt.subplots(figsize=(6, 4))
    for method, per_factor in results.items():
        factors = sorted(per_factor)
        # nan-robust like journal2.upsample_factor_page: one NaN VIF
        # volume must not wipe out the whole factor's point
        means = [float(np.nanmean(per_factor[f])) for f in factors]
        stds = [float(np.nanstd(per_factor[f])) for f in factors]
        ax.errorbar(factors, means, yerr=stds, marker="o", capsize=3,
                    label=method)
    ax.set_xlabel("upsampling factor")
    ax.set_ylabel(metric)
    ax.legend()
    fig.tight_layout()
    if save_path:
        fig.savefig(save_path, dpi=120)
        plt.close(fig)
    return fig


def interpolation_sequence_figure(slice_from: np.ndarray,
                                  interpolants: np.ndarray,
                                  slice_to: np.ndarray,
                                  ground_truth: Optional[np.ndarray] = None,
                                  save_path: Optional[str] = None):
    """One row: from-slice, the latent interpolants in alpha order, the
    to-slice; optional second row with the ground-truth in-between slices
    (reference: evaluate/plots/journal2/synthesis.py:28
    plot_interpol_sequence)."""
    plt = _plt(save_path)
    seq = [slice_from] + [interpolants[i] for i in
                          range(interpolants.shape[0])] + [slice_to]
    rows = 2 if ground_truth is not None else 1
    fig, axes = plt.subplots(rows, len(seq), squeeze=False,
                             figsize=(2 * len(seq), 2 * rows))
    for i, s in enumerate(seq):
        axes[0, i].imshow(s, cmap="gray", vmin=0, vmax=1)
        axes[0, i].axis("off")
    axes[0, 0].set_title("from", fontsize=8)
    axes[0, -1].set_title("to", fontsize=8)
    if ground_truth is not None:
        # tolerate a ground-truth count different from the interpolant
        # count: clamp to the available columns and blank the rest
        # (a longer ground_truth previously raised IndexError)
        gts = [slice_from] + [ground_truth[i] for i in
                              range(ground_truth.shape[0])] + [slice_to]
        for i in range(len(seq)):
            if i == len(seq) - 1:
                src = gts[-1]          # the to-slice, always last
            elif i < len(gts) - 1:
                src = gts[i]
            else:
                src = None             # fewer ground-truth frames: blank
            if src is not None:
                axes[1, i].imshow(src, cmap="gray", vmin=0, vmax=1)
            axes[1, i].axis("off")
    fig.tight_layout()
    if save_path:
        fig.savefig(save_path, dpi=120)
        plt.close(fig)
    return fig


def compare_methods_slices(reference_slice: np.ndarray,
                           method_slices: Dict[str, np.ndarray],
                           show_diff: bool = True,
                           save_path: Optional[str] = None):
    """Reference + one column per method, optional |difference| row
    (reference: evaluate/plots/journal2/evaluate_qualitatively.py:50
    compare_methods_slices, get_diff at :219)."""
    plt = _plt(save_path)
    cols = 1 + len(method_slices)
    rows = 2 if show_diff else 1
    fig, axes = plt.subplots(rows, cols, squeeze=False,
                             figsize=(2.4 * cols, 2.4 * rows))
    axes[0, 0].imshow(reference_slice, cmap="gray", vmin=0, vmax=1)
    axes[0, 0].set_title("reference", fontsize=8)
    # one SHARED difference scale — per-image autoscaling would make
    # every method's error map look equally severe
    diffs = {name: np.abs(reference_slice.astype(np.float32)
                          - np.asarray(sl, np.float32))
             for name, sl in method_slices.items()} if show_diff else {}
    vmax = max((float(d.max()) for d in diffs.values()), default=1.0) or 1.0
    for j, (name, sl) in enumerate(method_slices.items(), start=1):
        axes[0, j].imshow(sl, cmap="gray", vmin=0, vmax=1)
        axes[0, j].set_title(name, fontsize=8)
        if show_diff:
            axes[1, j].imshow(diffs[name], cmap="viridis", vmin=0.0,
                              vmax=vmax)
    for ax in axes.ravel():
        ax.axis("off")
    fig.tight_layout()
    if save_path:
        fig.savefig(save_path, dpi=120)
        plt.close(fig)
    return fig


def reconstructions_grid(method_volumes: Dict[str, np.ndarray],
                         slice_ids: Sequence[int],
                         save_path: Optional[str] = None):
    """Rows = methods, columns = slices — the reconstruction comparison
    grid (reference: evaluate/plots/journal2/reconstructions.py:99
    plot_grid_reconstructions)."""
    plt = _plt(save_path)
    rows = len(method_volumes)
    cols = len(slice_ids)
    fig, axes = plt.subplots(rows, cols, squeeze=False,
                             figsize=(2 * cols, 2 * rows))
    for i, (name, vol) in enumerate(method_volumes.items()):
        for j, s in enumerate(slice_ids):
            axes[i, j].imshow(vol[s], cmap="gray", vmin=0, vmax=1)
            axes[i, j].axis("off")
        axes[i, 0].set_ylabel(name, fontsize=8)
        axes[i, 0].axis("on")
        axes[i, 0].set_xticks([])
        axes[i, 0].set_yticks([])
    fig.tight_layout()
    if save_path:
        fig.savefig(save_path, dpi=120)
        plt.close(fig)
    return fig


def orthogonal_views_figure(volume: np.ndarray,
                            save_path: Optional[str] = None):
    """Axial / coronal / sagittal mid-views of a [z, y, x] volume
    (reference: evaluate/plots/journal2/evaluate_qualitatively.py:13
    plot_reference_coronal_sagittal)."""
    plt = _plt(save_path)
    mids = [volume.shape[0] // 2, volume.shape[1] // 2,
            volume.shape[2] // 2]
    views = [volume[mids[0]], volume[:, mids[1]], volume[:, :, mids[2]]]
    titles = ["axial", "coronal", "sagittal"]
    fig, axes = plt.subplots(1, 3, figsize=(9, 3))
    for ax, v, t in zip(axes, views, titles):
        ax.imshow(v, cmap="gray", vmin=0, vmax=1, aspect="auto")
        ax.set_title(t, fontsize=9)
        ax.axis("off")
    fig.tight_layout()
    if save_path:
        fig.savefig(save_path, dpi=120)
        plt.close(fig)
    return fig


def lax_views_compare(method_volumes: Dict[str, np.ndarray],
                      axis: int = 1, position: Optional[int] = None,
                      save_path: Optional[str] = None):
    """One long-axis view per method at the same cut position
    (reference: evaluate/plots/journal2/cardiac_lax_view.py:13
    generate_lax_views)."""
    plt = _plt(save_path)
    names = list(method_volumes)
    fig, axes = plt.subplots(1, len(names), figsize=(3 * len(names), 3))
    for ax, name in zip(np.atleast_1d(axes), names):
        vol = np.swapaxes(method_volumes[name], 0, axis)
        p = position if position is not None else vol.shape[0] // 2
        ax.imshow(vol[p], cmap="gray", vmin=0, vmax=1, aspect="auto")
        ax.set_title(name, fontsize=9)
        ax.axis("off")
    fig.tight_layout()
    if save_path:
        fig.savefig(save_path, dpi=120)
        plt.close(fig)
    return fig


class SegColorMap:
    """Transparent-background segmentation colormap for label overlays
    (reference: evaluate/plots/color_maps.py:5-29 SegColorMap /
    :31 SegColorMapACDC via the ``colors`` argument)."""

    DEFAULT = ((0, 0, 0), (10, 170, 28), (232, 167, 4), (43, 84, 206),
               (230, 230, 0), (234, 9, 9))
    ACDC = ((0, 0, 0), (234, 9, 9), (43, 84, 206), (10, 170, 28))

    def __init__(self, alpha: float = 0.8, colors=DEFAULT):
        # 8-bit palette → [0,1] by /255 (min-max normalisation shifted
        # every colour and went NaN on constant palettes)
        c = np.asarray(colors, np.float64) / 255.0
        self.np_cmap = np.concatenate(
            [c, np.full((len(c), 1), alpha)], axis=1)
        self.np_cmap[0, -1] = 0.0  # background fully transparent

    @property
    def cmap(self):
        from matplotlib.colors import ListedColormap
        return ListedColormap(self.np_cmap)

    def convert_multi_labels(self, label_array: np.ndarray) -> np.ndarray:
        """Integer label map → RGBA array. Negative (ignore) labels
        render transparent instead of wrapping to the last class."""
        lbl = np.asarray(label_array, np.int64)
        rgba = self.np_cmap[np.clip(lbl, 0, len(self.np_cmap) - 1)]
        rgba[lbl < 0] = 0.0
        return rgba


def label_overlay_figure(image: np.ndarray, labels: np.ndarray,
                         alpha: float = 0.8, acdc: bool = False,
                         save_path: Optional[str] = None):
    """Grayscale slice with a transparent label overlay."""
    plt = _plt(save_path)
    cm = SegColorMap(alpha=alpha,
                     colors=SegColorMap.ACDC if acdc else SegColorMap.DEFAULT)
    fig, ax = plt.subplots(figsize=(4, 4))
    ax.imshow(image, cmap="gray", vmin=0, vmax=1)
    ax.imshow(cm.convert_multi_labels(labels))
    ax.axis("off")
    fig.tight_layout()
    if save_path:
        fig.savefig(save_path, dpi=120)
        plt.close(fig)
    return fig


def animate_volume(volume: np.ndarray, save_path: str,
                   interval_ms: int = 100) -> str:
    """Slice-scroll animation of a [z, y, x] volume saved as a gif
    (reference: kwatsch/plot_utils.py:20-42 FuncAnimation helper)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib import animation

    fig, ax = plt.subplots(figsize=(4, 4))
    im = ax.imshow(volume[0], cmap="gray", vmin=0, vmax=1)
    ax.axis("off")

    def update(j):
        im.set_data(volume[j])
        return (im,)

    anim = animation.FuncAnimation(fig, update, frames=volume.shape[0],
                                   interval=interval_ms, blit=True)
    anim.save(save_path, writer=animation.PillowWriter(
        fps=max(1, 1000 // interval_ms)))
    plt.close(fig)
    return save_path
