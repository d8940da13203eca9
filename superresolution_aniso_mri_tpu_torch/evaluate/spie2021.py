"""SPIE-2021 per-paper figure layouts (port of
``superresolution_aniso_mri_tpu/evaluate/spie2021.py``, the same pages).

Reference: evaluate/plots/spie2021/* + evaluate/plots/compare_methods.py
(~700 LoC of paper-specific compositions). The generic figure families
live in evaluate/plots.py and the journal-2 pages in
evaluate/journal2.py; this module reproduces the SPIE conference
paper's SPECIFIC pages so a reference user finds the same assets:

  * colored 3-panel SSIM/PSNR/VIF boxplot page — conventional methods
    share one hue at increasing opacity, the model family another
    (metric_boxplots.py:5-72 make_boxplots);
  * per-method long-axis view pages with physical z/y extents and an
    optional signed-difference companion row, reference filename
    pattern ``<method>_lax_p<pid>[_f<f>]_s<sid>_<n>x.png``
    (long_axis_views.py:6-65 compare_long_axis_views);
  * original + per-method (image, diff) column-pair grid, one or two
    slice rows, returning the per-method RMSE book
    (evaluate_qualitatively.py:13-67 compare_methods_slices);
  * interpolation example page: 3 original slices over the decoded
    interpolation strip over signed-difference maps in a 6x6 grid
    (evaluate_qualitatively.py:70-139 plot_interpol_example);
  * presentation pages: reference slices around a synthesized position
    as single-image files plus per-method synthesized+diff pairs,
    filename patterns ``<meth>_sax_p...``/``<meth>_sax_diff_p...``
    (presentation_plots.py:12-91);
  * two-method slice-by-slice comparison rows (original | method 1 |
    method 2) with per-slice SSIM/PSNR in the panel titles
    (compare_methods.py:35-149 plot_compare).

All layouts are re-derived compositions over this framework's numpy
volumes (no skimage); per-slice metrics come from the port's
``ops/metrics.py`` on ``device``.
"""
from __future__ import annotations

import os
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from .journal2 import _finish
from .plots import _plt

# the SPIE color book: conventional interpolation = one hue at rising
# opacity, learned models = a second hue (metric_boxplots.py:11-16)
_CONV_COLOR = "tab:orange"
_MODEL_COLOR = "tab:purple"
_CONV_ALPHAS = (0.45, 0.7, 0.95)
_CONVENTIONAL = ("linear", "b-spline", "bspline", "lanczos", "nearest")


def _method_style(method: str, conv_seen: int):
    if method.lower() in _CONVENTIONAL:
        alpha = _CONV_ALPHAS[min(conv_seen, len(_CONV_ALPHAS) - 1)]
        return _CONV_COLOR, alpha, conv_seen + 1
    return _MODEL_COLOR, 1.0, conv_seen


def spie_boxplot_page(res_vectors: Dict[str, Sequence[Sequence[float]]],
                      m_labels: Sequence[str],
                      save_path: Optional[str] = None,
                      show_means: bool = False,
                      use_fill_color: bool = True):
    """Three metric panels, one colored box per method.

    ``res_vectors``: {'ssim'|'psnr'|'vif': [per-method value vectors]}
    aligned with ``m_labels``. ``use_fill_color`` reproduces the
    reference's filled boxes (make_boxplots default,
    metric_boxplots.py:5-6,31 patch_artist=use_fill_color)."""
    plt = _plt(save_path)
    fig, axes = plt.subplots(1, 3, figsize=(18, 8))
    for ax, (key, title) in zip(axes, (("ssim", "SSIM"), ("psnr", "PSNR"),
                                       ("vif", "VIF"))):
        conv_seen = 0
        for m_idx, method in enumerate(m_labels):
            color, alpha, conv_seen = _method_style(method, conv_seen)
            style = dict(color=color, alpha=alpha, linewidth=3)
            # each prop group gets its OWN copy: matplotlib >= 3.10's
            # boxplot() mutates the boxprops dict in place under
            # patch_artist ('color' -> 'edgecolor'), which poisons a
            # shared dict for the Line2D whisker/cap/median artists
            bp = ax.boxplot(np.asarray(res_vectors[key][m_idx]),
                            positions=[m_idx + 1], widths=0.6,
                            patch_artist=use_fill_color,
                            showmeans=show_means,
                            boxprops=dict(style), capprops=dict(style),
                            whiskerprops=dict(style),
                            medianprops=dict(style),
                            flierprops=dict(markeredgecolor=color,
                                            alpha=alpha))
            if use_fill_color:
                for box in bp["boxes"]:
                    box.set_facecolor(color)
                    box.set_alpha(alpha)
        ax.set_title(title, fontsize=20)
        ax.yaxis.grid(True)
        ax.set_xticks(np.arange(1, len(m_labels) + 1))
        ax.set_xticklabels(m_labels, rotation=90, fontsize=14)
    return _finish(fig, plt, save_path, dpi=120)


def _extract_lax_slice(img3d: np.ndarray, slice_id: int,
                       x_crop: Optional[Tuple[int, int]]):
    """(z, x) coronal cut at row ``slice_id``, optionally cropped to
    the ``x_crop = (lo, hi)`` column window (the reference's
    ``slice_info`` crop, long_axis_views.py:27-30)."""
    cut = img3d[:, slice_id]
    return cut if x_crop is None else cut[:, x_crop[0]:x_crop[1]]


def lax_view_pages(method_img_dict: Dict[str, Dict],
                   patient_id, slice_id: int, num_interpolations: int,
                   frame_id: Optional[int] = None,
                   x_crop: Optional[Tuple[int, int]] = None,
                   with_diff_image: bool = False,
                   fig_dir: Optional[str] = None,
                   width: float = 5.0, height: float = 2.0
                   ) -> Dict[str, np.ndarray]:
    """One long-axis figure per method, rendered at the volume's
    PHYSICAL extent (z spacing x slice count vs in-plane spacing), with
    an optional reference-minus-method companion panel; saves under the
    reference's filename pattern when ``fig_dir`` is given. Returns the
    extracted LAX slices per method (the 'reference' entry must be
    present when ``with_diff_image``). Figures are always closed — the
    extracted arrays are the return value; the pngs the artifact."""
    plt = _plt(fig_dir)
    out: Dict[str, np.ndarray] = {}
    ref_entry = method_img_dict.get("reference")
    ref_cut = None
    if ref_entry is not None:
        img = np.asarray(ref_entry[patient_id]["image"], np.float32)
        if frame_id is not None and img.ndim == 4:
            img = img[frame_id]
        ref_cut = _extract_lax_slice(img, slice_id, x_crop)
    for method, image_dict in method_img_dict.items():
        entry = image_dict[patient_id]
        spacing = np.asarray(entry.get("spacing", (1.0, 1.0, 1.0)),
                             np.float64)
        if spacing.size > 3:      # 4-D spacing carries a leading t
            spacing = spacing[1:]
        if method == "reference" and ref_cut is not None:
            cut = ref_cut  # already extracted above — one code path
        else:
            img = np.asarray(entry["image"], np.float32)
            if frame_id is not None and img.ndim == 4:
                img = img[frame_id]
            cut = _extract_lax_slice(img, slice_id, x_crop)
        out[method] = cut
        # the displayed axes are (z, x): width from the CUT's x extent
        # (after cropping) at the in-plane x spacing, height from z
        extent = (0, cut.shape[1] * spacing[2], 0,
                  cut.shape[0] * spacing[0])
        two_rows = with_diff_image and method != "reference" \
            and ref_cut is not None
        fig = plt.figure(figsize=(width, height * (2 if two_rows else 1)))
        if two_rows:
            ax_img, ax_diff = fig.subplots(2)
            ax_diff.imshow(ref_cut - cut, cmap="bwr", vmin=-0.5, vmax=0.5,
                           interpolation="nearest", extent=extent)
            ax_diff.axis("off")
        else:
            ax_img = fig.subplots(1)
        ax_img.imshow(cut, cmap="gray", vmin=0, vmax=1,
                      interpolation="nearest", extent=extent)
        ax_img.axis("off")
        fig.tight_layout()
        if fig_dir:
            os.makedirs(fig_dir, exist_ok=True)
            frame_tag = "" if frame_id is None else f"_f{frame_id}"
            fname = (f"{method}_lax_p{patient_id}{frame_tag}"
                     f"_s{slice_id}_{num_interpolations}x.png")
            fig.savefig(os.path.join(fig_dir, fname), bbox_inches="tight")
        plt.close(fig)
    return out


def _take_slice(vol: np.ndarray, slice_id: int, axis: int,
                frame_id: Optional[int]):
    if frame_id is not None and vol.ndim == 4:
        vol = vol[frame_id]
    sl = np.take(vol, slice_id, axis=axis)
    return np.rot90(sl, 2) if axis in (1, 2) else sl


def methods_grid_page(images_dict: Dict[str, np.ndarray], slice_id1: int,
                      slice_id2: Optional[int] = None, axis: int = 0,
                      frame_id: Optional[int] = None,
                      methods: Optional[Sequence[str]] = None,
                      save_path: Optional[str] = None,
                      row_height: float = 4.0, width: float = 8.0
                      ) -> Dict[str, Dict[int, float]]:
    """Original slice top-left; every other method contributes an
    (image, signed-diff) row pair per slice row. ``images_dict`` maps
    method → volume with an 'original' entry first. Returns the
    per-method per-slice RMSE book the reference prints."""
    plt = _plt(save_path)
    if methods is None:
        methods = list(images_dict)
    assert methods[0] == "original", "first method must be 'original'"
    slice_ids = [slice_id1] + ([slice_id2] if slice_id2 is not None else [])
    n_rows, n_cols = 4 * len(slice_ids), 2 * len(methods)
    fig = plt.figure(figsize=(width, row_height * len(slice_ids) * 2))
    rmse: Dict[str, Dict[int, float]] = {m: {} for m in methods[1:]}
    for r, sid in enumerate(slice_ids):
        orig = _take_slice(np.asarray(images_dict["original"], np.float32),
                           sid, axis, frame_id)
        ax = plt.subplot2grid((n_rows, n_cols), (4 * r, 0),
                              rowspan=2, colspan=2)
        ax.imshow(orig, cmap="gray", interpolation="nearest",
                  aspect="equal")
        ax.set_title("Original", fontsize=12)
        ax.axis("off")
        for i, meth in enumerate(methods[1:], start=1):
            cut = _take_slice(np.asarray(images_dict[meth], np.float32),
                              sid, axis, frame_id)
            diff = orig - cut
            rmse[meth][sid] = float(np.sqrt(np.mean(diff ** 2)))
            ax_i = plt.subplot2grid((n_rows, n_cols), (4 * r, 2 * i),
                                    rowspan=2, colspan=2)
            ax_i.imshow(cut, cmap="gray", interpolation="nearest",
                        aspect="equal")
            ax_i.set_title(meth, fontsize=12)
            ax_i.axis("off")
            ax_d = plt.subplot2grid((n_rows, n_cols), (4 * r + 2, 2 * i),
                                    rowspan=2, colspan=2)
            ax_d.imshow(diff, cmap="bwr", vmin=-0.5, vmax=0.5,
                        interpolation="nearest", aspect="equal")
            ax_d.set_xticks([]), ax_d.set_yticks([])
    _finish(fig, plt, save_path)
    return rmse


def interpol_example_page(interpol_grid: np.ndarray,
                          orig_slices: np.ndarray,
                          save_path: Optional[str] = None,
                          width: float = 14.0, height: float = 8.0):
    """Three original slices over the decoded interpolation strip over
    signed-difference maps (originals - strip ends/midpoint). The strip
    alternates Reconstructed/Synthesized titles like the paper figure.

    ``interpol_grid``: [n_interp + 2, y, x] decoded strip;
    ``orig_slices``: [3, y, x] (from, in-between, to)."""
    plt = _plt(save_path)
    n = interpol_grid.shape[0]
    fig = plt.figure(figsize=(width, height))
    cols = 2 * max(n, 3)
    for i in range(3):
        ax = plt.subplot2grid((6, cols), (0, 2 * i), rowspan=2, colspan=2)
        ax.imshow(orig_slices[i], cmap="gray", interpolation="nearest",
                  aspect="equal")
        ax.set_title(f"Original\nslice {i + 1}", fontsize=12)
        ax.set_xticks([]), ax.set_yticks([])
    for i in range(n):
        ax = plt.subplot2grid((6, cols), (2, 2 * i), rowspan=2, colspan=2)
        ax.imshow(interpol_grid[i], cmap="gray", interpolation="nearest",
                  aspect="equal")
        title = ("Reconstructed" if i in (0, n - 1) else "Synthesized")
        ax.set_title(title, fontsize=12)
        ax.set_xticks([]), ax.set_yticks([])
    # diff row: original triplet vs strip start / midpoint / end
    picks = (0, n // 2, n - 1)
    for i, pick in enumerate(picks):
        ax = plt.subplot2grid((6, cols), (4, 2 * i), rowspan=2, colspan=2)
        ax.imshow(orig_slices[i] - interpol_grid[pick], cmap="bwr",
                  vmin=-1.0, vmax=1.0, interpolation="nearest",
                  aspect="equal")
        ax.set_xticks([]), ax.set_yticks([])
    return _finish(fig, plt, save_path)


def presentation_slice_pages(images_dict: Dict[str, np.ndarray],
                             patient_id, slice_id: int, axis: int = 0,
                             frame_id: Optional[int] = None,
                             fig_dir: Optional[str] = None,
                             width: float = 5.0, height: float = 5.0):
    """Per-method presentation pages around one synthesized position:
    the 'reference' method emits the three surrounding slices as
    single-image pages; every other method emits a synthesized+diff
    two-row page. Reference filename patterns
    ``<meth>_sax_p<pid>[_f<f>]_s<sid>.png`` /
    ``<meth>_sax_diff_p...`` (presentation_plots.py:12-54)."""
    plt = _plt(fig_dir)
    frame_tag = "" if frame_id is None else f"_f{frame_id}"
    ref = _take_slice(np.asarray(images_dict["reference"], np.float32),
                      slice_id, axis, frame_id)
    written = []

    def _save(fig, fname):
        if fig_dir:
            os.makedirs(fig_dir, exist_ok=True)
            path = os.path.join(fig_dir, fname)
            fig.savefig(path, bbox_inches="tight")
            written.append(path)
        plt.close(fig)

    for meth, vol in images_dict.items():
        if meth == "reference":
            arr = np.asarray(vol, np.float32)
            n_slices = (arr[frame_id] if frame_id is not None
                        and arr.ndim == 4 else arr).shape[axis]
            for off in (-1, 0, 1):
                sid = slice_id + off
                # skip out-of-volume neighbours at the edges (a negative
                # index would silently wrap to the far end)
                if not 0 <= sid < n_slices:
                    continue
                cut = _take_slice(arr, sid, axis, frame_id)
                fig = plt.figure(figsize=(width, height))
                plt.imshow(cut, cmap="gray", vmin=0, vmax=1,
                           interpolation="nearest")
                plt.axis("off")
                _save(fig, f"{meth}_sax_p{patient_id}{frame_tag}"
                           f"_s{sid}.png")
            continue
        cut = _take_slice(np.asarray(vol, np.float32), slice_id, axis,
                          frame_id)
        fig = plt.figure(figsize=(width, height * 2))
        ax_img, ax_diff = fig.subplots(2)
        ax_img.imshow(cut, cmap="gray", vmin=0, vmax=1,
                      interpolation="nearest")
        ax_img.axis("off")
        ax_diff.imshow(ref - cut, cmap="bwr", vmin=-0.5, vmax=0.5,
                       interpolation="nearest")
        ax_diff.axis("off")
        _save(fig, f"{meth}_sax_diff_p{patient_id}{frame_tag}"
                   f"_s{slice_id}.png")
    return written


def two_method_slice_compare(orig_vol: np.ndarray, m1_vol: np.ndarray,
                             m2_vol: np.ndarray,
                             slice_range: Optional[Sequence[int]] = None,
                             eval_axis: int = 0,
                             m1_desc: str = "method 1",
                             m2_desc: str = "method 2",
                             frame_id: Optional[int] = None,
                             downsample_steps: Optional[int] = None,
                             save_path: Optional[str] = None,
                             device=None):
    """Rows of (method 1 | ORIGINAL | method 2) panels — the reference's
    column order — with per-slice SSIM/PSNR in the method titles and,
    when ``downsample_steps`` is given, the reference's Reconstructed/
    Synthesized slice annotation (compare_methods.py:35-149
    plot_compare; metrics by ``ops.metrics`` on ``device``, None: the
    CUDA device, instead of skimage)."""
    import torch

    from ..device import resolve_device
    from ..ops.metrics import psnr2d, ssim2d

    dev = resolve_device(device)
    plt = _plt(save_path)
    orig = np.asarray(orig_vol, np.float32)
    if frame_id is not None and orig.ndim == 4:
        orig = orig[frame_id]
    if slice_range is None:
        slice_range = range(orig.shape[eval_axis])
    slice_range = list(slice_range)
    fig, axes = plt.subplots(len(slice_range), 3,
                             figsize=(10, 3 * len(slice_range)),
                             squeeze=False)
    for r, sid in enumerate(slice_range):
        o = _take_slice(orig, sid, eval_axis, None)
        method_panels = []
        for desc, vol in ((m1_desc, m1_vol), (m2_desc, m2_vol)):
            # _take_slice owns the 4D frame selection — one code path
            cut = _take_slice(np.asarray(vol, np.float32), sid,
                              eval_axis, frame_id)
            o_t, cut_t = (torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                          for a in (o, cut))
            s = float(ssim2d(o_t, cut_t))
            p = float(psnr2d(o_t, cut_t))
            # the reference labels method slices Reconstructed (on the
            # original grid) vs Synthesized (compare_methods.py:92-99)
            kind = ("Reconstructed"
                    if downsample_steps and sid % downsample_steps == 0
                    else "Synthesized" if downsample_steps else "")
            method_panels.append(
                (f"{desc} {kind}\nSSIM {s:.3f}  PSNR {p:.1f}", cut))
        # reference layout: method1 | ORIGINAL | method2
        # (compare_methods.py:84-99 puts the original in the middle)
        panels = [method_panels[0], (f"Original slice {sid}", o),
                  method_panels[1]]
        for c, (title, img) in enumerate(panels):
            ax = axes[r][c]
            ax.imshow(img, cmap="gray", vmin=0, vmax=1,
                      interpolation="nearest")
            ax.set_title(title, fontsize=10)
            ax.axis("off")
    return _finish(fig, plt, save_path)
