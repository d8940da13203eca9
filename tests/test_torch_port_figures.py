"""PyTorch port, the papers' figures and the loss curves
(``evaluate/{plots,journal2,spie2021}.py``, ``utils/loss_curves.py``).

Every public figure function of the JAX package runs with the same
seeded inputs through JAX and through the port, each saving into its
own directory. Every figure that is saved is read, at its ``savefig``,
into a signature: the axes with their titles, labels, limits, tick
labels and texts, the ``imshow`` arrays with their colour limits and
extents, the line data (box statistics, whiskers and medians are
lines), the scatter offsets, the patches, the legends and the figure's
texts. The port's signatures and return values equal JAX's, and every
file the port names exists.
"""
import inspect
import os

import matplotlib
import numpy as np
import pytest
from matplotlib.figure import Figure

matplotlib.use("Agg")

FIGURE_MODULES = ("evaluate.plots", "evaluate.journal2", "evaluate.spie2021",
                  "utils.loss_curves")


def _module(pkg, name):
    import importlib

    return importlib.import_module(f"{pkg}.{name}")


def _public(mod):
    return sorted(n for n, f in vars(mod).items()
                  if inspect.isfunction(f) and not n.startswith("_")
                  and f.__module__ == mod.__name__)


def _signature(fig):
    axes = []
    for ax in fig.axes:
        legend = ax.get_legend()
        axes.append({
            "title": [ax.get_title(loc) for loc in ("left", "center",
                                                     "right")],
            "labels": (ax.get_xlabel(), ax.get_ylabel()),
            "limits": (ax.get_xlim(), ax.get_ylim()),
            "axis_on": ax.axison,
            "ticks": ([t.get_text() for t in ax.get_xticklabels()],
                      [t.get_text() for t in ax.get_yticklabels()]),
            "texts": [t.get_text() for t in ax.texts],
            "images": [(np.asarray(im.get_array()), im.get_clim(),
                        im.get_extent(), im.get_cmap().name)
                       for im in ax.images],
            "lines": [(np.asarray(ln.get_xydata()), ln.get_color(),
                       ln.get_linestyle(), ln.get_label())
                      for ln in ax.lines],
            "collections": [np.asarray(c.get_offsets())
                            for c in ax.collections],
            "patches": [np.asarray(p.get_path().vertices) for p in ax.patches],
            "legend": ([t.get_text() for t in legend.get_texts()]
                       if legend else None),
        })
    return {"size": tuple(fig.get_size_inches()),
            "texts": [t.get_text() for t in fig.texts], "axes": axes}


def _assert_equal(got, want, where="figure"):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), where
        for k in want:
            _assert_equal(got[k], want[k], f"{where}/{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_equal(g, w, f"{where}[{i}]")
    elif isinstance(want, np.ndarray) or isinstance(got, np.ndarray):
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want),
                                      err_msg=where)
    else:
        assert got == want or (got != got and want != want), (where, got,
                                                               want)


def _inputs(tmp):
    """name → (module, kwargs) of every public figure function; the
    arrays are seeded, small, in [0, 1]."""
    rng = np.random.RandomState(0)
    vol = rng.rand(8, 12, 12).astype(np.float32)
    vol2 = np.clip(vol + 0.1 * rng.randn(*vol.shape), 0, 1).astype(np.float32)
    vol3 = np.clip(vol + 0.2 * rng.randn(*vol.shape), 0, 1).astype(np.float32)
    v4d = rng.rand(3, 8, 12, 12).astype(np.float32)
    w4d = np.clip(v4d + 0.1 * rng.randn(*v4d.shape), 0, 1).astype(np.float32)

    def vals(n=5):
        return list(rng.rand(n))

    metrics = ("ssim", "psnr", "vif")
    per_method = {m: {f"{k}{s}": vals() for k in metrics
                      for s in ("", "_synth")}
                  for m in ("linear", "lanczos", "ours")}
    lam = {v: {f"{k}{s}": vals() for k in metrics for s in ("", "_synth")}
           for v in (0.001, 0.01, 0.1)}
    by_factor = {k: {f"{m}_synth": vals() for m in metrics} for k in (2, 4)}
    interp = rng.rand(3, 12, 12).astype(np.float32)
    labels = rng.randint(0, 4, (12, 12))
    exper = os.path.join(tmp, "exper")
    os.makedirs(exper)
    keys = ("loss_ae_dist", "loss_ae_dist_extra", "loss_latent_1")
    np.savez(os.path.join(exper, "loss_iters.npz"),
             loss_iters=np.arange(1, 7) * 10)
    np.savez(os.path.join(exper, "losses_train.npz"),
             **{k: rng.rand(6) for k in keys})
    np.savez(os.path.join(exper, "losses_test.npz"),
             **{k: rng.rand(4) for k in keys[:2]})
    lax = {m: {"p7": {"image": v, "spacing": (1.0, 6.0, 1.5, 1.25)}}
           for m, v in (("reference", v4d), ("ours", w4d))}
    return {
        "metric_boxplots": ("plots", dict(results_per_method=per_method)),
        "qualitative_comparison_figure": ("plots", dict(
            reference_vol=vol, method_vols={"a": vol2, "b": vol3},
            slice_ids=[1, 5])),
        "long_axis_strip": ("plots", dict(volume=vol, axis=2,
                                          positions=[3, 9])),
        "bland_altman_plot": ("plots", dict(values_a=vals(8),
                                            values_b=vals(8),
                                            label_a="A", label_b="B")),
        "upsample_factor_compare": ("plots", dict(results={
            m: {2: vals(), 4: vals(), 6: vals()} for m in ("a", "b")})),
        "interpolation_sequence_figure": ("plots", dict(
            slice_from=vol[0], interpolants=interp, slice_to=vol[4],
            ground_truth=vol[1:4])),
        "compare_methods_slices": ("plots", dict(
            reference_slice=vol[2], method_slices={"a": vol2[2],
                                                   "b": vol3[2]})),
        "reconstructions_grid": ("plots", dict(
            method_volumes={"a": vol2, "b": vol3}, slice_ids=[0, 3, 6])),
        "orthogonal_views_figure": ("plots", dict(volume=vol)),
        "lax_views_compare": ("plots", dict(
            method_volumes={"a": vol2, "b": vol3}, axis=1)),
        "label_overlay_figure": ("plots", dict(image=vol[3], labels=labels,
                                               acdc=True)),
        "animate_volume": ("plots", dict(volume=vol[:3], interval_ms=50)),
        "upsample_factor_page": ("journal2", dict(
            model_results=by_factor,
            conventional={"linear": {k: {f"{m}_synth": vals()
                                         for m in metrics}
                                     for k in (2, 4)}})),
        "lambda_page": ("journal2", dict(lambda_results=lam)),
        "methods_comparison_page": ("journal2", dict(
            reference_vol=vol, method_vols={"a": vol2, "b": vol3},
            slice_ids=[2, 4])),
        "interpol_sequence_page": ("journal2", dict(
            slice_from=vol[0], interpolants=interp, slice_to=vol[4],
            inset=(2, 8, 3, 9))),
        "reconstruction_page": ("journal2", dict(
            reference_vol=vol, method_vols={"a": vol2}, slice_ids=[1, 2])),
        "boxplot_page": ("journal2", dict(results_per_method=per_method)),
        "cardiac_lax_page": ("journal2", dict(
            method_vols4d={"reference": v4d, "ours": w4d}, frame=1,
            positions=[2, 6, 20])),
        "spie_boxplot_page": ("spie2021", dict(
            res_vectors={k: [vals(), vals(), vals()] for k in metrics},
            m_labels=["linear", "lanczos", "ours"], show_means=True)),
        "lax_view_pages": ("spie2021", dict(
            method_img_dict=lax, patient_id="p7", slice_id=5,
            num_interpolations=3, frame_id=1, x_crop=(2, 10),
            with_diff_image=True)),
        "methods_grid_page": ("spie2021", dict(
            images_dict={"original": vol, "a": vol2, "b": vol3},
            slice_id1=2, slice_id2=5)),
        "interpol_example_page": ("spie2021", dict(
            interpol_grid=rng.rand(5, 12, 12).astype(np.float32),
            orig_slices=vol[:3])),
        "presentation_slice_pages": ("spie2021", dict(
            images_dict={"reference": vol, "ours": vol2}, patient_id=3,
            slice_id=4)),
        "two_method_slice_compare": ("spie2021", dict(
            orig_vol=vol, m1_vol=vol2, m2_vol=vol3, slice_range=[2, 3, 4],
            m1_desc="ours", m2_desc="linear", downsample_steps=2)),
        "show_loss_curves": ("loss_curves", dict(
            iters=np.arange(1, 7) * 10,
            losses_train={k: rng.rand(6) for k in keys},
            losses_test={k: rng.rand(4) for k in keys[:2]})),
        "show_experiment_losses": ("loss_curves", dict(path_to_exper=exper)),
    }


def _run(pkg, name, mod_name, kwargs, out_dir, monkeypatch):
    """Call ``pkg``'s function, saving into ``out_dir``; its return value
    and the (file name, signature) of every figure it saved."""
    mod = _module(pkg, dict(plots="evaluate.plots",
                            journal2="evaluate.journal2",
                            spie2021="evaluate.spie2021",
                            loss_curves="utils.loss_curves")[mod_name])
    fn = getattr(mod, name)
    params = inspect.signature(fn).parameters
    kw = dict(kwargs)
    if "fig_dir" in params:
        kw["fig_dir"] = out_dir
    else:
        ext = ".gif" if name == "animate_volume" else ".png"
        kw["save_path"] = os.path.join(out_dir, name + ext)
    if "device" in params:
        kw["device"] = "cpu"
    saved = []
    savefig = Figure.savefig

    def recording(fig, fname, *a, **k):
        where = os.path.basename(fname) if isinstance(fname, str) else None
        saved.append((where, _signature(fig)))
        return savefig(fig, fname, *a, **k)

    monkeypatch.setattr(Figure, "savefig", recording)
    try:
        ret = fn(**kw)
    finally:
        monkeypatch.setattr(Figure, "savefig", savefig)
    if isinstance(ret, Figure):
        ret = _signature(ret)
    elif isinstance(ret, str):
        assert os.path.exists(ret)
        ret = os.path.basename(ret)
    elif isinstance(ret, list):
        assert all(os.path.exists(p) for p in ret)
        ret = [os.path.basename(p) for p in ret]
    return ret, saved


def test_every_public_figure_function_is_covered():
    """The cases cover every public function of JAX's figure modules,
    and the port has each of them with JAX's arguments (``device``
    added where the port computes a metric)."""
    jax_names, port_names = set(), set()
    for name in FIGURE_MODULES:
        jmod = _module("superresolution_aniso_mri_tpu", name)
        pmod = _module("superresolution_aniso_mri_tpu_torch", name)
        jax_names |= set(_public(jmod))
        port_names |= set(_public(pmod))
        for fn in _public(jmod):
            want = list(inspect.signature(getattr(jmod, fn)).parameters)
            got = [p for p in inspect.signature(getattr(pmod, fn)).parameters
                   if p != "device"]
            assert got == want, fn
    assert jax_names == port_names
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        assert set(_inputs(tmp)) == jax_names


NAMES = sorted(["metric_boxplots", "qualitative_comparison_figure",
                "long_axis_strip", "bland_altman_plot",
                "upsample_factor_compare", "interpolation_sequence_figure",
                "compare_methods_slices", "reconstructions_grid",
                "orthogonal_views_figure", "lax_views_compare",
                "label_overlay_figure", "animate_volume",
                "upsample_factor_page", "lambda_page",
                "methods_comparison_page", "interpol_sequence_page",
                "reconstruction_page", "boxplot_page", "cardiac_lax_page",
                "spie_boxplot_page", "lax_view_pages", "methods_grid_page",
                "interpol_example_page", "presentation_slice_pages",
                "two_method_slice_compare", "show_loss_curves",
                "show_experiment_losses"])


@pytest.mark.parametrize("name", NAMES)
def test_figure_matches_jax(name, tmp_path, monkeypatch):
    mod_name, kwargs = _inputs(str(tmp_path))[name]
    jax_dir, port_dir = tmp_path / "jax", tmp_path / "port"
    jax_dir.mkdir()
    port_dir.mkdir()
    want, want_saved = _run("superresolution_aniso_mri_tpu", name, mod_name,
                            kwargs, str(jax_dir), monkeypatch)
    got, got_saved = _run("superresolution_aniso_mri_tpu_torch", name,
                          mod_name, kwargs, str(port_dir), monkeypatch)
    assert want_saved, name
    _assert_equal(got_saved, want_saved, name)
    _assert_equal(got, want, f"{name} return")
    files = sorted(os.listdir(port_dir))
    assert files and files == sorted(os.listdir(jax_dir))
    assert all(os.path.getsize(port_dir / f) > 0 for f in files)
