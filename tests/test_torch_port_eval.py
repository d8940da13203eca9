"""PyTorch port, the paper's evaluation functions: reconstruction-only
scores, the quantitative comparison of saved NIfTI volumes, the
rigid-transform sensitivity table, the brain-dataset driver (MNIST3D and
MNISTRoto), perceptual path length, SAX→LAX grid sampling, the numpy
segmentation / clinical / AE+CAISR merge helpers and the model registry
reader, held against the JAX package on the CPU. Weights come from
numpy-seeded trees (``torch_port_helpers``), JAX runs at
``default_matmul_precision("highest")``. Tolerances: metric dicts atol
1e-4; PPL rel 1e-4 (see its test); ``grid_sample_3d`` atol 1e-6; the numpy copies and
the registry exact.
"""
import math
import os
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from hypothesis import given, settings
from hypothesis import strategies as st

from superresolution_aniso_mri_tpu import evaluate as jev
from superresolution_aniso_mri_tpu.data import Volume as JaxVolume
from superresolution_aniso_mri_tpu.evaluate import model_registry as jreg
from superresolution_aniso_mri_tpu.utils import write_nifti as jax_write
from superresolution_aniso_mri_tpu_torch import evaluate as tev
from superresolution_aniso_mri_tpu_torch.config import parse_model_registry
from superresolution_aniso_mri_tpu_torch.data import Volume
from superresolution_aniso_mri_tpu_torch.evaluate import model_registry as treg
from superresolution_aniso_mri_tpu_torch.evaluate import (
    test_interpolation_with_rigid_transformations as rigid_table)
from superresolution_aniso_mri_tpu_torch.models import flax_to_torch
from superresolution_aniso_mri_tpu_torch.train import Trainer
from torch_port_helpers import (SMALL, jax_eval_trainer, jax_family_model,
                                one_torch_thread)  # noqa: F401 (autouse)

NET = dict(SMALL, use_batchnorm=True, use_sigmoid=True)
MC = dict(colors=2, nclasses=4, use_batchnorm=True)
ATOL = 1e-4


def _highest():
    return jax.default_matmul_precision("highest")


def _pair(multichannel=False, seed=0):
    """(JAX eval trainer, port eval-mode Trainer on the CPU) with the
    same weights."""
    ae_class, kw = (("MultiChannelAE", MC) if multichannel
                    else ("VanillaACAI", {}))
    model, params, stats = jax_family_model(ae_class, seed, **kw)
    jt = jax_eval_trainer(model, params, stats,
                          "multichannel" if multichannel else "ae")
    args = (dict(model="multichannel_combined", dataset="ACDCLBL", **MC)
            if multichannel else dict(model="ae_combined", dataset="OASIS"))
    pt = Trainer({**args, **NET, "lr": 1e-4}, eval_mode=True, device="cpu")
    pt.model.load_state_dict(flax_to_torch(params, stats, pt.model_config,
                                           pt.model))
    return jt, pt


def _smooth(seed, shape):
    rng = np.random.RandomState(seed)
    import scipy.ndimage

    a = scipy.ndimage.gaussian_filter(rng.rand(*shape), 1.5)
    return ((a - a.min()) / (a.max() - a.min())).astype(np.float32)


def _volumes(cls, n=2, s=9, hw=32, labels=False):
    out = []
    for i in range(n):
        img = _smooth(i, (s, hw, hw))
        hr = np.clip(img + 0.02 * _smooth(i + 10, (s, hw, hw)), 0, 1)
        lbl = (np.digitize(img, [0.3, 0.5, 0.7]).astype(np.int32)
               if labels else None)
        out.append(cls(image=img, spacing=np.array([2.0, 1.0, 1.0]),
                       image_hr=hr.astype(np.float32), labels=lbl,
                       patient_id="p"))
    return out


def _assert_metrics(got, want):
    """Metric dicts ({'per_volume', 'aggregate'} or flat) equal within
    ATOL, keys and order of volumes included."""
    if "per_volume" in want:
        assert list(got["per_volume"]) == list(want["per_volume"])
        for pid in want["per_volume"]:
            _assert_metrics(got["per_volume"][pid], want["per_volume"][pid])
        _assert_metrics(got["aggregate"], want["aggregate"])
        return
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(np.asarray(got[k], np.float64),
                                   np.asarray(want[k], np.float64),
                                   atol=ATOL, err_msg=k)


# ---------------------------------------------------------------------------
# reconstruction, rigid transforms, brain driver
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("multichannel", [False, True])
def test_evaluate_model_reconstruction_matches_jax(multichannel,
                                                   monkeypatch):
    """Scores of every slice's reconstruction (a colors-2 model takes the
    labels as its second plane), through a chunked predict (a decode
    budget of 4 slices) in the port; ids uniquified as JAX's."""
    from superresolution_aniso_mri_tpu_torch.infer import super_volume

    jt, pt = _pair(multichannel)
    monkeypatch.setattr(super_volume, "_DECODE_ACT_BUDGET_BYTES",
                        4 * 32 * 32 * 32 * 4 * 4)
    with _highest():
        want = jev.evaluate_model_reconstruction(
            jt, _volumes(JaxVolume, labels=multichannel))
    got = tev.evaluate_model_reconstruction(
        pt, _volumes(Volume, labels=multichannel))
    assert list(got["per_volume"]) == ["p", "p#2"]
    _assert_metrics(got, want)
    with pytest.raises(ValueError, match="no volumes"):
        tev.evaluate_model_reconstruction(pt, [])


def test_rigid_transformation_table_matches_jax():
    """Angles 0 and 10: the input, its HR reference and its labels rotate
    together; each angle's aggregate equals JAX's. A 4D volume raises."""
    jt, pt = _pair()
    jvol, tvol = (_volumes(cls, n=1, labels=True)[0]
                  for cls in (JaxVolume, Volume))
    with _highest():
        want = jev.test_interpolation_with_rigid_transformations(
            jt, jvol, 2, angles=(0, 10))
    got = rigid_table(pt, tvol, 2, angles=(0, 10))
    assert list(got) == [0, 10]
    for angle in (0, 10):
        _assert_metrics(got[angle], want[angle])
    assert got[0]["ssim"][0] != pytest.approx(got[10]["ssim"][0], abs=1e-6)
    with pytest.raises(ValueError, match="3D"):
        rigid_table(pt, Volume(image=np.zeros((2, 9, 8, 8), np.float32),
                               spacing=np.ones(3)), 2)
    assert rigid_table.__test__ is False


@pytest.mark.parametrize("dataset", ["MNIST3D", "MNISTRoto"])
def test_create_brain_volumes_matches_jax(dataset, tmp_path):
    """The toy datasets' validation phantoms synthesized, scored and
    saved as JAX's driver does (``width`` consumed, not passed on)."""
    jt, pt = _pair()
    with _highest():
        want = jev.create_brain_volumes(jt, dataset, 2, width=32,
                                        output_dir=str(tmp_path / "j"))
    got = tev.create_brain_volumes(pt, dataset, 2, width=32,
                                   output_dir=str(tmp_path / "t"))
    _assert_metrics(got, want)
    assert sorted(os.listdir(tmp_path / "t")) == sorted(
        os.listdir(tmp_path / "j"))
    # the interp-performance wrapper is create_hr_images without saving
    wrapped = tev.evaluate_interpolation_performance(
        pt, _volumes(Volume, n=1), 2, output_dir=str(tmp_path / "w"))
    assert not any(n.endswith(".nii.gz") for _, _, files in
                   os.walk(tmp_path / "w") for n in files)
    assert np.isfinite(wrapped["aggregate"]["ssim"][0])


# ---------------------------------------------------------------------------
# quantitative comparison of saved volumes
# ---------------------------------------------------------------------------

def _write_cases(root):
    """(reference files, method files): a 3D pair with 2 verbatim tail
    slices, a 4D pair, a single-frame 4D reference against a 3D method
    file, and a second '<pat>.nii.gz' in another directory."""
    rng = np.random.RandomState(3)
    ref3 = _smooth(20, (11, 24, 24))
    up3 = np.clip(ref3 + 0.05 * rng.rand(*ref3.shape), 0, 1)
    ref4 = np.stack([_smooth(21 + t, (9, 24, 24)) for t in range(3)])
    up4 = np.clip(ref4 + 0.05 * rng.rand(*ref4.shape), 0, 1)
    refs, ups = [], []
    cases = [("a", ref3, up3), ("b", ref4, up4),
             ("c", ref3[None], up3 * 0.9), ("d/a", ref3, up3 ** 1.1)]
    for name, ref, up in cases:
        for kind, arr, out in (("ref", ref, refs), ("up", up, ups)):
            path = os.path.join(root, kind, f"{name}.nii.gz")
            os.makedirs(os.path.dirname(path), exist_ok=True)
            jax_write(path, np.asarray(arr, np.float32))
            out.append(path)
    return refs, ups


@pytest.mark.parametrize("normalize", [False, True])
def test_compare_quantitative_matches_jax(normalize, tmp_path):
    """Every case of ``_write_cases`` scored (tail rule, 4D frame by
    frame, the single-frame squeeze, uniquified basenames), the npz
    written and read back, the latex row, as JAX's."""
    refs, ups = _write_cases(str(tmp_path))
    jout, tout = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    want = jev.compare_quantitative(refs, ups, 2, output_file=jout,
                                    normalize=normalize)
    got = tev.compare_quantitative(refs, ups, 2, output_file=tout,
                                   normalize=normalize, device="cpu")
    assert list(got["per_volume"]) == ["a.nii.gz", "b.nii.gz", "c.nii.gz",
                                       "a.nii.gz#2"]
    _assert_metrics(got, want)
    g, w = tev.load_results(tout), jev.load_results(jout)
    assert sorted(g) == sorted(w)
    np.testing.assert_array_equal(g["patient_ids"], w["patient_ids"])
    for k in w:
        if k != "patient_ids":
            np.testing.assert_allclose(g[k], w[k], atol=ATOL)
    assert tev.format_latex_string(got["aggregate"]) == \
        jev.format_latex_string(want["aggregate"])
    for n, ds in ((9, 2), (11, 4), (7, 3)):
        np.testing.assert_array_equal(tev.generate_synth_slices_mask(n, ds),
                                      jev.generate_synth_slices_mask(n, ds))
    with pytest.raises(ValueError, match="one-to-one"):
        tev.compare_quantitative(refs, ups[:1], 2, device="cpu")
    with pytest.raises(ValueError, match="no volumes"):
        tev.compare_quantitative([], [], 2, device="cpu")


# ---------------------------------------------------------------------------
# perceptual path length
# ---------------------------------------------------------------------------

def test_compute_ppl_matches_jax():
    """4 pairs of 32² slices: the pair and t draws, the SR-routed
    encode / decode and LPIPS (resolved once, lin weights over random
    VGG features here) give JAX's path length. The kernels are doubled
    so that the decoder is not nearly constant (else the path length is
    float32 noise). At ``epsilon`` 1e-2 the two agree within rel 1e-4;
    at the default 1e-4 two float32 decodes 1e-4 apart differ by
    ~6.6e-5, whose float32 rounding alone (~1e-3 of it) moves the
    squared LPIPS difference by ~2e-3 in either package: rel 1e-2."""
    from superresolution_aniso_mri_tpu_torch.evaluate import ppl

    model, params, stats = jax_family_model("VanillaACAI", 0)
    params = jax.tree_util.tree_map_with_path(
        lambda p, v: 2 * v if str(getattr(p[-1], "key", "")) == "kernel"
        else v, params)
    jt = jax_eval_trainer(model, params, stats)
    pt = Trainer(dict(model="ae_combined", dataset="OASIS", **NET, lr=1e-4),
                 eval_mode=True, device="cpu")
    pt.model.load_state_dict(flax_to_torch(params, stats, pt.model_config,
                                           pt.model))
    pool = np.random.RandomState(3).rand(6, 32, 32).astype(np.float32)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for eps, rel in ((1e-2, 1e-4), (1e-4, 1e-2)):
            with _highest():
                want = jev.compute_ppl(jt, pool, num_pairs=4, seed=3,
                                       epsilon=eps)
            got = tev.compute_ppl(pt, pool, num_pairs=4, seed=3, epsilon=eps)
            assert got == pytest.approx(want, rel=rel), eps
    assert got > 0.1
    assert "cpu" in ppl._PPL_LPIPS
    assert tev.compute_ppl(pt, pool, num_pairs=4, seed=3) == got


# ---------------------------------------------------------------------------
# SAX → LAX
# ---------------------------------------------------------------------------

def test_grid_sample_3d_matches_jax():
    """Random coordinates beyond [-1, 1], exactly ±1 on every axis, and
    the corners: JAX's trilinear gather (align_corners=True, zeros
    outside)."""
    from superresolution_aniso_mri_tpu.evaluate.sax_to_lax import (
        grid_sample_3d as jax_sample)

    rng = np.random.RandomState(5)
    vol = rng.rand(5, 7, 9).astype(np.float32)
    grid = rng.uniform(-1.3, 1.3, (4, 6, 8, 3)).astype(np.float32)
    grid[0, 0, :, 0] = 1.0
    grid[0, 1, :, 1] = 1.0
    grid[0, 2, :, 2] = 1.0
    grid[1, 0] = -1.0
    grid[1, 1] = 1.0
    grid[1, 2, :, :] = np.array([1.0, -1.0, 1.0], np.float32)
    want = np.asarray(jax_sample(jnp.asarray(vol), jnp.asarray(grid)))
    got = tev.grid_sample_3d(torch.from_numpy(vol),
                             torch.from_numpy(grid)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)
    assert got[1, 1, 0] == pytest.approx(vol[-1, -1, -1], abs=1e-6)
    # a point more than one voxel off the volume on some axis is 0
    limit = 1.0 + 2.0 / (np.array([9, 7, 5], np.float32) - 1)
    off = (np.abs(grid) > limit).any(-1)
    assert off.any() and (got[off] == 0).all()


def test_resample_sax_to_lax_matches_jax():
    """A 2-frame cine through ``make_transform`` of rotated geometries
    onto a [2, 3, 10, 12] LAX grid; the frame-count check."""
    rng = np.random.RandomState(6)
    sax = rng.rand(2, 6, 10, 12).astype(np.float32)
    lax_shape = (3, 10, 12)
    ident = jev.make_lax_identity_grid(lax_shape)
    np.testing.assert_array_equal(tev.make_lax_identity_grid(lax_shape),
                                  ident)
    np.testing.assert_array_equal(tev.make_identity_grid((2, 3, 4)),
                                  jev.make_identity_grid((2, 3, 4)))

    def affine(scale, angle, shift):
        c, s = math.cos(angle), math.sin(angle)
        S = np.diag(list(scale) + [1.0])
        R = np.array([[c, -s, 0, 0], [s, c, 0, 0], [0, 0, 1, 0],
                      [0, 0, 0, 1]])
        T = np.eye(4)
        T[:3, 3] = shift
        return S, R, T

    mats = affine((1.0, 1.0, 2.0), 0.3, (1.0, -2.0, 0.5)) + affine(
        (1.0, 1.0, 1.5), -0.1, (0.0, 0.5, 0.0))
    grid_j = jev.make_transform(ident, lax_shape, sax.shape[1:], *mats)
    grid_t = tev.make_transform(ident, lax_shape, sax.shape[1:], *mats)
    np.testing.assert_array_equal(grid_t, grid_j)
    want = jev.resample_sax_to_lax(sax, (2,) + lax_shape, grid_j)
    got = tev.resample_sax_to_lax(sax, (2,) + lax_shape, grid_t,
                                  device="cpu")
    np.testing.assert_allclose(got, want, atol=1e-6)
    assert np.abs(got).max() > 0
    with pytest.raises(ValueError, match="frame-count"):
        tev.resample_sax_to_lax(sax, (3,) + lax_shape, grid_t, device="cpu")


# ---------------------------------------------------------------------------
# numpy copies: segmentation and clinical metrics, the AE+CAISR merge
# ---------------------------------------------------------------------------

def test_seg_metrics_match_jax():
    from superresolution_aniso_mri_tpu.evaluate import seg_metrics as jseg

    rng = np.random.RandomState(7)
    import scipy.ndimage

    def blob(seed):
        r = np.random.RandomState(seed)
        return scipy.ndimage.gaussian_filter(r.rand(6, 16, 16), 2) > 0.5

    a, b = blob(1), blob(2)
    sp = (2.0, 1.0, 0.5)
    for name in ("dc", "jc", "precision", "recall", "sensitivity",
                 "specificity", "ravd"):
        assert getattr(tev.seg_metrics, name)(a, b) == \
            getattr(jseg, name)(a, b), name
    for name in ("hd", "hd95", "asd", "assd"):
        for kw in ({}, {"voxelspacing": sp}, {"connectivity": 2}):
            assert getattr(tev.seg_metrics, name)(a, b, **kw) == \
                getattr(jseg, name)(a, b, **kw), (name, kw)
    cases = [blob(s) for s in range(3, 7)]
    refs = [c ^ (rng.rand(*c.shape) > 0.97) for c in cases]
    assert tev.seg_metrics.volume_correlation(cases, refs) == \
        jseg.volume_correlation(cases, refs)
    for mod in (tev.seg_metrics, jseg):
        with pytest.raises(RuntimeError, match="empty"):
            mod.hd(np.zeros((3, 3), bool), a[0])


def test_clinical_metrics_match_jax():
    rng = np.random.RandomState(8)
    labels4d = rng.randint(0, 4, (6, 3, 8, 8))
    curves_t = tev.volumes_over_time(labels4d, 0.125)
    curves_j = jev.volumes_over_time(labels4d, 0.125)
    for k in curves_j:
        np.testing.assert_array_equal(curves_t[k], curves_j[k])
    for frames in ({}, {"ed_frame": 1, "es_frame": 4}):
        assert tev.compute_phase_volumes(curves_t, **frames) == \
            jev.compute_phase_volumes(curves_j, **frames)
    for curve in (curves_t["LV"], [3.0], np.arange(5.0)):
        np.testing.assert_equal(tev.peak_rates(curve, 0.05),
                                jev.peak_rates(curve, 0.05))
    for n in (0, 1, 2):
        np.testing.assert_array_equal(
            tev.exchange_base_apex(labels4d[0], labels4d[1], n),
            jev.exchange_base_apex(labels4d[0], labels4d[1], n))
    ba_t = tev.bland_altman_arrays(curves_t["LV"], curves_t["RV"])
    ba_j = jev.bland_altman_arrays(curves_j["LV"], curves_j["RV"])
    for k in ba_j:
        np.testing.assert_array_equal(ba_t[k], ba_j[k])
    assert tev.structure_volume(labels4d[0], 3, 0.5) == \
        jev.structure_volume(labels4d[0], 3, 0.5)


def test_combine_volumes_matches_jax():
    rng = np.random.RandomState(9)
    for shape, ds in (((9, 4, 4), 2), ((3, 11, 4, 4), 3), ((10, 4, 4), 4)):
        ae, caisr = rng.rand(*shape), rng.rand(*shape)
        np.testing.assert_array_equal(tev.combine_volumes(ae, caisr, ds),
                                      jev.combine_volumes(ae, caisr, ds))
    ae = {"p": {"image": rng.rand(9, 4, 4), "spacing": (1, 1, 1)}}
    caisr = {"p": {"image": rng.rand(9, 4, 4)}}
    got, want = (mod.create_combined_images(ae, caisr, 2)
                 for mod in (tev, jev))
    np.testing.assert_array_equal(got["p"]["image"], want["p"]["image"])
    assert got["p"]["spacing"] == want["p"]["spacing"]


# ---------------------------------------------------------------------------
# model registry
# ---------------------------------------------------------------------------

REGISTRY = """\
# paper models
my_caisr_acdc:
  path: ~/expers/sr/ACDC/ae_combined/f0_128
  checkpoint: caisr        # or an epoch number
  downsample_steps: 2

brain_ae: {path: /data/expers/oasis, checkpoint: 120, downsample_steps: 4}
'quoted name':
  path: "exp dir/with spaces"
  checkpoint: '0'
empty_ckpt:
  path: /x
  checkpoint:
"""


def test_load_model_specs_matches_jax(tmp_path):
    path = tmp_path / "models.yaml"
    path.write_text(REGISTRY)
    assert treg.load_model_specs(str(path)) == jreg.load_model_specs(
        str(path))
    for text, match in (("a: 1\n", "must be a mapping"),
                        ("a:\n  checkpoint: 3\n", "no 'path'"),
                        ("a:\n", "must be a mapping")):
        path.write_text(text)
        for mod in (treg, jreg):
            with pytest.raises(ValueError, match=match):
                mod.load_model_specs(str(path))
    reg_t, reg_j = {}, {}
    treg.register_model(reg_t, "m", "~/e", checkpoint=3, note="x")
    jreg.register_model(reg_j, "m", "~/e", checkpoint=3, note="x")
    assert reg_t == reg_j


@pytest.mark.parametrize("text", ["a:\n  - 1\n", "a:\n  b: [1]\n",
                                  "a: {b: {c: 1}}\n", "- a\n",
                                  "a:\n  b: 1\n   c: 2\n", "a: &x 1\n"])
def test_registry_reader_refuses_other_yaml(text):
    with pytest.raises(ValueError):
        parse_model_registry(text)


@pytest.mark.parametrize("ckpt, want", [(None, "caisr"), ("7", 7), (0, 0),
                                        ("ema", "ema")])
def test_get_trainer_for_spec_checkpoint_rules(ckpt, want, monkeypatch):
    """JAX's rules: an empty checkpoint is 'caisr', a digit string an
    epoch number, an explicit epoch 0 stays 0; eval mode."""
    from superresolution_aniso_mri_tpu_torch import train

    calls = []
    monkeypatch.setattr(train, "get_trainer",
                        lambda *a, **kw: calls.append((a, kw)))
    treg.get_trainer_for_spec({"path": "/e", "checkpoint": ckpt},
                              device="cpu")
    assert calls == [(("/e",), dict(model_nbr=want, eval_mode=True,
                                    device="cpu"))]


ADVERSARIAL = ["null", "~", "", "yes", "No", "on", "true", "1.0", "1e3",
               "-1", "0x1F", "017", "1_000", "1:30", "2001-12-14", ".inf",
               ".nan", "a: b", "a:b", "-a", "- a", "#a", "a #b", "a#b",
               "'q'", '"q"', "it's", " lead", "trail ", "a\nb", "a\n\n b",
               "\\", "x" * 90 + " y", "word " * 40, "é", "{a}", "[b]",
               "c, d"]
names = st.from_regex(r"[a-z_][a-z0-9_]{0,20}", fullmatch=True)
scalars = st.one_of(
    st.none(), st.booleans(), st.integers(-2 ** 40, 2 ** 40),
    st.floats(allow_nan=False, allow_infinity=True),
    st.sampled_from(ADVERSARIAL),
    st.text(alphabet=st.characters(min_codepoint=1, max_codepoint=0x2030),
            max_size=100))
entries = st.one_of(st.dictionaries(names, scalars, min_size=1, max_size=5),
                    scalars)


@settings(max_examples=200, deadline=None)
@given(st.dictionaries(names, entries, max_size=5))
def test_registry_reader_matches_pyyaml(registry):
    """Registries as ``yaml.safe_dump`` writes them (block style) read
    as ``yaml.safe_load`` reads them."""
    text = yaml.safe_dump(registry, sort_keys=False)
    assert parse_model_registry(text) == (yaml.safe_load(text) or {})


@settings(max_examples=100, deadline=None)
@given(st.dictionaries(names, st.dictionaries(
    names, st.one_of(st.none(), st.booleans(), st.integers(-999, 999),
                     st.from_regex(r"[~/a-z0-9_.-]{1,20}", fullmatch=True)),
    min_size=1, max_size=4), max_size=4))
def test_registry_reader_matches_pyyaml_in_flow_style(registry):
    """One-line flow entries (``name: {path: ..., checkpoint: 3}``)."""
    text = "".join(f"{name}: " + yaml.safe_dump(entry, default_flow_style=True,
                                                 width=1 << 16)
                   for name, entry in registry.items())
    assert parse_model_registry(text) == (yaml.safe_load(text) or {})
