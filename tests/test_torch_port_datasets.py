"""PyTorch port, on-disk datasets: the loaders, their split files and
``get_datasets`` held against the JAX package on the CPU.

Trees are fabricated in the real layouts: OASIS, dHCP and ACDC by
``tools/dress_rehearsal.py``, ADNI and brainMASI as in
``tests/test_datasets_ingest.py``. Both packages must return the same
patient ids in the same order, bitwise equal arrays and equal spacings.
Split files: the port's reader equals ``yaml.safe_load`` and its writer
``yaml.safe_dump`` over hypothesis-generated id lists, and
``create_split_file`` writes JAX's bytes.
"""
import os
import sys
import warnings

import numpy as np
import pytest
import yaml
from hypothesis import given, settings, strategies as st

from superresolution_aniso_mri_tpu.data import datasets as jd
from superresolution_aniso_mri_tpu.data import volume as jv
from superresolution_aniso_mri_tpu.utils import write_nifti
from superresolution_aniso_mri_tpu_torch.config import (
    dump_string_lists, parse_string_lists)
from superresolution_aniso_mri_tpu_torch.config import data_config as tdc
from superresolution_aniso_mri_tpu_torch.data import datasets as td
from superresolution_aniso_mri_tpu_torch.data import volume as tv

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))
import dress_rehearsal  # noqa: E402

ROOT_KEYS = ("OASIS", "dHCP_cropped_256", "ACDC", "ADNI", "BrainMASI_LR_co")


def _adni_tree(root):
    """ADNI/<patient>/MPRAGE/<scan>/<name>[_3mm].nii (plain .nii)."""
    rng = np.random.RandomState(4)
    for i, (pid, scan) in enumerate([("002_S_0001", "S100"),
                                     ("002_S_0001", "S101"),
                                     ("011_S_0002", "S200"),
                                     ("011_S_0003", "S300")]):
        d = os.path.join(root, "ADNI", pid, "MPRAGE", scan)
        os.makedirs(d, exist_ok=True)
        hr = rng.rand(9, 14, 12).astype(np.float32) * 800
        write_nifti(os.path.join(d, f"ADNI_{pid}_{scan}.nii"), hr,
                    spacing=np.array([1.2, 1.0, 1.0]))
        write_nifti(os.path.join(d, f"ADNI_{pid}_{scan}_3mm.nii"),
                    jv.simulate_thick_slices(hr, 3.0),
                    spacing=np.array([1.2, 1.0, 1.0]))


def _masi_tree(root):
    """BrainMASI_LR_co/{Training,Test}/images/*.nii.gz (HR volumes)."""
    rng = np.random.RandomState(5)
    for d, n in (("Training", 3), ("Test", 2)):
        path = os.path.join(root, "BrainMASI_LR_co", d, "images")
        os.makedirs(path, exist_ok=True)
        for i in range(n):
            write_nifti(os.path.join(path, f"{d[:2].lower()}{i}.nii.gz"),
                        rng.rand(8, 12, 10).astype(np.float32) * 3)


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("data"))
    dress_rehearsal.make_oasis_tree(root, ds=3, n_patients=7)
    dress_rehearsal.make_dhcp_tree(root, ds=2, n_patients=6)
    dress_rehearsal.make_acdc_tree(root, n_patients=5)
    _adni_tree(root)
    _masi_tree(root)
    old = os.environ.get("SR_DATA_ROOT")
    os.environ["SR_DATA_ROOT"] = root
    yield root
    if old is None:
        del os.environ["SR_DATA_ROOT"]
    else:
        os.environ["SR_DATA_ROOT"] = old


def _assert_same_volumes(got, want):
    assert [v.patient_id for v in got] == [v.patient_id for v in want]
    assert want, "empty split"
    for g, w in zip(got, want):
        assert g.image.dtype == w.image.dtype
        assert np.array_equal(g.image, w.image), g.patient_id
        assert np.array_equal(np.asarray(g.spacing), np.asarray(w.spacing))
        for key in ("original_spacing", "image_hr"):
            a, b = getattr(g, key), getattr(w, key)
            assert (a is None) == (b is None), key
            if a is not None:
                assert np.array_equal(a, b), key
        assert (g.frame_id, g.num_frames) == (w.frame_id, w.num_frames)


@pytest.mark.parametrize("dataset, ds", [("OASIS", 3), ("dHCP", 2),
                                         ("ADNI", 3), ("brainMASI", 3),
                                         ("ACDC", 2), ("ACDCC", 2)])
def test_get_datasets_matches_jax(data_root, dataset, ds):
    args = dict(dataset=dataset, downsample_steps=ds, width=16)
    for got, want in zip(td.get_datasets(args), jd.get_datasets(args)):
        _assert_same_volumes(got, want)


@pytest.mark.parametrize("dataset, ds", [("OASIS", 3), ("dHCP", 2),
                                         ("ADNI", 3), ("brainMASI", 3)])
@pytest.mark.parametrize("split", ["training", "validation", "test"])
def test_brain_loaders_match_jax(data_root, dataset, ds, split):
    kw = dict(split=split, include_hr_images=True)
    _assert_same_volumes(td.load_brain_volumes(dataset, ds, **kw),
                         jd.load_brain_volumes(dataset, ds, **kw))
    kw = dict(split=split, limited_load=True, rescale_int=False)
    _assert_same_volumes(td.load_brain_volumes(dataset, ds, **kw),
                         jd.load_brain_volumes(dataset, ds, **kw))


def test_acdc_default_split_and_frame_limit_match_jax(data_root, tmp_path):
    """Without a split file ACDC uses the reference's 5 mm split; the
    bad-frame limits trim patients 015/034/045."""
    split = os.path.join(data_root, "ACDC", "train_val_test_split_sr.yaml")
    os.rename(split, split + ".off")
    try:
        for s in ("training", "validation", "test"):
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                got = td.load_acdc_volumes(s, frame_limit=2)
                want = jd.load_acdc_volumes(s, frame_limit=2)
            if want:
                _assert_same_volumes(got, want)
            else:
                assert got == []
    finally:
        os.rename(split + ".off", split)
    ids = [f"patient{i:03d}" for i in range(1, 101)]
    rng = np.random.RandomState(0)
    for _ in range(5):
        pick = list(rng.choice(ids, rng.randint(3, 90), replace=False))
        assert td.acdc_default_split(pick) == jd.acdc_default_split(pick)
    assert td.ACDC_5MM_PATIENTS == jd.ACDC_5MM_PATIENTS
    assert td.ACDC_BAD_FRAME_LIMITS == jd.ACDC_BAD_FRAME_LIMITS
    for pid in ("patient015", "patient034_f00", "patient045", "patient001"):
        assert td.acdc_frame_limit(pid) == jd.acdc_frame_limit(pid)


def test_split_patients_and_ids_match_jax(data_root):
    rng = np.random.RandomState(1)
    for n in (1, 2, 3, 8, 25):
        ids = [f"p{int(v)}" for v in rng.randint(0, 1000, n)]
        assert td._split_patients(ids, None) == jd._split_patients(ids, None)
    for dataset, sub, suffix in (("OASIS", "OASIS", "_3mm.nii.gz"),
                                 ("dHCP", "dHCP_cropped_256", "mm.nii.gz"),
                                 ("ADNI", "ADNI", "_3mm.nii"),
                                 ("ACDC", "ACDC", "4d.nii.gz")):
        root = os.path.join(data_root, sub)
        files = td._find_files(root, suffix)
        assert files and files == jd._find_files(root, suffix)
        for f in files:
            assert (td._patient_id_from_file(dataset, f, root)
                    == jd._patient_id_from_file(dataset, f, root))


def test_data_configs_match_jax(data_root):
    from superresolution_aniso_mri_tpu.config import data_config as jdc

    for name in sorted(jdc._BUILDERS):
        got, want = tdc.get_config(name), jdc.get_config(name)
        for field in ("dataset", "img_file_ext", "data_root_dir",
                      "image_dir", "split_file", "limited_load_max",
                      "tissue_structure_labels"):
            assert getattr(got, field) == getattr(want, field), (name, field)
        assert np.array_equal(got.voxel_spacing_resample,
                              want.voxel_spacing_resample)
        for ds in (2, 3, 4):
            try:
                expect = want.lr_file_suffix(ds)
            except NotImplementedError:
                with pytest.raises(NotImplementedError):
                    got.lr_file_suffix(ds)
                continue
            assert got.lr_file_suffix(ds) == expect
    with pytest.raises(ValueError, match="unknown dataset"):
        tdc.get_config("nope")


def test_create_lr_dataset_matches_jax(tmp_path):
    from superresolution_aniso_mri_tpu.utils import read_nifti

    rng = np.random.RandomState(2)
    for pkg in ("jax", "port"):
        pdir = tmp_path / pkg / "OAS1_0001_MR1"
        os.makedirs(pdir)
        write_nifti(str(pdir / "OAS1_0001_MR1_t88_gfc.nii.gz"),
                    np.random.RandomState(2).rand(10, 8, 8).astype(
                        np.float32), spacing=np.array([1.0, 1.0, 1.0]))
    want = jd.create_lr_dataset("OASIS", 4, src_path=str(tmp_path / "jax"))
    got = td.create_lr_dataset("OASIS", 4, src_path=str(tmp_path / "port"))
    assert [os.path.basename(p) for p in got] == [
        os.path.basename(p) for p in want]
    assert np.array_equal(read_nifti(got[0])[0], read_nifti(want[0])[0])
    with pytest.raises(ValueError, match="overwrite"):
        td.create_lr_dataset("brainMASI", 3, src_path=str(tmp_path))
    hr = rng.rand(12, 6, 5).astype(np.float32)
    assert np.array_equal(tv.create_lr_volume(hr, 3, subsample=True),
                          jv.create_lr_volume(hr, 3, subsample=True))


def test_acdclbl_from_disk_raises_with_roadmap_item(data_root):
    """ACDCLBL reads the labeled ED/ES frames beside the cines, as JAX
    does: the same frames and splits, the images bitwise, the labels
    exact; ARVC (eval-only) still raises."""
    args = dict(dataset="ACDCLBL", downsample_steps=2)
    got, want = td.get_datasets(args), jd.get_datasets(args)
    for g_split, w_split in zip(got, want):
        assert [v.patient_id for v in g_split] == [
            v.patient_id for v in w_split]
        for g, w in zip(g_split, w_split):
            assert np.array_equal(g.image, w.image)
            assert g.labels.dtype == w.labels.dtype == np.int32
            assert np.array_equal(g.labels, w.labels)
            np.testing.assert_array_equal(g.spacing, w.spacing)
    assert got[0] and got[1] and all("_frame" in v.patient_id
                                     for v in got[0] + got[1])
    with pytest.raises(ValueError, match="unknown dataset"):
        td.get_datasets(dict(dataset="ARVC", downsample_steps=2))


# ---------------------------------------------------------------------------
# split files
# ---------------------------------------------------------------------------

IDS = st.lists(st.one_of(
    st.text(st.characters(codec="ascii"), max_size=12),
    st.text(max_size=6),
    st.sampled_from(["1000", "001", "yes", "null", "~", "- x", "a: b", "#c",
                     "it's", "1e3", "0x1F", ".5", "", " x ", "OAS1_0001_MR1",
                     "x" * 90 + " y"])), max_size=6)


@settings(max_examples=300, deadline=None)
@given(st.dictionaries(st.sampled_from(["training", "validation", "test",
                                        "extra"]), IDS))
def test_split_file_writer_and_reader_equal_pyyaml(split):
    text = yaml.safe_dump(split)
    assert dump_string_lists(split) == text
    assert parse_string_lists(text) == yaml.safe_load(text)


@pytest.mark.parametrize("text", [
    "{training: [a, b], test: [], validation: [c]}\n",
    "training: [a, 'b', \"c\"]\ntest: []\n",
    "training:\n  - 1000\n  - '001'\n# a comment\nvalidation:\n- y  # note\n",
    "training:\n- a\n- long\n  folded id\ntest: [1, 2.5, true, null]\n",
])
def test_split_file_reader_takes_flow_and_hand_written_block_style(text):
    assert parse_string_lists(text) == yaml.safe_load(text)


@pytest.mark.parametrize("text", [
    "training: a\n", "training:\n  sub: [a]\n", "- a\n",
    "training:\n- [a]\n", "a: [b\n", "training:\n- a\ntraining:\n- b\n",
])
def test_split_file_reader_refuses_what_is_not_a_split(text):
    with pytest.raises(ValueError, match="split.yaml"):
        parse_string_lists(text, "split.yaml")


@pytest.mark.parametrize("n", [5, 30])
def test_create_split_file_is_byte_equal_to_jax(tmp_path, n):
    ids = [f"OAS1_{i:04d}_MR1" for i in range(n)] + ["1000", "yes"]
    os.makedirs(tmp_path / "jax")
    os.makedirs(tmp_path / "port")
    want = jd.create_split_file(str(tmp_path / "jax"), ids, (3, 1, 1))
    got = td.create_split_file(str(tmp_path / "port"), ids, (3, 1, 1))
    with open(want, "rb") as a, open(got, "rb") as b:
        assert a.read() == b.read()
    assert td._split_patients([], got) == jd._split_patients([], want)
