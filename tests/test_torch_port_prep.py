"""PyTorch port's dataset preparation, eval-only loaders and image
utilities against the JAX package, on the CPU at small sizes: the
quality phantoms (``data/synthetic.py``), brainMASI (``data/masi.py``),
dHCP (``create_dhcp_dataset``), the ACDC SR-segmentation set, its
uncertainty loaders, centering and label volumes (``data/acdc_aux.py``),
the sunnybrook / ARVC / SAX loaders, the DICOM reader and
``utils/image_misc.py``.

All of it is numpy / scipy copied from the JAX package: the tolerance
is equality — equal arrays, equal dicts (NaN where JAX has NaN), equal
errors, and written NIfTI files whose decompressed payloads are equal
byte for byte.
"""
import gzip
import os
import warnings

import numpy as np
import pytest

import superresolution_aniso_mri_tpu.data.acdc_aux as j_aux
import superresolution_aniso_mri_tpu.data.datasets as j_ds
import superresolution_aniso_mri_tpu.data.masi as j_masi
import superresolution_aniso_mri_tpu.data.synthetic as j_syn
import superresolution_aniso_mri_tpu.utils.dicom as j_dicom
import superresolution_aniso_mri_tpu.utils.image_misc as j_misc
import superresolution_aniso_mri_tpu_torch.data.acdc_aux as p_aux
import superresolution_aniso_mri_tpu_torch.data.datasets as p_ds
import superresolution_aniso_mri_tpu_torch.data.masi as p_masi
import superresolution_aniso_mri_tpu_torch.data.synthetic as p_syn
import superresolution_aniso_mri_tpu_torch.utils.dicom as p_dicom
import superresolution_aniso_mri_tpu_torch.utils.image_misc as p_misc
from superresolution_aniso_mri_tpu_torch.utils import (write_image,
                                                       write_metaimage)
from test_dicom import _write_dicom


def _same(a, b, path="value"):
    """Structural equality: arrays equal (NaN where NaN), dicts with the
    same keys, sequences of the same length, objects by their fields."""
    if hasattr(a, "__dict__") and not isinstance(a, type):
        assert type(a).__name__ == type(b).__name__, path
        _same(vars(a), vars(b), path)
    elif isinstance(a, dict):
        assert set(a) == set(b), (path, set(a) ^ set(b))
        for k in a:
            _same(a[k], b[k], f"{path}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{path}[{i}]")
    elif isinstance(a, (np.ndarray, np.generic)) or isinstance(
            b, (np.ndarray, np.generic)):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, (path, a.dtype,
                                                           b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=path)
    elif isinstance(a, float) and np.isnan(a):
        assert isinstance(b, float) and np.isnan(b), path
    else:
        assert a == b, (path, a, b)


def _payload(path):
    with open(path, "rb") as f:
        raw = f.read()
    return gzip.decompress(raw) if path.endswith(".gz") else raw


def _same_files(written_j, written_p, out_j, out_p):
    rel_j = [os.path.relpath(f, out_j) for f in written_j]
    rel_p = [os.path.relpath(f, out_p) for f in written_p]
    assert rel_j == rel_p and rel_j
    for a, b in zip(written_j, written_p):
        assert _payload(a) == _payload(b), a


def _raises_alike(fn_j, fn_p, exc, exc_p=None):
    """Both raise (``exc``, and ``exc_p`` in the port where the class is
    the port's own copy) with the same message."""
    with pytest.raises(exc) as ej:
        fn_j()
    with pytest.raises(exc_p or exc) as ep:
        fn_p()
    assert str(ej.value) == str(ep.value)


# ---------------------------------------------------------------------------
# synthetic phantoms
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,kw", [
    ("make_textured_rotated_volume", dict(size=24, num_slices=5, seed=3)),
    ("make_anatomy3d_volume", dict(size=24, num_slices=9, seed=3)),
    ("make_anatomy3d_volume", dict(size=20, num_slices=7, seed=4,
                                   texture_amp=0.0)),
    ("make_cardiac4d_volume", dict(size=24, num_slices=7, num_frames=3,
                                   seed=3, noise_sigma=0.03)),
    ("make_cardiac4d_volume", dict(size=20, num_slices=5, num_frames=1,
                                   seed=5, texture_amp=0.0)),
])
def test_phantoms_match_jax(name, kw):
    _same(getattr(j_syn, name)(**kw), getattr(p_syn, name)(**kw))


def test_rician_noise_matches_jax():
    vol = np.random.RandomState(0).rand(3, 8, 8).astype(np.float32)
    for sigma, seed in ((0.05, 7), (0.0, 1), (-1.0, 2)):
        _same(j_syn.add_rician_noise(vol, sigma, seed),
              p_syn.add_rician_noise(vol, sigma, seed))


# ---------------------------------------------------------------------------
# brainMASI
# ---------------------------------------------------------------------------

def _brain(rng, shape=(20, 24, 18)):
    z, y, x = np.ogrid[:shape[0], :shape[1], :shape[2]]
    c = np.array(shape) / 2.0
    r = (((z - c[0]) / 7.0) ** 2 + ((y - c[1]) / 8.0) ** 2
         + ((x - c[2]) / 6.0) ** 2)
    lbl = np.where(r < 1.0, rng.randint(1, 7, shape), 0).astype(np.int32)
    img = (rng.rand(*shape) * 100 + 300 * (lbl > 0)).astype(np.float32)
    return img, lbl


def test_masi_helpers_match_jax():
    rng = np.random.RandomState(0)
    img, lbl = _brain(rng)
    for padding in (0, 3, 50):
        _same(j_masi.find_bbox(lbl[10], padding=padding),
              p_masi.find_bbox(lbl[10], padding=padding))
    _same(j_masi.find_bbox(np.zeros((5, 5))), p_masi.find_bbox(
        np.zeros((5, 5))))
    for axis in range(3):
        _same(j_masi.mask_axis_extent(lbl, axis),
              p_masi.mask_axis_extent(lbl, axis))
    _same(j_masi.foreground_mask(lbl), p_masi.foreground_mask(lbl))
    _same(j_masi.crop_to_brain(img, lbl, 32), p_masi.crop_to_brain(
        img, lbl, 32))
    _same(j_masi.masi_train_test_split(range(1000, 1020)),
          p_masi.masi_train_test_split(range(1000, 1020)))


def test_masi_datasets_write_the_same_files(tmp_path):
    """create_masi_cropped_dataset then create_masi_lr_dataset over a raw
    tree (NIfTI images, one MetaImage and NIfTI references): the same
    files with the same payloads; a missing reference raises alike."""
    rng = np.random.RandomState(1)
    raw = tmp_path / "raw"
    (raw / "manual_references" / "6classes").mkdir(parents=True)
    (raw / "images").mkdir()
    for i, pid in enumerate(range(1000, 1017)):
        img, lbl = _brain(rng)
        write_image(str(raw / "images" / f"{pid}.nii.gz"), img,
                    spacing=(1.2, 1.0, 0.9))
        ref = raw / "manual_references" / "6classes" / f"{pid}"
        if i == 0:
            write_metaimage(str(ref) + ".mhd", lbl, spacing=(1.2, 1.0, 0.9))
        else:
            write_image(str(ref) + ".nii.gz", lbl, dtype=np.int32)
    for kw in ({}, {"limited_load": True}):
        out_j, out_p = tmp_path / "cj", tmp_path / "cp"
        cj = j_masi.create_masi_cropped_dataset(str(raw), str(out_j),
                                                patch_size=32, **kw)
        cp = p_masi.create_masi_cropped_dataset(str(raw), str(out_p),
                                                patch_size=32, **kw)
        _same_files(cj, cp, out_j, out_p)
        lj = j_masi.create_masi_lr_dataset(str(out_j), str(tmp_path / "lj"),
                                           new_spacing_z=3.0, **kw)
        lp = p_masi.create_masi_lr_dataset(str(out_p), str(tmp_path / "lp"),
                                           new_spacing_z=3.0, **kw)
        _same_files(lj, lp, tmp_path / "lj", tmp_path / "lp")
        # 15 training patients (the reference split), the rest test
        assert sum("/test/" in f for f in cj) == (0 if kw else 2)
    os.remove(raw / "manual_references" / "6classes" / "1001.nii.gz")
    _raises_alike(
        lambda: j_masi.create_masi_cropped_dataset(str(raw), str(out_j)),
        lambda: p_masi.create_masi_cropped_dataset(str(raw), str(out_j)),
        FileNotFoundError)


# ---------------------------------------------------------------------------
# dHCP preparation and the eval-only loaders
# ---------------------------------------------------------------------------

def test_create_dhcp_dataset_writes_the_same_files(tmp_path):
    """Raw dHCP files (``_T2w`` and ``t2w`` names, one subject twice in
    two session directories, one empty volume): the same crops under
    the same names, the collisions uniquified alike."""
    rng = np.random.RandomState(2)
    raw = tmp_path / "raw"
    files = ["sub-01/ses-1/sub-01_ses-1_desc-restore_T2w.nii.gz",
             "sub-01/ses-2/sub-01_ses-2_desc-restore_T2w.nii.gz",
             "sub-02/sub-02_t2w.nii.gz", "sub-03/x/sub-02_t2w.nii.gz",
             "sub-04/sub-04_T2w.nii.gz"]
    for i, rel in enumerate(files):
        img, _ = _brain(rng, (14, 20, 16))
        if i == 4:
            img = np.zeros_like(img)
        os.makedirs(os.path.dirname(raw / rel), exist_ok=True)
        write_image(str(raw / rel), img, spacing=(0.5, 0.5, 0.5))
    wj = j_ds.create_dhcp_dataset(str(raw), str(tmp_path / "j"),
                                  patch_size=24)
    wp = p_ds.create_dhcp_dataset(str(raw), str(tmp_path / "p"),
                                  patch_size=24)
    assert len(wp) == 4
    _same_files(wj, wp, tmp_path / "j", tmp_path / "p")


def test_sunnybrook_loader_matches_jax(tmp_path):
    rng = np.random.RandomState(3)
    for pid, phases in (("SC-HF-I-01", ("ES", "ED")), ("SC-N-02", ("ES",))):
        for ph in phases:
            write_metaimage(str(tmp_path / f"{pid}_{ph}.mhd"),
                            rng.rand(4, 20, 22).astype(np.float32) * 200)
    for kw in ({}, dict(resample=False, rescale=False),
               dict(file_suffix="_ED.mhd"), dict(limited_load=True)):
        with warnings.catch_warnings(record=True) as wj:
            warnings.simplefilter("always")
            vj = j_ds.load_sunnybrook_volumes(str(tmp_path), **kw)
        with warnings.catch_warnings(record=True) as wp:
            warnings.simplefilter("always")
            vp = p_ds.load_sunnybrook_volumes(str(tmp_path), **kw)
        _same(vj, vp)
        assert [str(w.message) for w in wj] == [str(w.message) for w in wp]
    _raises_alike(lambda: j_ds.load_sunnybrook_volumes(str(tmp_path / "x")),
                  lambda: p_ds.load_sunnybrook_volumes(str(tmp_path / "x")),
                  FileNotFoundError)


def test_arvc_and_sax_loaders_match_jax(tmp_path):
    rng = np.random.RandomState(4)
    for i in range(4):
        pid = f"arvc{i:03d}"
        os.makedirs(tmp_path / "arvc" / pid)
        write_image(str(tmp_path / "arvc" / pid / f"{pid}_4d.nii.gz"),
                    rng.rand(3, 4, 18, 20).astype(np.float32) * 300,
                    spacing=(8.0, 1.6, 1.6))
    for split in ("training", "validation", "test"):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            _same(j_ds.load_arvc_volumes(split, src_path=str(
                tmp_path / "arvc")), p_ds.load_arvc_volumes(
                split, src_path=str(tmp_path / "arvc")))
    sax = tmp_path / "sax"
    sax.mkdir()
    write_image(str(sax / "a.nii.gz"), rng.rand(2, 5, 18, 20) * 100,
                spacing=(7.0, 1.3, 1.3))
    write_image(str(sax / "b.nii.gz"), rng.rand(5, 18, 20) * 100,
                spacing=(7.0, 1.2, 1.25))
    for kw in ({}, dict(resample=False, rescale=False),
               dict(new_spacing=(1.0, 1.0), limited_load=True,
                    limited_load_max=1)):
        _same(j_ds.load_sax_volumes(str(sax), **kw),
              p_ds.load_sax_volumes(str(sax), **kw))
    _raises_alike(lambda: j_ds.load_sax_volumes(str(sax), ".mha"),
                  lambda: p_ds.load_sax_volumes(str(sax), ".mha"),
                  FileNotFoundError)


# ---------------------------------------------------------------------------
# ACDC: the SR-segmentation set, uncertainty loaders, centering, labels
# ---------------------------------------------------------------------------

def test_fold_ids_and_info_cfg_match_jax(tmp_path):
    for fold in range(4):
        for ds in ("training", "validation", "full"):
            for limited in (False, True):
                _same(j_aux.get_acdc_fold_patient_ids(fold, ds, limited),
                      p_aux.get_acdc_fold_patient_ids(fold, ds, limited))
    cfg = tmp_path / "Info.cfg"
    cfg.write_text("ED: 1\nES: 12\nGroup: DCM\nHeight: 184.0\nnoise\n")
    _same(j_aux.parse_info_cfg(str(cfg)), p_aux.parse_info_cfg(str(cfg)))


@pytest.fixture()
def sr_seg_root(tmp_path):
    """The SR-seg layout under fold-0 validation ids (and patient029 of
    fold 2): 2-phase files, a 30-frame file with a 1-based Info.cfg, a
    2-phase file whose Info.cfg stores ES first, sub-millimetre
    spacings (the clause that bypasses resample=False and the
    patient029 pin), a patient without labels."""
    rng = np.random.RandomState(5)
    root = tmp_path / "sr"
    for d in ("images_sr", "ref_labels"):
        (root / d).mkdir(parents=True)
    cases = {16: (2, (5.0, 1.4, 1.4)), 17: (2, (5.0, 0.8, 0.8)),
             18: (6, (5.0, 1.4, 1.4)), 19: (2, (5.0, 1.4, 1.4)),
             29: (2, (5.0, 0.9, 0.9)), 36: (2, (5.0, 1.5, 1.5))}
    for num, (frames, sp) in cases.items():
        pid = f"patient{num:03d}"
        write_image(str(root / "images_sr" / f"{pid}.nii.gz"),
                    rng.rand(frames, 4, 20, 22).astype(np.float32) * 50,
                    spacing=sp)
        if num != 19:
            write_image(str(root / "ref_labels" / f"{pid}.nii.gz"),
                        rng.randint(0, 4, (frames, 4, 20, 22)),
                        spacing=sp, dtype=np.int32)
    for num, text in ((18, "ED: 1\nES: 6\n"), (36, "ED: 1\nES: 0\n")):
        d = root / "info" / f"patient{num:03d}"
        d.mkdir(parents=True)
        (d / "Info.cfg").write_text(text)
    return str(root)


def test_sr_seg_set_matches_jax(sr_seg_root):
    for num in (16, 17, 18, 19, 29, 36):
        for kw in ({}, dict(rescale=True), dict(resample=True)):
            ij = j_aux.ACDCSRSegImage(num, sr_seg_root, **kw)
            ip = p_aux.ACDCSRSegImage(num, sr_seg_root, **kw)
            for phase in ("ED", "ES"):
                _same(ij.phase(phase), ip.phase(phase))
            _same(ij.get_frame_id("ES"), ip.get_frame_id("ES"))
    for kw in (dict(limited_load=True),
               dict(limited_load=True, resample=True),
               dict(patid="patient017"), dict(patid=36, resample=True)):
        _same(list(j_aux.acdc_sr_seg_fold(0, sr_seg_root, **kw)),
              list(p_aux.acdc_sr_seg_fold(0, sr_seg_root, **kw)))
    _same(j_aux.load_acdc_sr_seg_slices(0, sr_seg_root, limited_load=True),
          p_aux.load_acdc_sr_seg_slices(0, sr_seg_root, limited_load=True))
    _same(list(j_aux.acdc_sr_seg_fold(2, sr_seg_root, patid=29,
                                      resample=True)),
          list(p_aux.acdc_sr_seg_fold(2, sr_seg_root, patid=29,
                                      resample=True)))
    _raises_alike(lambda: list(j_aux.acdc_sr_seg_fold(0, sr_seg_root,
                                                      patid=29)),
                  lambda: list(p_aux.acdc_sr_seg_fold(0, sr_seg_root,
                                                      patid=29)),
                  ValueError)


def test_uncertainty_loaders_match_jax(tmp_path):
    rng = np.random.RandomState(6)
    for kind, mc in (("pred_labels", ""), ("pred_labels", "_mc"),
                     ("umaps", ""), ("pred_probs", "_mc"),
                     ("ref_labels", ""), ("images", "")):
        (tmp_path / (kind + mc)).mkdir(exist_ok=True)
        for pid in ("patient016", "patient017"):
            for phase in ("ED", "ES"):
                shape = (4, 3, 10, 12) if kind == "pred_probs" else (3, 10,
                                                                      12)
                arr = (rng.randint(0, 4, shape) if "labels" in kind
                       else rng.rand(*shape))
                write_image(str(tmp_path / (kind + mc)
                                / f"{pid}_{phase}.nii.gz"), arr,
                            spacing=(5.0, 1.4, 1.4))
    kinds = ["pred_labels", "umaps", "pred_probs", "ref_labels", "images"]
    for kw in ({}, dict(mc_dropout=True), dict(one_hot=True),
               dict(patient_id="patient017", meta_info=True)):
        _same(j_aux.load_uncertainty_data(str(tmp_path), "ES", kinds, **kw),
              p_aux.load_uncertainty_data(str(tmp_path), "ES", kinds, **kw))
    _same(j_aux.load_uncertainty_data(str(tmp_path), "ED", "umaps"),
          p_aux.load_uncertainty_data(str(tmp_path), "ED", "umaps"))
    _raises_alike(
        lambda: j_aux.load_uncertainty_data(str(tmp_path), "ED", "x"),
        lambda: p_aux.load_uncertainty_data(str(tmp_path), "ED", "x"),
        ValueError)


def _heart(shape, lv, rv):
    lbl = np.zeros(shape, np.int32)
    y, x = np.ogrid[:shape[1], :shape[2]]
    lbl[:, (y - lv[0]) ** 2 + (x - lv[1]) ** 2 < 16] = 3
    lbl[:, (y - rv[0]) ** 2 + (x - rv[1]) ** 2 < 12] = 1
    lbl[:, ((y - lv[0]) ** 2 + (x - lv[1]) ** 2 >= 16)
        & ((y - lv[0]) ** 2 + (x - lv[1]) ** 2 < 30)] = 2
    return lbl


def test_centering_matches_jax(tmp_path):
    for lv, rv in (((20, 24), (12, 14)), ((14, 14), (24, 26)),
                   ((22, 12), (12, 26)), ((12, 26), (24, 12))):
        cms = j_aux.center_of_mass_segmentation(_heart((3, 36, 40), lv, rv))
        _same(cms, p_aux.center_of_mass_segmentation(
            _heart((3, 36, 40), lv, rv)))
        _same(j_aux.centering_rotation_degrees(*cms),
              p_aux.centering_rotation_degrees(*cms))
    rng = np.random.RandomState(7)
    img4d = rng.rand(2, 3, 36, 40).astype(np.float32)
    lbl = _heart((3, 36, 40), (20, 24), (12, 14))
    _same(j_aux.center_4d_volume(img4d, lbl),
          p_aux.center_4d_volume(img4d, lbl))
    no_rv = np.where(lbl == 1, 0, lbl)
    _raises_alike(lambda: j_aux.center_4d_volume(img4d, no_rv),
                  lambda: p_aux.center_4d_volume(img4d, no_rv), ValueError)
    corner = np.zeros((3, 36, 40), np.int32)
    corner[:, 0:2, 0:2] = 3
    corner[:, 34:36, 0:2] = 1
    _raises_alike(lambda: j_aux.center_4d_volume(img4d, corner),
                  lambda: p_aux.center_4d_volume(img4d, corner), ValueError)

    src = tmp_path / "src"
    for pid, gt in (("patient001", "frame01"), ("patient090", "frame04")):
        (src / pid).mkdir(parents=True)
        write_image(str(src / pid / f"{pid}_4d.nii.gz"),
                    rng.rand(2, 3, 36, 40) * 100, spacing=(10.0, 1.5, 1.5))
        write_image(str(src / pid / f"{pid}_{gt}_gt.nii.gz"), lbl,
                    spacing=(10.0, 1.5, 1.5), dtype=np.int32)
    for ids in (None, ["patient090"]):
        wj = j_aux.create_centered_dataset(str(src), str(tmp_path / "j"),
                                           ids)
        wp = p_aux.create_centered_dataset(str(src), str(tmp_path / "p"),
                                           ids)
        _same_files(wj, wp, tmp_path / "j", tmp_path / "p")


def test_label_volumes_match_jax(tmp_path):
    rng = np.random.RandomState(8)
    for num in (16, 17, 1):
        pid = f"patient{num:03d}"
        (tmp_path / pid).mkdir()
        for fr in ("01", "12"):
            write_image(str(tmp_path / pid / f"{pid}_frame{fr}_gt.nii.gz"),
                        rng.randint(0, 4, (3, 20, 22)),
                        spacing=(5.0, 1.6, 1.6), dtype=np.int32)
    for kw in (dict(cardiac_label=3), dict(resample=False),
               dict(dataset="training", limited_load=True)):
        _same(j_aux.load_acdc_label_volumes(str(tmp_path), **kw),
              p_aux.load_acdc_label_volumes(str(tmp_path), **kw))
    lbl = rng.randint(0, 4, (2, 5, 5))
    for c in (None, 2):
        _same(j_aux.normalize_cardiac_label(lbl, c),
              p_aux.normalize_cardiac_label(lbl, c))


# ---------------------------------------------------------------------------
# DICOM and image utilities
# ---------------------------------------------------------------------------

def test_dicom_reader_matches_jax(tmp_path):
    rng = np.random.RandomState(9)
    series = tmp_path / "series"
    series.mkdir()
    for i, z in enumerate((12.0, 6.0, 9.0)):
        _write_dicom(str(series / f"im{i}.dcm"),
                     rng.randint(0, 3000, (6, 8)).astype(np.uint16),
                     implicit=i == 1, instance=i + 1, zpos=z, slope=2.0,
                     intercept=-5.0)
    (series / ".hidden").write_bytes(b"not dicom")
    for f in sorted(os.listdir(series)):
        if f.endswith(".dcm"):
            _same(j_dicom.read_dicom(str(series / f)),
                  p_dicom.read_dicom(str(series / f)))
    _same(j_dicom.read_dicom_series(str(series)),
          p_dicom.read_dicom_series(str(series)))
    _raises_alike(lambda: j_dicom.read_dicom(str(series / ".hidden")),
                  lambda: p_dicom.read_dicom(str(series / ".hidden")),
                  j_dicom.DicomError, p_dicom.DicomError)
    out_j = j_misc.dicom_series_to_nifti(str(series),
                                         str(tmp_path / "j.nii.gz"))
    out_p = p_misc.dicom_series_to_nifti(str(series),
                                         str(tmp_path / "p.nii.gz"))
    assert _payload(out_j) == _payload(out_p)


def test_image_misc_matches_jax():
    rng = np.random.RandomState(10)
    for n in (1, 5, 9, 10):
        _same(j_misc.find_rectangle(n), p_misc.find_rectangle(n))
    imgs = rng.rand(7, 4, 5).astype(np.float32)
    for kw in ({}, dict(nx=2), dict(ny=2), dict(nx=2, ny=2)):
        m = j_misc.make_mosaic(imgs, **kw)
        _same(m, p_misc.make_mosaic(imgs, **kw))
        _same(j_misc.unmake_mosaic(m, 4, 5), p_misc.unmake_mosaic(m, 4, 5))
    for img in (rng.rand(19, 21), rng.rand(16, 16, 3)):
        for block in (4, 8):
            _same(j_misc.pixelate(img, block), p_misc.pixelate(img, block))
