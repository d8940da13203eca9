"""PyTorch port's scoring of segmentations of SR volumes
(``evaluate/sr_seg_eval.py``) against the JAX package's, on the CPU:
``score_segmentation`` and ``evaluate_sr_segmentation`` return equal
dicts (NaN where JAX has NaN: a structure absent from both volumes, a
distance without one of the two surfaces) and raise the same errors.
The code is numpy / scipy over the copied segmentation metrics, so the
tolerance is equality."""
import numpy as np
import pytest

from superresolution_aniso_mri_tpu.evaluate import sr_seg_eval as j_sr
from superresolution_aniso_mri_tpu_torch.evaluate import sr_seg_eval as p_sr
from superresolution_aniso_mri_tpu_torch.utils import write_image

SPACING = (5.0, 1.4, 1.4)


def _same(a, b):
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, tuple):
        assert isinstance(b, tuple) and len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    else:
        assert type(a) is type(b), (a, b)
        assert a == b or (np.isnan(a) and np.isnan(b)), (a, b)


def _labels(rng, shape=(4, 20, 22)):
    """Blobs of the three structures, coherent enough for surfaces."""
    lbl = np.zeros(shape, np.int32)
    y, x = np.ogrid[:shape[1], :shape[2]]
    cy, cx = rng.randint(7, 13), rng.randint(7, 15)
    lbl[:, (y - cy) ** 2 + (x - cx) ** 2 < 30] = 2
    lbl[:, (y - cy) ** 2 + (x - cx) ** 2 < 12] = 3
    lbl[:, (y - cy + 5) ** 2 + (x - cx + 6) ** 2 < 8] = 1
    lbl[rng.rand(*shape) < 0.03] = 0
    return lbl


def test_score_segmentation_matches_jax():
    rng = np.random.RandomState(0)
    ref = _labels(rng)
    cases = [
        (ref, ref, None),
        (np.roll(ref, 2, axis=2), ref, SPACING),
        (np.where(ref == 1, 0, ref), ref, SPACING),       # RV missing
        (np.where(ref == 1, 0, ref), np.where(ref == 1, 0, ref), None),
        (ref[None], ref, (1.0, 2.0, 0.5)),                # singleton frame
        (ref, ref[None], None),
        (np.zeros_like(ref), ref * 0 + 3, None),
    ]
    for pred, reference, sp in cases:
        _same(j_sr.score_segmentation(pred, reference, voxelspacing=sp),
              p_sr.score_segmentation(pred, reference, voxelspacing=sp))
    custom = {1: "A", 3: "B"}
    _same(j_sr.score_segmentation(ref, np.roll(ref, 1, 1),
                                  structures=custom),
          p_sr.score_segmentation(ref, np.roll(ref, 1, 1),
                                  structures=custom))
    with pytest.raises(ValueError) as ej:
        j_sr.score_segmentation(ref[:3], ref)
    with pytest.raises(ValueError) as ep:
        p_sr.score_segmentation(ref[:3], ref)
    assert str(ej.value) == str(ep.value)


@pytest.fixture()
def sr_seg_tree(tmp_path):
    """images_sr / ref_labels [2, z, y, x] of fold-0 validation patients
    16-18, predictions of 16 (exact), 17 (shifted, ED only), 18 (RV
    lost) and of patient001 (not in the fold), plus MC-dropout ones."""
    rng = np.random.RandomState(1)
    root, preds = tmp_path / "root", tmp_path / "preds"
    for d in ("images_sr", "ref_labels"):
        (root / d).mkdir(parents=True)
    for d in ("pred_labels", "pred_labels_mc"):
        (preds / d).mkdir(parents=True)
    for num in (16, 17, 18):
        pid = f"patient{num:03d}"
        ref = np.stack([_labels(rng), _labels(rng)])
        write_image(str(root / "images_sr" / f"{pid}.nii.gz"),
                    rng.rand(*ref.shape) * 10, spacing=SPACING)
        write_image(str(root / "ref_labels" / f"{pid}.nii.gz"), ref,
                    spacing=SPACING, dtype=np.int32)
        for i, phase in enumerate(("ED", "ES")):
            pred = {16: ref[i], 17: np.roll(ref[i], 2, axis=1),
                    18: np.where(ref[i] == 1, 0, ref[i])}[num]
            if num == 17 and phase == "ES":
                continue
            write_image(str(preds / "pred_labels" / f"{pid}_{phase}.nii.gz"),
                        pred, spacing=SPACING, dtype=np.int32)
            write_image(str(preds / "pred_labels_mc"
                            / f"{pid}_{phase}.nii.gz"),
                        np.roll(pred, 1, axis=2), spacing=SPACING,
                        dtype=np.int32)
    write_image(str(preds / "pred_labels" / "patient001_ED.nii.gz"),
                _labels(rng), spacing=SPACING, dtype=np.int32)
    return str(preds), str(root)


def test_evaluate_sr_segmentation_matches_jax(sr_seg_tree):
    pred_dir, root = sr_seg_tree
    for kw in (dict(limited_load=True), dict(limited_load=True,
                                             mc_dropout=True),
               dict(limited_load=True, cardiac_phases=("ES",)),
               dict(limited_load=True, resample=True)):
        want = j_sr.evaluate_sr_segmentation(pred_dir, root, **kw)
        got = p_sr.evaluate_sr_segmentation(pred_dir, root, **kw)
        assert list(got["per_case"]) == list(want["per_case"])
        _same(want, got)
    assert got["per_case"][("patient016", "ED")]["LV"]["dice"] == 1.0


def test_a_cohort_that_scored_nothing_raises_like_jax(sr_seg_tree, tmp_path):
    import shutil

    pred_dir, root = sr_seg_tree
    # predictions only of a patient outside the fold
    other = tmp_path / "other" / "pred_labels"
    other.mkdir(parents=True)
    shutil.copy(f"{pred_dir}/pred_labels/patient001_ED.nii.gz", other)
    for args, kw in (((str(tmp_path / "none"), root),
                      dict(limited_load=True)),
                     ((str(other.parent), root), dict(limited_load=True)),
                     ((str(other.parent), root), dict(limited_load=True,
                                                      mc_dropout=True))):
        with pytest.raises(ValueError, match="scored 0 cases") as ej:
            j_sr.evaluate_sr_segmentation(*args, **kw)
        with pytest.raises(ValueError, match="scored 0 cases") as ep:
            p_sr.evaluate_sr_segmentation(*args, **kw)
        assert str(ej.value) == str(ep.value)
