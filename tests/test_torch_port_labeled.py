"""PyTorch port, the labeled cardiac path (ACDCLBL): Dice, the loss
masks, ``MultiChannelAE``, its converters and checkpoints, the labeled
ACDC loader, the masked sampler and device cache, and serving with
decoded labels, held against the JAX package on the CPU.

Weights come from ``torch_port_helpers.jax_family_model`` (numpy-seeded
trees on ``jax.eval_shape``), inputs from numpy seeds; JAX runs at
``default_matmul_precision("highest")``. Tolerances:

- ``soft_dice_score`` and ``dice_loss``: atol 1e-6;
- ``make_loss_mask`` / ``masks_for_volume``, the loader's labels, the
  sampler's and the device cache's batches: exact;
- the loader's images: atol 1e-6;
- ``MultiChannelAE`` eval mode: both heads atol 1e-5. Train mode (batch
  statistics): atol 1e-4 for the heads, rtol 1e-4 (atol 1e-6) for the
  running statistics: normalising by the statistics of a batch of 3
  amplifies float32 rounding, so JAX's float32 heads lie up to 6.0e-5
  from a float64 evaluation of the same network and the port's up to
  3.5e-5 (the class probabilities with the padded stem; the two
  packages differ by up to 2.5e-5 in these cases);
- ``create_super_volume(s)``: image atol 1e-5, decoded labels exact
  (float32), warnings and errors as JAX's;
- checkpoints: the port's file of a JAX state is byte-equal to JAX's,
  and each package restores the other's exactly.
"""
import os
import warnings

import jax
import numpy as np
import pytest
import torch

from superresolution_aniso_mri_tpu.data import TripletSampler as JaxSampler
from superresolution_aniso_mri_tpu.data import Volume as JaxVolume
from superresolution_aniso_mri_tpu.data import datasets as jd
from superresolution_aniso_mri_tpu.data import masks as jmasks
from superresolution_aniso_mri_tpu.infer import (
    create_super_volume as jax_create_super_volume,
    create_super_volumes as jax_create_super_volumes)
from superresolution_aniso_mri_tpu.ops.dice import (
    dice_loss as jax_dice_loss, soft_dice_score as jax_soft_dice)
from superresolution_aniso_mri_tpu.utils import write_nifti
from superresolution_aniso_mri_tpu_torch.data import (
    DeviceCachedSampler, TripletSampler, Volume)
from superresolution_aniso_mri_tpu_torch.data import datasets as td
from superresolution_aniso_mri_tpu_torch.data import masks as tmasks
from superresolution_aniso_mri_tpu_torch.infer import (
    ServingModel, create_super_volume, create_super_volumes)
from superresolution_aniso_mri_tpu_torch.infer.super_volume import (
    model_label_semantics)
from superresolution_aniso_mri_tpu_torch.models import (
    AEConfig, MultiChannelAE, build_model, flax_to_torch, torch_to_flax)
from superresolution_aniso_mri_tpu_torch.ops import dice_loss, soft_dice_score
from torch_port_helpers import (SMALL, JaxServingStub, jax_family_model,
                                one_torch_thread)  # autouse

MC = dict(colors=2, nclasses=4, use_batchnorm=True)


def _highest():
    return jax.default_matmul_precision("highest")


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().numpy().transpose(0, 2, 3, 1)


def _mc_pair(seed=0, **kw):
    """(JAX MultiChannelAE, params, stats, port model, its config)."""
    kw = {**MC, **kw}
    model, params, stats = jax_family_model("MultiChannelAE", seed, **kw)
    cfg = AEConfig(**{**SMALL, **kw})
    port = build_model("MultiChannelAE", cfg)
    port.load_state_dict(flax_to_torch(params, stats, cfg, port))
    return model, params, stats, port, cfg


# ---------------------------------------------------------------------------
# Dice and the loss masks
# ---------------------------------------------------------------------------

def test_dice_matches_jax():
    """Per (batch, class) soft Dice over the spatial dims; ids outside
    [0, n_classes) one-hot to zeros in both."""
    rng = np.random.RandomState(0)
    logits = rng.randn(3, 4, 9, 7).astype(np.float32)
    probs = np.exp(logits) / np.exp(logits).sum(axis=1, keepdims=True)
    labels = rng.randint(0, 4, (3, 9, 7)).astype(np.int32)
    labels[0, :2] = -1
    labels[1, 3] = 5
    nhwc = probs.transpose(0, 2, 3, 1)
    got = float(dice_loss(torch.from_numpy(probs), torch.from_numpy(labels),
                          4))
    np.testing.assert_allclose(got, float(jax_dice_loss(nhwc, labels, 4)),
                               atol=1e-6)
    one_hot = np.eye(4, dtype=np.float32)[np.clip(labels, 0, 3)]
    got = float(soft_dice_score(torch.from_numpy(probs),
                                torch.from_numpy(one_hot.transpose(0, 3, 1,
                                                                   2))))
    np.testing.assert_allclose(got, float(jax_soft_dice(nhwc, one_hot)),
                               atol=1e-6)


@pytest.mark.parametrize("iters", [0, 2, 5])
def test_masks_match_jax(iters):
    """Dilated RV/MYO/LV masks; a slice with no included structure (one
    empty, one with excluded labels only) gets the all-ones mask."""
    rng = np.random.RandomState(1)
    labels = np.zeros((4, 20, 24), np.int32)
    labels[0, 5:9, 6:12] = rng.randint(1, 4, (4, 6))
    labels[2, 8:10, 3:5] = 7
    labels[3] = rng.randint(0, 4, (20, 24))
    for fn in ("make_loss_mask", "masks_for_volume"):
        got = getattr(tmasks, fn)(labels, iters)
        want = getattr(jmasks, fn)(labels, iters)
        assert got.dtype == want.dtype == np.float32
        assert np.array_equal(got, want), fn
    assert np.array_equal(tmasks.make_loss_mask(labels[0], iters),
                          jmasks.make_loss_mask(labels[0], iters))
    assert tmasks.masks_for_volume(labels, iters)[1].min() == 1.0


# ---------------------------------------------------------------------------
# MultiChannelAE and its converters
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [dict(), dict(stem_pad_parity=True),
                                dict(use_batchnorm=False)])
def test_multichannel_ae_matches_jax(kw):
    """encode, decode and the forward in eval mode (atol 1e-5), and in
    train mode with its batch statistics (atol 1e-4; see the module
    docstring) and the running statistics it leaves, the class head's
    BatchNorm included."""
    model, params, stats, port, _ = _mc_pair(0, **kw)
    v = {"params": params, "batch_stats": stats}
    x = np.random.RandomState(2).rand(3, 32, 32, 2).astype(np.float32)
    x[..., 1] = np.floor(x[..., 1] * 4)
    with _highest():
        z = model.apply(v, x, method=model.encode)
        dec = model.apply(v, z, method=model.decode)
        out = model.apply(v, x)
        out_t, mut = model.apply(v, x, train=True, mutable=["batch_stats"])
    port.eval()
    with torch.no_grad():
        zt = port.encode(_nchw(x))
        np.testing.assert_allclose(_nhwc(zt), np.asarray(z), atol=1e-5)
        for got, want in ((port.decode(zt), dec), (port(_nchw(x)), out)):
            for k in ("image", "soft_probs"):
                assert got[k].dtype == torch.float32
                np.testing.assert_allclose(_nhwc(got[k]), np.asarray(want[k]),
                                           atol=1e-5, err_msg=k)
        got = port(_nchw(x), train=True)
    for k in ("image", "soft_probs"):
        np.testing.assert_allclose(_nhwc(got[k]), np.asarray(out_t[k]),
                                   atol=1e-4, err_msg=k)
    _, got_stats = torch_to_flax(port.state_dict())
    want_stats = mut["batch_stats"]
    assert jax.tree_util.tree_structure(got_stats) == \
        jax.tree_util.tree_structure(want_stats)
    jax.tree_util.tree_map(
        lambda a, b: np.testing.assert_allclose(b, np.asarray(a), rtol=1e-4,
                                                atol=1e-6),
        want_stats, got_stats)


def test_converters_round_trip_and_checkpoints_load_both_ways(tmp_path):
    """flax → port → flax is exact (``head_cls_bn`` keeps flax's
    ``scale``); a JAX ``SRTPU1`` file of a MultiChannelAE state loads in
    the port and is written back byte for byte; JAX restores the port's
    file exactly."""
    from superresolution_aniso_mri_tpu.train.checkpoint import (
        load_checkpoint as jax_load, save_checkpoint as jax_save)
    from superresolution_aniso_mri_tpu.train.state import (
        SRTrainState, make_optimizer as jax_make_optimizer)
    from superresolution_aniso_mri_tpu_torch.train import create_train_state
    from superresolution_aniso_mri_tpu_torch.train.checkpoint import (
        load_checkpoint, save_checkpoint)

    model, params, stats, port, cfg = _mc_pair(3)
    back_p, back_s = torch_to_flax(port.state_dict())
    jax.tree_util.tree_map(
        lambda a, b: np.testing.assert_array_equal(b, np.asarray(a)),
        (params, stats), (back_p, back_s))
    assert set(params["head_cls_bn"]) == {"scale", "bias"}
    assert port.head_cls_bn.weight.shape == (cfg.depth,)
    jstate = SRTrainState.create(apply_fn=model.apply, params=params,
                                 tx=jax_make_optimizer(1e-4),
                                 batch_stats=stats)
    jax_file, port_file = tmp_path / "jax.models", tmp_path / "port.models"
    jax_save(str(jax_file), jstate, 4)
    fresh = build_model("MultiChannelAE", cfg)
    pstate, epoch = load_checkpoint(str(jax_file),
                                    create_train_state(fresh, 1e-4))
    assert epoch == 4
    for k, v in port.state_dict().items():
        assert torch.equal(pstate.model.state_dict()[k], v), k
    save_checkpoint(str(port_file), pstate, 4)
    assert port_file.read_bytes() == jax_file.read_bytes()
    restored, epoch = jax_load(str(port_file), jstate)
    assert epoch == 4
    jax.tree_util.tree_map(
        lambda a, b: np.testing.assert_array_equal(np.asarray(a),
                                                   np.asarray(b)),
        (restored.params, restored.batch_stats),
        (jstate.params, jstate.batch_stats))


def test_reference_torch_checkpoint_of_a_multichannel_model_is_refused():
    """JAX's reason: a reference MultiChannelAE / ACDCLBL checkpoint's
    decoder heads have no counterpart."""
    from superresolution_aniso_mri_tpu_torch.train.import_torch import (
        reference_state_to_port)

    port = MultiChannelAE(AEConfig(**{**SMALL, **MC}))
    sd = {"enc.0.weight": torch.zeros(4, 2, 1, 1),
          "dec.0.weight": torch.zeros(4, 6, 3, 3)}
    with pytest.raises(ValueError, match="MultiChannelAE / ACDCLBL"):
        reference_state_to_port(sd, port)


# ---------------------------------------------------------------------------
# the labeled ACDC loader, the masked sampler and the device cache
# ---------------------------------------------------------------------------

ACDC_SPACING = np.array([10.0, 1.5625, 1.5625])


def _acdc_frames(root, pids=("patient001", "patient002", "patient003",
                             "patient004")):
    """ED/ES frames with ``_gt`` maps of ``pids`` (patient004 is one of
    the 12 native-5 mm test patients), in ACDC's layout."""
    rng = np.random.RandomState(5)
    for pid in pids:
        pdir = os.path.join(root, "ACDC", "all_cardiac_phases", pid)
        os.makedirs(pdir, exist_ok=True)
        for fr in (1, 12):
            img = (rng.rand(4, 30, 36) * 400).astype(np.float32)
            lbl = rng.randint(0, 4, (4, 30, 36)).astype(np.int16)
            write_nifti(os.path.join(pdir, f"{pid}_frame{fr:02d}.nii.gz"),
                        img, spacing=ACDC_SPACING)
            write_nifti(os.path.join(pdir, f"{pid}_frame{fr:02d}_gt.nii.gz"),
                        lbl, spacing=ACDC_SPACING)


def _cines(root, pids=("patient001", "patient002")):
    rng = np.random.RandomState(6)
    for pid in pids:
        pdir = os.path.join(root, "ACDC", "all_cardiac_phases", pid)
        os.makedirs(pdir, exist_ok=True)
        write_nifti(os.path.join(pdir, f"{pid}_4d.nii.gz"),
                    (rng.rand(3, 4, 30, 36) * 400).astype(np.float32),
                    spacing=ACDC_SPACING)


def _same_volumes(got, want):
    assert [v.patient_id for v in got] == [v.patient_id for v in want]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.image, w.image, atol=1e-6)
        np.testing.assert_array_equal(g.spacing, w.spacing)
        if w.labels is None:
            assert g.labels is None
        else:
            assert g.labels.dtype == w.labels.dtype == np.int32
            assert np.array_equal(g.labels, w.labels)


def test_labeled_acdc_loader_matches_jax(tmp_path, monkeypatch):
    """``load_acdc_labeled_volumes`` without a split file (the default
    ACDC split keeps patient004, a native-5 mm patient, out of training)
    and with one; the 4D loader beside it reads the same cines before
    and after the frames are written."""
    monkeypatch.setenv("SR_DATA_ROOT", str(tmp_path))
    _cines(tmp_path)
    cines = td.load_acdc_volumes("training")
    _acdc_frames(tmp_path)
    _same_volumes(td.load_acdc_volumes("training"), cines)
    for split in ("training", "validation", "test"):
        got = td.load_acdc_labeled_volumes(split)
        _same_volumes(got, jd.load_acdc_labeled_volumes(split))
    train = td.load_acdc_labeled_volumes("training")
    assert len(train) == 6 and not any("patient004" in v.patient_id
                                       for v in train)
    assert train[0].image.shape == train[0].labels.shape == (4, 33, 40)
    with open(tmp_path / "ACDC" / "train_val_test_split_sr.yaml", "w") as f:
        f.write("training:\n- patient002\n- patient003\nvalidation:\n"
                "- patient001\ntest: []\n")
    for split in ("training", "validation"):
        _same_volumes(td.load_acdc_labeled_volumes(split, limited_load=True),
                      jd.load_acdc_labeled_volumes(split, limited_load=True))
    got = td.get_datasets(dict(dataset="ACDCLBL", downsample_steps=2))
    want = jd.get_datasets(dict(dataset="ACDCLBL", downsample_steps=2))
    for g, w in zip(got, want):
        _same_volumes(g, w)


def _labeled_volumes(cls, seed=0):
    rng = np.random.RandomState(seed)
    vols = []
    for i, shape in enumerate(((9, 20, 24), (7, 24, 18))):
        lbl = np.zeros(shape, np.int32)
        lbl[:, 6:14, 5:12] = rng.randint(0, 4, (shape[0], 8, 7))
        lbl[2] = 0      # a slice without structures: all-ones mask
        vols.append(cls(image=rng.rand(*shape).astype(np.float32),
                        spacing=np.array([5.0, 1.4, 1.4]),
                        patient_id=f"patient00{i}_frame01", labels=lbl))
    return vols


def test_masked_sampler_and_device_cache_match_jax():
    """``TripletSampler(use_masks=True)`` and its device cache on the
    CPU: bitwise JAX's batches, (image, label) per slot and the between
    slice's mask last."""
    kw = dict(downsample_steps=2, seed=7, use_masks=True, pad_size=26)
    port = TripletSampler(_labeled_volumes(Volume), **kw)
    cached = DeviceCachedSampler(TripletSampler(_labeled_volumes(Volume),
                                                **kw), "cpu")
    ref = JaxSampler(_labeled_volumes(JaxVolume), **kw)
    for got_h, got_c, want in zip(port.epoch_batches(4),
                                  cached.epoch_batches(4),
                                  ref.epoch_batches(4)):
        assert got_h["triplet"].shape[-1] == 7
        assert np.array_equal(got_h["triplet"], want["triplet"])
        assert np.array_equal(got_c["triplet"].numpy(), want["triplet"])
        for k in ("alpha_from", "alpha_to", "is_inbetween"):
            assert np.array_equal(got_c[k], want[k]), k


def test_device_batch_splits_off_the_loss_mask():
    """The mask channel rides through the augmentation and becomes
    ``loss_mask``; the (image, label) planes split as JAX's."""
    from superresolution_aniso_mri_tpu.cli.train_loop import (
        _device_batch as jax_device_batch)
    from superresolution_aniso_mri_tpu.data import (
        AugmentConfig as JaxAugmentConfig)
    from superresolution_aniso_mri_tpu_torch.data import (AugmentConfig,
                                                          device_batch)

    raw = TripletSampler(_labeled_volumes(Volume), 2, seed=1, pad_size=26,
                         use_masks=True).sample_batch(3)
    det = dict(patch_size=16, random_crop=False, rot90=False,
               intensity=False)
    got = device_batch(raw, AugmentConfig(**det), "cpu", with_mask=True)
    want = jax_device_batch(raw, JaxAugmentConfig(**det),
                            jax.random.PRNGKey(0), with_mask=True)
    assert got["loss_mask"].shape == (3, 1, 16, 16)
    for k in ("image", "slice_between", "loss_mask"):
        assert np.array_equal(_nhwc(got[k]), np.asarray(want[k])), k


# ---------------------------------------------------------------------------
# serving with decoded labels
# ---------------------------------------------------------------------------

def _served(seed=4):
    model, params, stats, _, cfg = _mc_pair(seed)
    stub = JaxServingStub(model, params, stats)
    port = ServingModel.from_flax(cfg, params, stats, device="cpu",
                                  ae_class="MultiChannelAE")
    return stub, port


def _same_result(got, want):
    np.testing.assert_allclose(got["upsampled_image"],
                               np.asarray(want["upsampled_image"]),
                               atol=1e-5)
    g, w = got["upsampled_labels"], want["upsampled_labels"]
    assert g.dtype == w.dtype and g.shape == w.shape
    assert np.array_equal(g, w)
    np.testing.assert_array_equal(got["pred_alphas"], want["pred_alphas"])


@pytest.mark.parametrize("case", ["labels", "use_original", "odd_size",
                                  "no_labels"])
def test_create_super_volume_decodes_labels_like_jax(case):
    """The image plane at atol 1e-5 and the decoded class ids exactly:
    through the verbatim tail (input labels), ``use_original`` (kept
    slices keep the input planes), an in-plane size off the encoder's
    stride (reflect-pad, crop back) and without labels (a zero label
    plane, with JAX's warning, int32 ids)."""
    stub, port = _served()
    rng = np.random.RandomState(8)
    h, w = (27, 30) if case == "odd_size" else (32, 32)
    imgs = rng.rand(10, h, w).astype(np.float32)
    lbls = rng.randint(0, 4, (10, h, w)).astype(np.int16)
    kw = dict(alpha_range=[0.5], downsample_steps=2,
              generate_inbetween_slices=True,
              use_original=case == "use_original",
              labels=None if case == "no_labels" else lbls)
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        got = create_super_volume(port, imgs, **kw)
    with _highest(), pytest.warns(UserWarning) if case == "no_labels" \
            else warnings.catch_warnings():
        want = jax_create_super_volume(stub, imgs, **kw)
    assert [str(m.message) for m in seen if "zero label" in str(
        m.message)] == (["multichannel volume synthesis without labels "
                         "(create_super_volume): feeding a zero label "
                         "channel"] if case == "no_labels" else [])
    _same_result(got, want)
    up = got["upsampled_labels"]
    assert up.shape == imgs.shape and set(np.unique(up)) <= {0, 1, 2, 3}
    if case == "no_labels":
        assert up.dtype == np.int32 and not up[-1].any()
    else:
        assert np.array_equal(up[-1], lbls[-1])
    if case == "use_original":
        assert np.array_equal(up[::2], lbls[::2])


def test_create_super_volumes_batched_matches_jax():
    """Two volumes of one shape batched and one of another shape, with
    labels: each as JAX's batched call and as the port's single call."""
    stub, port = _served(5)
    rng = np.random.RandomState(9)
    shapes = ((9, 32, 32), (9, 32, 32), (7, 32, 32))
    imgs = [rng.rand(*s).astype(np.float32) for s in shapes]
    lbls = [rng.randint(0, 4, s).astype(np.float32) for s in shapes]
    kw = dict(alpha_range=[1 / 3, 2 / 3], downsample_steps=3,
              generate_inbetween_slices=True)
    got = create_super_volumes(port, imgs, labels_list=lbls, **kw)
    with _highest():
        want = jax_create_super_volumes(stub, imgs, labels_list=lbls, **kw)
    for g, w, img, lbl in zip(got, want, imgs, lbls):
        _same_result(g, w)
        single = create_super_volume(port, img, labels=lbl, **kw)
        np.testing.assert_allclose(g["upsampled_image"],
                                   single["upsampled_image"], atol=1e-5)
        assert np.array_equal(g["upsampled_labels"],
                              single["upsampled_labels"])


def test_mismatched_label_grid_and_label_semantics():
    """Labels off the image grid raise JAX's ValueError; only
    MultiChannelAE decodes labels: a plain 2-channel AE's labels ride
    along unchanged."""
    stub, port = _served()
    rng = np.random.RandomState(10)
    imgs = rng.rand(9, 32, 32).astype(np.float32)
    bad = rng.randint(0, 4, (2, 32, 32)).astype(np.float32)
    kw = dict(alpha_range=[0.5], downsample_steps=2,
              generate_inbetween_slices=True, labels=bad)
    for fn, trainer in ((create_super_volume, port),
                        (jax_create_super_volume, stub)):
        with pytest.raises(ValueError, match="image grid"):
            fn(trainer, imgs, **kw)
    assert model_label_semantics(port) == (True, True)
    plain = ServingModel(AEConfig(**{**SMALL, **MC}), device="cpu",
                         generator=torch.Generator().manual_seed(0))
    assert model_label_semantics(plain) == (True, False)
    lbls = rng.randint(0, 4, (9, 32, 32)).astype(np.int16)
    out = create_super_volume(plain, imgs, **dict(kw, labels=lbls))
    assert np.array_equal(out["upsampled_labels"], lbls)
