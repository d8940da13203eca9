"""PyTorch port, the native host loader (``csrc/srloader.cc`` built by
``ops/_build.py``, bound by ``data/native_loader.py``) and its call site
``data/pairs.py::TripletSampler._assemble_batch``.

The native decode, parallel ingest (input order, a file that fails)
and triplet gather give the same bits as the port's numpy paths and as
the JAX package's outputs; the sampler's batches and the loaded volumes
are the same with and without ``SRL_DISABLE_NATIVE``, and a library
that does not build raises. Mirrors ``tests/test_native_loader.py``.
"""
import numpy as np
import pytest

from superresolution_aniso_mri_tpu.utils.nifti import read_nifti as jax_read
from superresolution_aniso_mri_tpu_torch.data import native_loader as nl
from superresolution_aniso_mri_tpu_torch.utils.nifti import (read_nifti,
                                                             write_nifti)


@pytest.fixture(autouse=True)
def _native(monkeypatch):
    """The library is built (first use) and no test inherits a disable."""
    monkeypatch.delenv("SRL_DISABLE_NATIVE", raising=False)
    assert nl.available(), "the native loader did not build"


@pytest.fixture(scope="module")
def nifti_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("nifti")
    rng = np.random.RandomState(0)
    files = []
    a = rng.rand(9, 20, 24).astype(np.float32)
    files.append(str(d / "f32.nii.gz"))
    write_nifti(files[-1], a, spacing=[6.0, 1.25, 1.5])
    b = (rng.rand(5, 8, 8) * 1000 - 300).astype(np.int16)
    files.append(str(d / "i16.nii"))
    write_nifti(files[-1], b, spacing=[5.0, 1.0, 1.0], dtype=np.int16)
    c = rng.rand(3, 4, 10, 12).astype(np.float32)
    files.append(str(d / "t4d.nii.gz"))
    write_nifti(files[-1], c, spacing=[4.0, 1.0, 1.0])
    aff = np.diag([1.5, 1.25, 6.0, 1.0])
    aff[:3, 3] = [-10.0, 4.0, 2.5]
    files.append(str(d / "affine.nii.gz"))
    write_nifti(files[-1], a[:4] * 300.0, affine=aff)
    return files


def _assert_same_image(got, want):
    arr, sp, aff = got
    assert arr.dtype == np.float32
    np.testing.assert_array_equal(arr, np.asarray(want[0]).astype(np.float32))
    np.testing.assert_array_equal(sp, want[1])
    if want[2] is None:
        assert aff is None
    else:
        np.testing.assert_array_equal(aff, want[2])


def test_native_decode_is_the_numpy_reader(nifti_files):
    """Each file decodes to the port's and JAX's reader's bits (as the
    float32 the datasets keep), spacing and affine included."""
    for path in nifti_files:
        got = nl.read_nifti_native(path)
        _assert_same_image(got, read_nifti(path))
        _assert_same_image(got, jax_read(path))


def test_native_decode_errors(tmp_path):
    with pytest.raises(IOError):
        nl.read_nifti_native(str(tmp_path / "missing.nii.gz"))
    bad = tmp_path / "bad.nii"
    bad.write_bytes(b"not a nifti at all" * 30)
    with pytest.raises(IOError):
        nl.read_nifti_native(str(bad))


def test_read_many_keeps_order_and_the_good_decodes(nifti_files, tmp_path):
    paths = list(nifti_files) * 3
    for got, path in zip(nl.read_nifti_many(paths, nthreads=4), paths):
        _assert_same_image(got, read_nifti(path))
    bad = tmp_path / "bad.nii.gz"
    bad.write_bytes(b"\x1f\x8b broken" * 10)
    mixed = [nifti_files[0], str(bad), nifti_files[1]]
    with pytest.raises(IOError):
        nl.read_nifti_many(mixed)
    with pytest.warns(UserWarning, match="1/3 file"):
        res = nl.read_nifti_many(mixed, strict=False)
    assert res[1] is None
    _assert_same_image(res[0], read_nifti(nifti_files[0]))
    _assert_same_image(res[2], read_nifti(nifti_files[1]))


def test_native_ingest_is_the_python_pool(nifti_files, tmp_path):
    """The native ingest gives ``_read_images_parallel``'s result (the
    Python thread pool the dataset loaders call) bit for bit, in input
    order; a corrupt file raises in both."""
    from superresolution_aniso_mri_tpu_torch.data import datasets

    paths = list(reversed(nifti_files))
    got = datasets._read_images_parallel(paths)
    assert list(got) == paths
    for p, native in zip(paths, nl.read_nifti_many(paths)):
        _assert_same_image(native, read_nifti(p))
        arr, spacing, affine = got[p]
        np.testing.assert_array_equal(arr.astype(np.float32), native[0])
        np.testing.assert_array_equal(spacing, native[1])
        np.testing.assert_array_equal(affine, native[2])

    bad = tmp_path / "bad.nii.gz"
    bad.write_bytes(b"\x1f\x8b broken" * 10)
    with pytest.raises(IOError):
        nl.read_nifti_many([paths[0], str(bad)])
    with pytest.raises(Exception):
        datasets._read_images_parallel([paths[0], str(bad)])


def test_gather_is_the_numpy_stack():
    rng = np.random.RandomState(1)
    vol = rng.rand(12, 17, 23).astype(np.float32)
    slices = [[vol[i], vol[i + 1], vol[i + 2], vol[i + 3]] for i in range(8)]
    want = np.stack([np.stack(ch, axis=-1) for ch in slices])
    np.testing.assert_array_equal(nl.gather_triplets(slices), want)
    out = np.empty_like(want)
    assert nl.gather_triplets(slices, out) is out
    np.testing.assert_array_equal(out, want)
    # float64 planes and a strided view are made float32 and contiguous
    mixed = [[vol[i].astype(np.float64), vol[i + 1][:, ::-1]]
             for i in range(3)]
    np.testing.assert_array_equal(
        nl.gather_triplets(mixed),
        np.stack([np.stack(ch, axis=-1) for ch in mixed]).astype(np.float32))
    with pytest.raises(ValueError):
        nl.gather_triplets([[vol[0], vol[1]], [vol[0]]])
    with pytest.raises(ValueError):
        nl.gather_triplets([[vol[0], vol[1][:5]]])
    with pytest.raises(ValueError):
        nl.gather_triplets(slices, np.empty((8, 17, 23, 4), np.float64))


@pytest.mark.parametrize("labeled", [False, True])
def test_sampler_batches_with_and_without_native(monkeypatch, labeled):
    """The port's ``TripletSampler`` batches are the same bits with the
    native gather, with ``SRL_DISABLE_NATIVE`` and from JAX's sampler;
    also for labeled volumes with loss masks (image, label and mask
    planes)."""
    from superresolution_aniso_mri_tpu.data import TripletSampler as JaxTS
    from superresolution_aniso_mri_tpu.data import make_toy_dataset
    from superresolution_aniso_mri_tpu_torch.data import TripletSampler

    vols = make_toy_dataset(num_volumes=2, size=24, num_slices=9, seed=3)
    kw = dict(downsample_steps=2, seed=5)
    if labeled:
        rng = np.random.RandomState(4)
        for v in vols:
            v.labels = rng.randint(0, 4, v.image.shape).astype(np.float32)
        kw["use_masks"] = True
    native = [TripletSampler(vols, **kw).sample_batch(6),
              next(TripletSampler(vols, **kw).epoch_batches(4))]
    monkeypatch.setenv("SRL_DISABLE_NATIVE", "1")
    assert not nl.available()
    plain = [TripletSampler(vols, **kw).sample_batch(6),
             next(TripletSampler(vols, **kw).epoch_batches(4))]
    jax_batches = [JaxTS(vols, **kw).sample_batch(6),
                   next(JaxTS(vols, **kw).epoch_batches(4))]
    for got, want, jax_b in zip(native, plain, jax_batches):
        assert sorted(got) == sorted(want) == sorted(jax_b)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
            np.testing.assert_array_equal(got[k], jax_b[k], err_msg=k)


def test_load_brain_volumes_matches_jax(tmp_path):
    """The port's directory ingest (its Python thread pool) gives the
    volumes of JAX's loader (its native ingest where that is built)."""
    from superresolution_aniso_mri_tpu.data.datasets import (
        load_brain_volumes as jax_load)
    from superresolution_aniso_mri_tpu_torch.config.data_config import (
        get_config)
    from superresolution_aniso_mri_tpu_torch.data.datasets import (
        load_brain_volumes)

    rng = np.random.RandomState(2)
    cfg = get_config("OASIS")
    suffix = cfg.lr_file_suffix(4)
    for i in range(4):
        arr = rng.rand(8, 16, 16).astype(np.float32) * 1000.0
        write_nifti(str(tmp_path / f"pat{i:02d}{suffix}"), arr,
                    spacing=[4.0, 1.0, 1.0])
        write_nifti(str(tmp_path / f"pat{i:02d}{cfg.img_file_ext}"), arr,
                    spacing=[1.0, 1.0, 1.0])
    kw = dict(split="training", include_hr_images=True,
              src_path=str(tmp_path))
    got = load_brain_volumes("OASIS", 4, **kw)
    want = jax_load("OASIS", 4, **kw)
    assert len(got) == len(want) > 0
    for a, x in zip(got, want):
        assert a.patient_id == x.patient_id
        np.testing.assert_array_equal(a.image, x.image)
        np.testing.assert_array_equal(a.image_hr, x.image_hr)
        np.testing.assert_array_equal(a.spacing, x.spacing)


def test_disable_and_build_location(monkeypatch):
    """``SRL_DISABLE_NATIVE`` is read at each call; the library is built
    from the port's own source into its ``_build/`` (never ``native/``)."""
    from superresolution_aniso_mri_tpu_torch.ops import _build

    lib = _build.library_path("srloader")
    assert lib.parent == _build.BUILD_DIR and lib.exists()
    assert "-lz" in _build.build_log("srloader")
    monkeypatch.setenv("SRL_DISABLE_NATIVE", "1")
    assert not nl.available()
    with pytest.raises(IOError):
        nl.gather_triplets([[np.zeros((2, 2), np.float32)]])
    monkeypatch.delenv("SRL_DISABLE_NATIVE")
    assert nl.available()


def test_failed_build_raises_naming_the_switch(monkeypatch):
    """A library that does not build raises (no quiet numpy fallback),
    and the message names ``SRL_DISABLE_NATIVE``."""
    from superresolution_aniso_mri_tpu_torch.ops import _build

    def no_compiler(name, extra_flags=()):
        raise RuntimeError("no C++ compiler")

    monkeypatch.setattr(nl, "_lib", None)
    monkeypatch.setattr(_build, "load_library", no_compiler)
    with pytest.raises(RuntimeError, match="SRL_DISABLE_NATIVE"):
        nl.available()
    with pytest.raises(RuntimeError, match=r"no C\+\+ compiler"):
        nl.gather_triplets([[np.zeros((2, 2), np.float32)]])
    monkeypatch.setenv("SRL_DISABLE_NATIVE", "1")
    assert not nl.available()
