"""PyTorch port, host side of the experiment-directory commands against
the JAX package on the CPU: the settings.yaml writer and reader (no
pyyaml in the port), the training argument parser, the synthetic
datasets, NIfTI / MetaImage files, the PNG image grids, the stall
watchdog, and one training trajectory resumed from a JAX checkpoint by
both packages' train loops.

Tiny config: width 32, latent_width 16, depth 8, latent 8, ds 2,
``--limited_load`` (4 toy volumes of 17 slices), batch 8 (8 steps an
epoch).
"""
import gzip
import math
import os
import struct
import zlib

import jax
import numpy as np
import pytest
import yaml
from hypothesis import given, settings
from hypothesis import strategies as st

from superresolution_aniso_mri_tpu.config import arguments as jargs
from superresolution_aniso_mri_tpu.config import net_config as jnet
from superresolution_aniso_mri_tpu_torch.config import (arguments, net_config,
                                                       settings as tset)

TINY = ["-d", "MNIST3D", "--use_synthetic_data", "-m", "ae_combined",
        "--image_mix_loss_func", "mse", "--downsample_steps", "2",
        "--epoch_threshold", "-1", "--width", "32", "--latent_width", "16",
        "--depth", "8", "--latent", "8", "--limited_load", "-b", "8",
        "-bt", "4", "--num_val_batches", "2", "--lr", "1e-4"]

ARGV_SETS = [
    ["--downsample_steps", "2"],
    TINY + ["-o", "/tmp/x", "-id", "run1"],
    ["-d", "OASIS", "-m", "ae_combined", "--downsample_steps", "6",
     "--width", "64", "--latent", "128", "--image_mix_loss_func", "mse",
     "-e", "1500", "-c", "it's: a #comment", "--seed", "7"],
    ["-d", "ACDC", "-m", "vae", "--downsample_steps", "3", "--lr", "1e-3",
     "--use_batchnorm", "0", "--ema_decay", "0.999", "--max_grad_norm",
     "1.0", "--compute_dtype", "bfloat16"],
    ["-d", "dHCP", "-m", "vae2", "--downsample_steps", "4", "--vae_beta",
     "2.5", "--train_latent_interp", "lanczos3", "--auto_resume",
     "--model_filename", "~/m/10.models", "--num_devices", "2"],
    ["-d", "ACDCLBL", "-m", "alpha_combined", "--downsample_steps", "2",
     "--alpha_class", "AlphaProbe16v1", "--alpha_loss_func", "mse",
     "--use_lr_scheduler", "--lr_iter_max", "1000", "-ss", "mix",
     "--mnist_path", "null", "--exper_id", "yes"],
    ["-d", "MNISTRoto", "-m", "acai_combined", "--downsample_steps", "5",
     "--aug_patch_size", "40", "--rotate_any", "--aug_noise", "--aug_blur",
     "--profile_dir", "/tmp/p", "--step_timeout_s", "12.5"],
]


def _merged(argv, mod_args, mod_net):
    _, d = mod_args.parse_args(argv)
    net = mod_net.NetworkConfig(d["model"], d["dataset"], d["ae_class"])
    return mod_net.merge_args_architecture(d, net.architecture)


def _same(a, b) -> bool:
    if isinstance(a, float) and isinstance(b, float) and math.isnan(a):
        return math.isnan(b)
    return type(a) is type(b) and a == b


def _assert_same_mapping(got: dict, want: dict) -> None:
    assert list(got) == list(want)
    for k in want:
        assert _same(got[k], want[k]), (k, got[k], want[k])


# ---------------------------------------------------------------------------
# (a) settings.yaml without pyyaml
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("argv", ARGV_SETS, ids=range(len(ARGV_SETS)))
def test_settings_writer_is_pyyaml_for_cli_settings(argv):
    """The merged settings of a CLI argv (what the Trainer writes): the
    port writes yaml.safe_dump(sort_keys=True)'s bytes, and reads them
    back as pyyaml does."""
    d = _merged(argv, jargs, jnet)
    want = yaml.safe_dump(d, sort_keys=True)
    assert tset.dump_settings(d) == want
    _assert_same_mapping(tset.parse_settings(want), yaml.safe_load(want))
    _assert_same_mapping(tset.parse_settings(want), dict(sorted(d.items())))


ADVERSARIAL = ["null", "Null", "NULL", "~", "", "yes", "No", "on", "OFF",
               "true", "1.0", "1e3", "1.0e-05", "-1", "0x1F", "0o17", "017",
               "1_000", "1:30", "2001-12-14", ".inf", "-.inf", ".nan", "=",
               "<<", "a: b", "a:b", "-a", "- a", "*a", "&a", "!a", "?a",
               "? a", "#a", "a #b", "a#b", ":a", "'q'", '"q"', "it's",
               " lead", "trail ", "a  b", "---", "...", "a\tb", "é", "a\nb",
               "a\n\n b", "\\", "x" * 90 + " y", "word " * 40,
               ("w" * 70 + " ") * 3 + "é"]
FLOATS = [1e-05, 1e17, -0.0, 0.0, 0.1, 5e-324, 1.7976931348623157e308,
          math.inf, -math.inf, math.nan, 892372.0, -2.5e-300]

keys = st.from_regex(r"[a-z_][a-z0-9_]{0,30}", fullmatch=True)
scalars = st.one_of(
    st.none(), st.booleans(), st.integers(-2 ** 70, 2 ** 70),
    st.sampled_from(FLOATS), st.floats(allow_nan=True, allow_infinity=True),
    st.sampled_from(ADVERSARIAL),
    st.text(alphabet=st.characters(min_codepoint=1, max_codepoint=0x2030),
            max_size=120),
    st.lists(st.sampled_from(ADVERSARIAL + ["w", "ord", " "]),
             max_size=40).map("".join))


@settings(max_examples=300, deadline=None)
@given(st.dictionaries(keys, scalars, max_size=8))
def test_settings_writer_matches_pyyaml_on_adversarial_scalars(d):
    want = yaml.safe_dump(d, sort_keys=True)
    assert tset.dump_settings(d) == want
    _assert_same_mapping(tset.parse_settings(want), yaml.safe_load(want))


def test_settings_round_trip_through_files(tmp_path):
    d = _merged(ARGV_SETS[2], arguments, net_config)
    d["stamp"] = np.float32(0.25)          # numpy scalars: their values
    d["count"] = np.int64(3)
    path = str(tmp_path / "settings.yaml")
    tset.save_experiment_settings(d, path)
    with open(path) as f:
        assert f.read() == yaml.safe_dump(
            {k: getattr(v, "item", lambda v=v: v)() for k, v in d.items()},
            sort_keys=True)
    from superresolution_aniso_mri_tpu.config.settings import (
        load_settings as jax_load)
    _assert_same_mapping(tset.load_settings(path), jax_load(path))


@pytest.mark.parametrize("value", [[1, 2], {"a": 1}, (1,), b"x",
                                   np.zeros(2), object()])
def test_settings_writer_rejects_other_shapes_naming_the_key(value):
    with pytest.raises(ValueError, match="'bad_key'"):
        tset.dump_settings({"ok": 1, "bad_key": value})


@pytest.mark.parametrize("text", ["a:\n  b: 1\n", "a:\n- 1\n", "- 1\n",
                                  "a: [1, 2]\n", "a: {b: 1}\n",
                                  "a: &x 1\n", "a: 2001-12-14\n",
                                  "a: 'open\n", "a: 1\na: 2\n"])
def test_settings_reader_rejects_what_it_does_not_write(text):
    with pytest.raises(ValueError):
        tset.parse_settings(text)


def test_setting_defaults_are_the_jax_list():
    from superresolution_aniso_mri_tpu.config.settings import (
        apply_setting_defaults as jax_defaults)

    assert tset.apply_setting_defaults({}) == jax_defaults({})
    assert tset.apply_setting_defaults({"lamb": 0.0})["lamb"] == 0.0


# ---------------------------------------------------------------------------
# (b) training arguments
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("argv", ARGV_SETS, ids=range(len(ARGV_SETS)))
def test_parse_args_and_merge_match_jax(argv, monkeypatch):
    """Only ``device`` differs (the port's default is cuda)."""
    monkeypatch.setenv("HOME", "/home/someone")
    _, want = jargs.parse_args(argv)
    _, got = arguments.parse_args(argv)
    assert want.pop("device") == "tpu" and got.pop("device") == "cuda"
    _assert_same_mapping(got, want)
    for env in (None, "mse"):
        if env:
            monkeypatch.setenv("SR_MIX_LOSS_DEFAULT", env)
        g = _merged(argv, arguments, net_config)
        w = _merged(argv, jargs, jnet)
        g.pop("device"), w.pop("device")
        _assert_same_mapping(g, w)


def test_parse_args_device_and_errors():
    _, d = arguments.parse_args(["--downsample_steps", "2", "--device",
                                 "cpu"])
    assert d["device"] == "cpu"
    with pytest.raises(SystemExit):
        arguments.parse_args(["--downsample_steps", "2", "--device", "tpu"])
    with pytest.raises(ValueError, match="downsample_steps"):
        arguments.parse_args([])


# ---------------------------------------------------------------------------
# (c) datasets
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("extra", [
    dict(dataset="MNIST3D", limited_load=True, downsample_steps=2),
    dict(dataset="MNIST3D", downsample_steps=3, seed=892372),
    dict(dataset="OASIS", use_synthetic_data=True, aug_patch_size=40,
         limited_load=True, downsample_steps=4),
    dict(dataset="ACDCLBL", use_synthetic_data=True, limited_load=True),
    dict(dataset="MNIST3D", limited_load=True, mnist_path="DIGITS"),
])
def test_get_datasets_volumes_are_bitwise_jax(extra, tmp_path):
    from superresolution_aniso_mri_tpu.data.datasets import (
        get_datasets as jax_get)
    from superresolution_aniso_mri_tpu_torch.data.datasets import get_datasets

    args = {"width": 32, "seed": 5, **extra}
    if args.get("mnist_path") == "DIGITS":
        digits = (np.random.RandomState(0).rand(9, 28, 28) * 255).astype(
            np.uint8)
        path = tmp_path / "train-images-idx3-ubyte.gz"
        with gzip.open(path, "wb") as f:
            f.write(struct.pack(">IIII", 0x803, 9, 28, 28) + digits.tobytes())
        args["mnist_path"] = str(path)
    got, want = get_datasets(dict(args)), jax_get(dict(args))
    for g_split, w_split in zip(got, want):
        assert len(g_split) == len(w_split)
        for g, w in zip(g_split, w_split):
            assert g.patient_id == w.patient_id
            assert g.image.dtype == w.image.dtype == np.float32
            np.testing.assert_array_equal(g.image, w.image)
            np.testing.assert_array_equal(g.spacing, w.spacing)
            if w.labels is None:
                assert g.labels is None
            else:
                np.testing.assert_array_equal(g.labels, w.labels)


def test_on_disk_datasets_raise_with_roadmap_item(tmp_path, monkeypatch):
    """ACDCLBL from disk reads labeled frames: under a data root that has
    none, both packages raise the same FileNotFoundError."""
    from superresolution_aniso_mri_tpu.data.datasets import (
        get_datasets as jax_get)
    from superresolution_aniso_mri_tpu_torch.data.datasets import get_datasets

    monkeypatch.setenv("SR_DATA_ROOT", str(tmp_path))
    for get in (get_datasets, jax_get):
        with pytest.raises(FileNotFoundError, match="no labeled ACDC frames"):
            get(dict(dataset="ACDCLBL", width=32))


def test_volume_helpers_match_jax():
    from superresolution_aniso_mri_tpu.data import volume as jv
    from superresolution_aniso_mri_tpu_torch.data import volume as tv

    rng = np.random.RandomState(3)
    arr = (rng.rand(3, 20, 24) * 400 - 50).astype(np.float32)
    arr[0, :2] = np.nan
    np.testing.assert_array_equal(tv.rescale_intensities(arr, (1, 99)),
                                  jv.rescale_intensities(arr, (1, 99)))
    np.testing.assert_array_equal(
        tv.rescale_intensities(np.ones((2, 3))),
        jv.rescale_intensities(np.ones((2, 3))))
    a3 = rng.rand(3, 20, 24).astype(np.float32)
    for kw in (dict(order=1, do_blur=True), dict(order=0, do_blur=False,
                                                 as_type=np.int32)):
        np.testing.assert_array_equal(
            tv.apply_2d_zoom_3d(a3, (2, 1, 1.5), (2, 1.4, 1.4), **kw),
            jv.apply_2d_zoom_3d(a3, (2, 1, 1.5), (2, 1.4, 1.4), **kw))
    np.testing.assert_array_equal(
        tv.apply_2d_zoom_4d(a3[None].repeat(2, 0), (1, 1, 1), (1, 2, 2)),
        jv.apply_2d_zoom_4d(a3[None].repeat(2, 0), (1, 1, 1), (1, 2, 2)))


# ---------------------------------------------------------------------------
# (d) NIfTI and MetaImage
# ---------------------------------------------------------------------------

AFFINE = np.array([[0.0, -1.2, 0.0, 10.5], [1.1, 0.0, 0.0, -3.0],
                   [0.0, 0.0, 3.0, 7.25], [0.0, 0.0, 0.0, 1.0]])


@pytest.mark.parametrize("ext", [".nii", ".nii.gz", ".mha"])
@pytest.mark.parametrize("case", ["f32_affine", "i16_labels", "4d"])
def test_image_files_cross_read_and_match_bytes(tmp_path, ext, case):
    """Written by either package, read back equal in the other; for the
    same inputs the bytes are identical (a .nii.gz's payload: gzip
    headers carry the write time)."""
    from superresolution_aniso_mri_tpu.utils import nifti as jn
    from superresolution_aniso_mri_tpu_torch.utils import nifti as tn

    rng = np.random.RandomState(1)
    spacing, affine, dtype = (3.0, 1.1, 1.2), AFFINE, None
    arr = rng.rand(4, 6, 5).astype(np.float32)
    if case == "i16_labels":
        arr, dtype = rng.randint(0, 4, (4, 6, 5)).astype(np.int16), np.int16
    elif case == "4d":              # MetaImage encodes no 4D affine
        arr, affine = rng.rand(2, 4, 6, 5).astype(np.float32), None
    paths = {}
    for name, mod in (("jax", jn), ("port", tn)):
        paths[name] = str(tmp_path / f"{name}{ext}")
        mod.write_image(paths[name], arr, spacing=spacing, affine=affine,
                        dtype=dtype)
    raw = {}
    for name, path in paths.items():
        with open(path, "rb") as f:
            raw[name] = f.read()
        if ext.endswith(".gz"):
            raw[name] = gzip.decompress(raw[name])
    assert raw["port"] == raw["jax"]
    for writer, reader in (("jax", tn), ("port", jn)):
        got = reader.read_image(paths[writer])
        want = (jn if reader is tn else tn).read_image(paths[writer])
        np.testing.assert_array_equal(got[0], want[0])
        assert got[0].dtype == want[0].dtype
        np.testing.assert_array_equal(got[1], want[1])
        if want[2] is None:
            assert got[2] is None
        else:
            np.testing.assert_array_equal(got[2], want[2])


def test_image_reader_handles_scaling_and_big_endian(tmp_path):
    """A big-endian NIfTI with scl_slope/inter and an external-payload
    .mhd read the same in both packages."""
    from superresolution_aniso_mri_tpu.utils import nifti as jn
    from superresolution_aniso_mri_tpu_torch.utils import nifti as tn

    arr = np.arange(24, dtype=">i2").reshape(2, 3, 4)
    hdr = bytearray(352)
    struct.pack_into(">i", hdr, 0, 348)
    struct.pack_into(">8h", hdr, 40, 3, 4, 3, 2, 1, 1, 1, 1)
    struct.pack_into(">h", hdr, 70, 4)
    struct.pack_into(">8f", hdr, 76, 1, 0.5, 0.5, 2.0, 1, 1, 1, 1)
    struct.pack_into(">f", hdr, 108, 352.0)
    struct.pack_into(">ff", hdr, 112, 2.0, -1.0)
    nii = tmp_path / "be.nii"
    nii.write_bytes(bytes(hdr) + arr.tobytes())
    (tmp_path / "v.raw").write_bytes(arr.astype("<f4").tobytes())
    (tmp_path / "v.mhd").write_text(
        "NDims = 3\nDimSize = 4 3 2\nElementSpacing = 1 2 3\n"
        "ElementType = MET_FLOAT\nElementDataFile = v.raw\n")
    for path in (nii, tmp_path / "v.mhd"):
        got, want = tn.read_image(str(path)), jn.read_image(str(path))
        np.testing.assert_array_equal(got[0], want[0])
        assert got[0].dtype == want[0].dtype
        np.testing.assert_array_equal(got[1], want[1])


# ---------------------------------------------------------------------------
# (i) PNG image grids
# ---------------------------------------------------------------------------

def _decode_gray8_png(data: bytes) -> np.ndarray:
    """8-bit grayscale, non-interlaced PNG → [H, W] uint8 (zlib only;
    the port writes filter type 0 on every row)."""
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, idat, ihdr = 8, b"", None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        (crc,) = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        assert crc == zlib.crc32(kind + body) & 0xFFFFFFFF
        if kind == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat += body
        pos += 12 + n
    w, h, depth, color, _, _, interlace = ihdr
    assert (depth, color, interlace) == (8, 0, 0)
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, w + 1)
    assert not rows[:, 0].any()
    return rows[:, 1:]


@pytest.mark.parametrize("kind", ["recon", "compare", "overshoot", "uint8",
                                  "0_255"])
def test_png_grid_decodes_to_the_jax_grid(tmp_path, kind):
    from PIL import Image

    from superresolution_aniso_mri_tpu.utils import grids as jg
    from superresolution_aniso_mri_tpu_torch.utils import grids as tg

    rng = np.random.RandomState(2)
    batch = rng.rand(6, 12, 10, 1).astype(np.float32)
    recon = rng.rand(6, 12, 10, 1).astype(np.float32)
    if kind == "compare":
        grid = jg.create_compare_image(batch[..., 0], recon[..., 0])
        np.testing.assert_array_equal(
            tg.create_compare_image(batch[..., 0], recon[..., 0]), grid)
    else:
        grid = jg.generate_recon_grid(batch, recon)
        np.testing.assert_array_equal(
            tg.generate_recon_grid(batch[..., 0], recon[..., 0]), grid)
    if kind == "overshoot":
        grid = grid * 1.02
    elif kind == "uint8":
        grid = (grid * 40).astype(np.uint8)
    elif kind == "0_255":
        grid = grid * 255.0
    jg.save_image_grid(grid, str(tmp_path / "jax.png"))
    tg.save_image_grid(grid, str(tmp_path / "port" / "port.png"))
    want = np.asarray(Image.open(tmp_path / "jax.png"))
    got = _decode_gray8_png((tmp_path / "port" / "port.png").read_bytes())
    assert got.shape == want.shape == grid.shape[:2]
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# stall watchdog
# ---------------------------------------------------------------------------

def test_watchdog_fires_only_when_armed_and_silent():
    import time

    from superresolution_aniso_mri_tpu_torch.utils.watchdog import (
        StepWatchdog)

    fired = []
    wd = StepWatchdog(1.0, on_stall=lambda *a: fired.append(a), poll_s=0.05,
                      label="t").start()
    for _ in range(6):
        time.sleep(0.05)
        wd.beat()
    with wd.suspended():
        time.sleep(1.5)
    assert not fired
    deadline = time.time() + 10
    while not fired and time.time() < deadline:
        time.sleep(0.05)
    wd.stop()
    assert fired and fired[0][1] == 6 and fired[0][2] == "t"
    with pytest.raises(ValueError, match="first_timeout_s"):
        StepWatchdog(2.0, first_timeout_s=1.0)


# ---------------------------------------------------------------------------
# (f) training trajectory: both train loops resume from a JAX checkpoint
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_epoch0(tmp_path_factory):
    """JAX trains the tiny config for one epoch → models/0.models."""
    from superresolution_aniso_mri_tpu.cli.train_loop import run_training

    out = tmp_path_factory.mktemp("jax_epoch0")
    _, d = jargs.parse_args(TINY + ["-e", "1", "-o", str(out), "-id", "e0"])
    with jax.default_matmul_precision("highest"):
        run_training(d, verbose=False)
    return os.path.join(str(out), "e0", "models", "0.models")


def test_resumed_training_matches_jax(jax_epoch0, tmp_path):
    """Resume the JAX epoch-0 checkpoint (weights, BN statistics and Adam
    moments) with ``-e 2`` into fresh directories: the same sampler
    batches, one epoch of 8 steps and 2 validation batches in each
    package. The epoch means of every train and validation loss agree to
    rtol 1e-4 (the gap is float32 summation order; the Adam sign flips
    of PERF.md §6 do not reach this tolerance at lr 1e-4 within one
    epoch)."""
    from superresolution_aniso_mri_tpu.cli.train_loop import (
        run_training as jax_run)
    from superresolution_aniso_mri_tpu_torch.cli.train_loop import (
        run_training)

    resume = ["-e", "2", "--model_filename", jax_epoch0, "-o",
              str(tmp_path)]
    _, jd = jargs.parse_args(TINY + resume + ["-id", "jax"])
    _, pd = arguments.parse_args(TINY + resume + ["-id", "port",
                                                  "--device", "cpu"])
    with jax.default_matmul_precision("highest"):
        jt = jax_run(jd, verbose=False)
    pt = run_training(pd, verbose=False)
    assert pt.epoch == jt.epoch == 2 and pt.iters == jt.iters == 9
    for npz in ("losses_train.npz", "losses_test.npz", "loss_iters.npz"):
        got = np.load(tmp_path / "port" / npz)
        want = np.load(tmp_path / "jax" / npz)
        assert sorted(got.files) == sorted(want.files), npz
        for k in want.files:
            assert got[k].shape == want[k].shape == (1,), (npz, k)
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4,
                                       atol=1e-12, err_msg=f"{npz} {k}")
    assert sorted(os.listdir(tmp_path / "port" / "models")) == sorted(
        os.listdir(tmp_path / "jax" / "models")) == [
        "1.models", "ae.models", "caisr.models", "last.models"]
    # the resumed weights stay within 2·lr·steps of JAX's
    from superresolution_aniso_mri_tpu_torch.models import flax_to_torch
    from superresolution_aniso_mri_tpu_torch.train import load_checkpoint_raw

    raw = load_checkpoint_raw(str(tmp_path / "jax" / "models" / "1.models"))
    want_sd = flax_to_torch(raw["model_dict_ae"], raw["batch_stats"],
                            pt.model_config)
    for k, v in pt.model.state_dict().items():
        limit = 1e-4 * max(1.0, float(v.abs().max())) if "running" in k \
            else 2 * 1e-4 * 8
        assert float((v - want_sd[k]).abs().max()) <= limit, k
