"""PyTorch port, the in-process parts of ``parallel/`` and the packed
decoder: JAX's ``initialize_distributed`` rules, the rows a rank keeps
of the global batch, the slice- and volume-sharded synthesizers on a
``[cpu, cpu]`` mesh against JAX's on ``create_mesh(jax.devices()[:2])``
and against their own unsharded cores, the public
``create_super_volume(s)(num_devices=2)`` path, and
``infer/packed_decoder.py`` against JAX's ``make_packed_decoder`` and
the port's own ``decode``.

Tolerance: ``atol=1e-5`` (JAX's own at ``tests/test_parallel.py:89-92``;
outputs are sigmoid values in [0, 1]), JAX run under
``jax.default_matmul_precision("highest")``.
"""
import numpy as np
import pytest
import torch

import jax

from superresolution_aniso_mri_tpu import parallel as jpar
from superresolution_aniso_mri_tpu.infer import super_volume as jsv
from superresolution_aniso_mri_tpu_torch import parallel as tpar
from superresolution_aniso_mri_tpu_torch.infer import (create_super_volume,
                                                       create_super_volumes)
from superresolution_aniso_mri_tpu_torch.infer import super_volume as tsv
from superresolution_aniso_mri_tpu_torch.parallel import distributed as tdist
from superresolution_aniso_mri_tpu_torch.train import LossConfig
from torch_port_helpers import one_torch_thread, serving_pair  # noqa: F401

ATOL = 1e-5
CPU2 = [torch.device("cpu")] * 2
ALPHAS = np.array([0.2, 0.5, 0.8], np.float32)
SR_ENV = ("SR_COORDINATOR_ADDRESS", "SR_NUM_PROCESSES", "SR_PROCESS_ID",
          "SR_MULTIHOST")


@pytest.fixture(scope="module")
def pair():
    return serving_pair(seed=4)


@pytest.fixture
def no_cluster(monkeypatch):
    """No ``SR_*`` environment and no recorded cluster."""
    for key in SR_ENV:
        monkeypatch.delenv(key, raising=False)
    monkeypatch.setattr(tdist, "_CLUSTER", None)
    monkeypatch.setattr(tdist, "_LOCAL_DEVICES", None)


def test_initialize_noop_without_config(no_cluster, monkeypatch):
    """JAX's ``tests/test_multihost.py::test_initialize_noop_without_
    config``: the no-op, a missing process id, and explicit flags beating
    ``SR_MULTIHOST=auto``."""
    init = tpar.initialize_distributed
    assert init({}) is False
    assert init({"num_processes": 1}) is False
    assert tpar.is_main_process() is True
    assert tpar.process_count() == 1 and tpar.process_index() == 0
    with pytest.raises(ValueError, match="process_id"):
        init({"coordinator_address": "x:1", "num_processes": 2})
    monkeypatch.setenv("SR_MULTIHOST", "auto")
    assert init({"num_processes": 1}) is False
    with pytest.raises(ValueError, match="incomplete"):
        init({"num_processes": 2})
    with pytest.raises(ValueError, match="incomplete"):
        init({"coordinator_address": "x:1"})
    assert tdist.cluster() == (None, 1, 0)


def test_initialize_records_the_cluster_flags_before_environment(
        no_cluster, monkeypatch):
    """Explicit flags win over ``SR_*``, the environment fills what the
    flags leave unset, and a recorded cluster names the coordinator, the
    host count and this host's index for the launcher."""
    monkeypatch.setenv("SR_COORDINATOR_ADDRESS", "env-host:9")
    monkeypatch.setenv("SR_NUM_PROCESSES", "4")
    monkeypatch.setenv("SR_PROCESS_ID", "3")
    assert tpar.initialize_distributed(
        {"coordinator_address": "flag-host:7", "process_id": 1}) is True
    assert tdist.cluster() == ("flag-host:7", 4, 1)
    monkeypatch.setattr(tdist, "_CLUSTER", None)
    assert tpar.initialize_distributed({}) is True
    assert tdist.cluster() == ("env-host:9", 4, 3)
    monkeypatch.setattr(tdist, "_CLUSTER", None)
    with pytest.raises(ValueError, match="process_id 5"):
        tpar.initialize_distributed({"process_id": 5})
    monkeypatch.setenv("SR_NUM_PROCESSES", "1")
    monkeypatch.setattr(tdist, "_CLUSTER", None)
    assert tpar.initialize_distributed({}) is False


def test_global_batch_rows_keep_pairs_whole():
    """A rank keeps rows ``[r·B/N, (r+1)·B/N)`` of each ``[B]`` leaf and
    the same block of both halves of each ``[2B]`` (``from ∥ to``) leaf,
    so the ranks' rows concatenate back to the global batch; a pair
    count N does not divide raises."""
    b = 6
    batch = {"image": torch.arange(2 * b * 2.0).reshape(2 * b, 2),
             "slice_between": torch.arange(b * 2.0).reshape(b, 2),
             "alpha_to": torch.arange(b * 1.0)}
    parts = [tpar.global_batch_from_host(batch, r, 3) for r in range(3)]
    for r, part in enumerate(parts):
        np.testing.assert_array_equal(part["alpha_to"].numpy(),
                                      [2 * r, 2 * r + 1])
        img = part["image"].numpy()
        np.testing.assert_array_equal(img[:2], batch["image"][2 * r:2 * r + 2])
        np.testing.assert_array_equal(img[2:], batch["image"][b + 2 * r:
                                                              b + 2 * r + 2])
    halves = [torch.cat([p["image"][:2] for p in parts]),
              torch.cat([p["image"][2:] for p in parts])]
    np.testing.assert_array_equal(torch.cat(halves).numpy(),
                                  batch["image"].numpy())
    with pytest.raises(ValueError, match="divisible"):
        tpar.global_batch_from_host(batch, 0, 4)
    with pytest.raises(ValueError, match="pair count"):
        tpar.global_batch_from_host({**batch, "x": torch.zeros(5)}, 0, 2)


def test_meshes_and_device_checks():
    assert tpar.local_mesh(3, "cpu") == [torch.device("cpu")] * 3
    assert tpar.create_mesh(["cpu", "cpu"]) == CPU2
    if torch.cuda.device_count() < 2:
        with pytest.raises(ValueError, match="device"):
            tpar.local_mesh(torch.cuda.device_count() + 1, "cuda")
    with pytest.raises(RuntimeError, match="process group"):
        tpar.make_sharded_train_step(LossConfig(), None, CPU2)(None, {}, 0.0)


def _kept(seed, k_true, k_pad, latent_interp, h=30, w=34):
    """A kept stack [k_pad, H, W, 1] of ``k_true`` slices, padded as
    ``create_super_volume`` pads (edge for multi-tap schemes)."""
    kept = np.random.RandomState(seed).rand(k_true, h, w, 1).astype(
        np.float32)
    return tsv._pad_kept(kept, k_pad, latent_interp)


def _nchw(x):
    return torch.from_numpy(np.moveaxis(x, -1, -3).copy())


def _nhwc(t):
    return np.moveaxis(t.numpy(), -3, -1)


@pytest.mark.parametrize("latent_interp", ["linear", "lanczos3"])
@pytest.mark.parametrize("use_original", [False, True])
def test_sharded_synthesizer_matches_jax_and_local(pair, latent_interp,
                                                   use_original):
    """Five kept slices (odd) padded to six, the slice axis split over
    two shards: the pair at the shard boundary mixes latents of the other
    shard (lanczos3 reads up to 3 slices across)."""
    stub, port = pair
    kept = _kept(5, 5, 6, latent_interp)
    params, stats = stub._ae_params()
    with jax.default_matmul_precision("highest"):
        want = jpar.make_sharded_synthesizer(
            stub._ae_model(), jpar.create_mesh(jax.devices()[:2]),
            latent_interp=latent_interp)(params, stats, kept, ALPHAS,
                                         use_original=use_original)
        want_local = jsv.make_volume_synthesizer(
            stub._ae_model(), latent_interp=latent_interp)(
                params, stats, kept, ALPHAS, use_original=use_original)
    synth = tpar.make_sharded_synthesizer(port._ae_model(), CPU2,
                                          latent_interp=latent_interp)
    got = synth(_nchw(kept), torch.from_numpy(ALPHAS), use_original,
                interleave=True)
    local = tsv.make_synthesis_core(port._ae_model(),
                                    latent_interp=latent_interp)(
        _nchw(kept), torch.from_numpy(ALPHAS), use_original, True)
    for key in ("recon", "interp"):
        np.testing.assert_allclose(_nhwc(got[key]), np.asarray(want[key]),
                                   atol=ATOL, err_msg=key)
        np.testing.assert_allclose(np.asarray(want[key]),
                                   np.asarray(want_local[key]), atol=ATOL)
    for key in ("recon", "interp", "volume"):
        np.testing.assert_allclose(got[key].numpy(), local[key].numpy(),
                                   atol=ATOL, err_msg=key)
    with pytest.raises(ValueError, match="divisible"):
        synth(_nchw(kept[:5]), torch.from_numpy(ALPHAS))


def test_sharded_batched_synthesizer_matches_jax_and_local(pair):
    """Three volumes, the last repeated to four, the volume axis split
    over two shards."""
    stub, port = pair
    vols = np.stack([_kept(10 + i, 6, 6, "lanczos3") for i in range(3)])
    vols = np.concatenate([vols, vols[-1:]])
    params, stats = stub._ae_params()
    with jax.default_matmul_precision("highest"):
        want = jpar.make_sharded_batched_synthesizer(
            stub._ae_model(), jpar.create_mesh(jax.devices()[:2]),
            latent_interp="lanczos3")(params, stats, vols, ALPHAS)
    synth = tpar.make_sharded_batched_synthesizer(
        port._ae_model(), CPU2, latent_interp="lanczos3")
    got = synth(_nchw(vols), torch.from_numpy(ALPHAS))
    local = tsv.make_batched_synthesizer(port._ae_model(),
                                         latent_interp="lanczos3")(
        _nchw(vols), torch.from_numpy(ALPHAS))
    np.testing.assert_allclose(_nhwc(got)[:3], np.asarray(want)[:3],
                               atol=ATOL)
    np.testing.assert_allclose(got.numpy(), local.numpy(), atol=ATOL)


@pytest.mark.parametrize("latent_interp", ["linear", "lanczos3"])
def test_public_paths_with_two_devices(pair, latent_interp):
    """``create_super_volume(num_devices=2)`` (29 kept slices: the kept
    count padded to the mesh) and ``create_super_volumes(num_devices=2)``
    with three volumes (the chunk padded with the last volume) equal the
    one-device outputs and JAX's two-device outputs."""
    stub, port = pair
    rng = np.random.RandomState(20)
    img = rng.rand(57, 30, 34).astype(np.float32)     # 29 kept at ds 2
    kw = dict(downsample_steps=2, alpha_range=[0.5],
              generate_inbetween_slices=True, pad_to_bucket=False,
              latent_interp=latent_interp)
    one = create_super_volume(port, img, **kw)
    two = create_super_volume(port, img, num_devices=2, **kw)
    with jax.default_matmul_precision("highest"):
        want = jsv.create_super_volume(stub, img, num_devices=2, **kw)
    assert two["upsampled_image"].shape == (57, 30, 34)
    np.testing.assert_allclose(two["upsampled_image"],
                               one["upsampled_image"], atol=ATOL)
    np.testing.assert_allclose(two["upsampled_image"],
                               want["upsampled_image"], atol=ATOL)
    imgs = [rng.rand(11, 30, 34).astype(np.float32) for _ in range(3)]
    kw = dict(downsample_steps=2, alpha_range=[0.5],
              generate_inbetween_slices=True, latent_interp=latent_interp)
    ones = create_super_volumes(port, imgs, **kw)
    twos = create_super_volumes(port, imgs, num_devices=2, **kw)
    with jax.default_matmul_precision("highest"):
        wants = jsv.create_super_volumes(stub, imgs, num_devices=2, **kw)
    for a, b, c in zip(twos, ones, wants):
        np.testing.assert_allclose(a["upsampled_image"], b["upsampled_image"],
                                   atol=ATOL)
        np.testing.assert_allclose(a["upsampled_image"], c["upsampled_image"],
                                   atol=ATOL)


BENCH_CUT = dict(width=32, latent_width=8, depth=32, latent=16,
                 use_batchnorm=True, use_sigmoid=True)


def test_packed_decoder_matches_jax_and_decode():
    """The bench widths (depth 32, latent 16; two scales here): the
    packed kernel and depth-to-space in JAX's phase-major order, and the
    packed decode against JAX's ``make_packed_decoder`` and the port's
    ``decode``; ``make_synthesis_core(packed=True)`` equals the plain
    core."""
    from superresolution_aniso_mri_tpu.infer import packed_decoder as jpd
    from superresolution_aniso_mri_tpu_torch.infer import packed_decoder as tpd

    stub, port = serving_pair(seed=6, **BENCH_CUT)
    model = port._ae_model()
    assert tpd.packable(model)
    params, stats = stub._ae_params()
    w = np.random.RandomState(0).randn(3, 3, 5, 7).astype(np.float32)
    np.testing.assert_allclose(
        tpd.pack_after_upsample_kernel(
            torch.from_numpy(w.transpose(3, 2, 0, 1).copy())).numpy(),
        np.asarray(jpd.pack_after_upsample_kernel(w)).transpose(3, 2, 0, 1),
        atol=1e-6)
    x = np.random.RandomState(1).randn(2, 3, 4, 4 * 5).astype(np.float32)
    np.testing.assert_array_equal(
        tpd.depth_to_space2(_nchw(x)).numpy(),
        np.moveaxis(np.asarray(jpd.depth_to_space2(x)), -1, 1))
    z = np.random.RandomState(2).randn(3, 8, 8, 16).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        want = jpd.make_packed_decoder(stub.model_config)(
            {"params": params, "batch_stats": stats}, z)
    with torch.no_grad():
        got = tpd.make_packed_decoder(model)(_nchw(z))
        plain = model.decode(_nchw(z))
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), atol=ATOL)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), atol=ATOL)
    kept = _nchw(_kept(3, 4, 4, "linear", 32, 32))
    alphas = torch.from_numpy(ALPHAS)
    packed = tsv.make_synthesis_core(model, packed=True)(kept, alphas,
                                                         interleave=True)
    unpacked = tsv.make_synthesis_core(model)(kept, alphas, interleave=True)
    np.testing.assert_allclose(packed["volume"].numpy(),
                               unpacked["volume"].numpy(), atol=ATOL)
    assert not tpd.packable(serving_pair(seed=6, n_res_block=1)[1]
                            ._ae_model())
