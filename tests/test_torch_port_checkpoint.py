"""PyTorch port, checkpoints: the msgpack codec, the flax ↔ torch name
maps, and experiment checkpoints in both directions between the JAX
package and the port, on the CPU.

Exact where the data is the same bits: the codec's bytes against
``flax.serialization.msgpack_serialize``, trees read back, the converter
round trip. After a checkpoint crosses over, one more train step in each
package agrees as in ``test_torch_port_train.py``: metrics rtol 1e-4,
parameters within 2·lr.
"""
import os
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from superresolution_aniso_mri_tpu.train.checkpoint import (
    load_checkpoint as jax_load_checkpoint,
    save_checkpoint as jax_save_checkpoint)
from superresolution_aniso_mri_tpu.train.steps import (
    LossConfig as JaxLossConfig, make_train_step as jax_make_train_step)
from superresolution_aniso_mri_tpu_torch.models import (AEConfig,
                                                        flax_to_torch,
                                                        torch_to_flax)
from superresolution_aniso_mri_tpu_torch.models.convert import (
    flax_moments_to_torch)
from superresolution_aniso_mri_tpu_torch.train import (LossConfig,
                                                       load_checkpoint,
                                                       load_checkpoint_raw,
                                                       make_train_step,
                                                       save_checkpoint)
from superresolution_aniso_mri_tpu_torch.train import msgpack
from torch_port_helpers import (SMALL, adam_moments, jax_model,
                                jax_train_state, np_batch, port_train_state,
                                torch_batch)

LR, MIX = 1e-4, 0.3
LOSS = dict(model="ae_combined", image_mix_loss_func="mse")
OPT = dict(lr=LR, max_grad_norm=1.0, weight_decay=1e-3, warmup_steps=2,
           cosine_steps=20)


def _assert_trees_equal(got, want, path="tree"):
    """Same keys, and leaves with the same type, dtype, shape and bits."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(want), path
        for k in want:
            _assert_trees_equal(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_trees_equal(g, w, f"{path}/{i}")
    elif isinstance(want, (np.ndarray, np.generic)):
        assert type(got) is type(want), path
        assert got.dtype == want.dtype and got.shape == want.shape, path
        assert np.asarray(got).tobytes() == np.asarray(want).tobytes(), path
    else:
        assert type(got) is type(want) and got == want, path


def _codec_tree():
    rng = np.random.RandomState(0)
    ints = [0, 1, 127, 128, 255, 256, 65535, 65536, 2 ** 32 - 1, 2 ** 32,
            2 ** 63, -1, -32, -33, -128, -129, -32768, -32769,
            -(2 ** 31), -(2 ** 31) - 1, -(2 ** 63)]
    return {
        "ints": ints, "floats": [0.0, -1.5, 1e300, float("inf")],
        "flags": [True, False, None],
        "strs": ["", "a" * 31, "b" * 32, "c" * 255, "d" * 256,
                 "é" * 40000],
        "bins": [b"", b"x" * 255, b"y" * 256, b"z" * 70000],
        "big_map": {f"k{i}": i for i in range(20)},
        "big_list": list(range(17)),
        "arrays": {"f32": rng.randn(3, 4).astype(np.float32),
                   "i32_0d": np.asarray(7, np.int32),
                   "i64_0d": np.asarray(123456789012, np.int64),
                   "u8_empty": np.zeros((0, 3), np.uint8),
                   "bool": np.array([True, False]),
                   "f64_big": rng.randn(100, 100),
                   "f16": rng.randn(8).astype(np.float16)},
        "scalars": [np.float32(1.5), np.int32(-3), np.bool_(True)],
        "empty": {},
    }


def test_msgpack_writes_flax_bytes_and_reads_them_back():
    tree = _codec_tree()
    blob = serialization.msgpack_serialize(tree)
    assert msgpack.packb(tree) == blob
    _assert_trees_equal(msgpack.unpackb(blob),
                        serialization.msgpack_restore(blob))


@pytest.mark.parametrize("obj", [{1, 2}, 1 + 2j, object(),
                                 np.array([object()], dtype=object)])
def test_msgpack_rejects_other_types(obj):
    with pytest.raises((TypeError, ValueError)):
        msgpack.packb(obj)


def test_msgpack_rejects_other_extensions_and_bad_data():
    with pytest.raises(ValueError, match="extension type 2"):
        msgpack.unpackb(serialization.msgpack_serialize({"c": 1 + 2j}))
    with pytest.raises(ValueError, match="truncated"):
        msgpack.unpackb(msgpack.packb({"a": "text"})[:-1])
    with pytest.raises(ValueError, match="extra bytes"):
        msgpack.unpackb(msgpack.packb(1) + b"\x00")
    bf16 = serialization.msgpack_serialize(
        {"w": np.asarray(jnp.ones(3, jnp.bfloat16))})
    with pytest.raises(ValueError, match="bfloat16"):
        msgpack.unpackb(bf16)


ARCHS = {"bn": {}, "no_bn": dict(use_batchnorm=False),
         "res_block": dict(n_res_block=1),
         "conv_transpose": dict(use_upsample=False),
         "stem_pad_parity": dict(stem_pad_parity=True)}


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_torch_to_flax_inverts_flax_to_torch(arch):
    _, params, stats = jax_model(4, **ARCHS[arch])
    cfg = AEConfig(**SMALL, **ARCHS[arch])
    sd = flax_to_torch(params, stats, cfg)
    back_params, back_stats = torch_to_flax(sd)
    want = jax.tree_util.tree_map(np.asarray, (params, stats))
    _assert_trees_equal(back_params, want[0])
    _assert_trees_equal(back_stats, want[1] if want[1] else {})
    again = flax_to_torch(back_params, back_stats, cfg)
    for k, v in sd.items():
        assert torch.equal(again[k], v), k
    mu = flax_moments_to_torch(params, cfg)
    _assert_trees_equal(torch_to_flax(mu)[0], want[0])
    assert torch_to_flax(mu)[1] == {}


def _filled_jax_state(model, params, stats, seed):
    """A JAX train state whose Adam moments and counts are not zero."""
    rng = np.random.RandomState(seed)
    state = jax_train_state(model, params, stats, **OPT)

    def fill(x):
        x = np.asarray(x)
        if x.dtype == np.int32:
            return np.asarray(7, np.int32)
        return (rng.rand(*x.shape).astype(x.dtype) * 1e-3)

    return state.replace(opt_state=jax.tree_util.tree_map(fill,
                                                          state.opt_state))


@pytest.mark.parametrize("arch", ["bn", "no_bn"])
def test_jax_checkpoint_loads_in_port(tmp_path, arch):
    """A JAX-written file reads in the port as the same trees, bit for
    bit, and restores weights, statistics, moments, counts and epoch
    without a warning."""
    model_kw = ARCHS[arch]
    model, params, stats = jax_model(5, **model_kw)
    jstate = _filled_jax_state(model, params, stats, 5)
    path = str(tmp_path / "3.models")
    jax_save_checkpoint(path, jstate, epoch=3)
    with open(path, "rb") as f:
        blob = f.read()[16:]
    _assert_trees_equal(load_checkpoint_raw(path),
                        serialization.msgpack_restore(blob))

    _, params0, stats0 = jax_model(6, **model_kw)
    pstate = port_train_state(params0, stats0, model_kw, **OPT)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        pstate, epoch = load_checkpoint(path, pstate)
    assert epoch == 3
    cfg = AEConfig(**SMALL, **model_kw)
    for k, v in flax_to_torch(params, stats, cfg).items():
        assert torch.equal(pstate.model.state_dict()[k], v), k
    count, mu, nu = adam_moments(jstate.opt_state)
    assert pstate.opt_state.count == count == 7
    assert pstate.opt_state.schedule_count == 7
    for got, want in ((pstate.opt_state.mu, mu), (pstate.opt_state.nu, nu)):
        for k, v in flax_moments_to_torch(want, cfg).items():
            assert torch.equal(got[k], v), k


@pytest.mark.parametrize("arch", ["bn", "no_bn"])
def test_port_checkpoint_loads_in_jax(tmp_path, arch):
    """A port-written file: flax reads it as the port's trees (and the
    bytes are flax's); JAX load_checkpoint takes it with no warning
    (moments included); one more step in each package then agrees."""
    model_kw = ARCHS[arch]
    model, params, stats = jax_model(7, **model_kw)
    pstate = port_train_state(params, stats, model_kw, **OPT)
    pstep = make_train_step(LossConfig(**LOSS))
    for i in range(2):
        pstep(pstate, torch_batch(np_batch(10 + i)), MIX)
    path = str(tmp_path / "models" / "last.models")
    save_checkpoint(path, pstate, epoch=5)
    assert sorted(os.listdir(tmp_path / "models")) == ["last.models"]
    with open(path, "rb") as f:
        head, blob = f.read(16), f.read()
    assert head[:8] == b"SRTPU1\x00\x00"
    assert int.from_bytes(head[8:], "little") == len(blob)
    restored = serialization.msgpack_restore(blob)
    _assert_trees_equal(load_checkpoint_raw(path), restored)
    assert serialization.msgpack_serialize(restored) == blob
    assert restored["epoch"].dtype == np.int64 and restored["epoch"] == 5

    _, params0, stats0 = jax_model(8, **model_kw)
    template = jax_train_state(model, params0, stats0, **OPT)
    want_layout = serialization.to_state_dict(template.opt_state)
    assert jax.tree_util.tree_structure(want_layout) == \
        jax.tree_util.tree_structure(restored["optimizer_dict_ae"])
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        jstate, epoch = jax_load_checkpoint(path, template)
    assert epoch == 5
    got_params, got_stats = torch_to_flax(pstate.model.state_dict())
    _assert_trees_equal(jax.tree_util.tree_map(np.asarray, jstate.params),
                        got_params)
    count, mu, _ = adam_moments(jstate.opt_state)
    assert count == pstate.opt_state.count == 2
    _assert_trees_equal(jax.tree_util.tree_map(np.asarray, mu),
                        torch_to_flax(pstate.opt_state.mu)[0])

    nb = np_batch(20)
    with jax.default_matmul_precision("highest"):
        jstate, jm = jax_make_train_step(model, JaxLossConfig(**LOSS),
                                         donate=False)(
            jstate, {k: jnp.asarray(v) for k, v in nb.items()},
            jax.random.PRNGKey(0), jnp.float32(MIX))
    pstate, pm = pstep(pstate, torch_batch(nb), MIX)
    for k in jm:
        np.testing.assert_allclose(float(pm[k]), float(jm[k]), rtol=1e-4,
                                   err_msg=k)
    drift = jax.tree_util.tree_map(
        lambda a, b: float(np.abs(np.asarray(a) - b).max()), jstate.params,
        torch_to_flax(pstate.model.state_dict())[0])
    assert max(jax.tree_util.tree_leaves(drift)) <= 2 * LR


def test_other_optimizer_layout_restores_weights_only(tmp_path):
    """As in JAX: weights load, the optimizer state stays the state's
    own, with a warning."""
    _, params, stats = jax_model(9)
    pstate = port_train_state(params, stats, lr=LR)
    make_train_step(LossConfig(**LOSS))(pstate, torch_batch(np_batch(0)),
                                        MIX)
    path = str(tmp_path / "a.models")
    save_checkpoint(path, pstate, epoch=1)
    other = port_train_state(*jax_model(10)[1:], **OPT)
    with pytest.warns(UserWarning, match="restart fresh"):
        other, epoch = load_checkpoint(path, other)
    assert epoch == 1
    for k, v in pstate.model.state_dict().items():
        assert torch.equal(other.model.state_dict()[k], v), k
    assert other.opt_state.count == 0
    assert all(float(v.abs().max()) == 0 for v in other.opt_state.mu.values())


def test_load_rejects_other_files(tmp_path):
    path = tmp_path / "x.models"
    path.write_bytes(b"PK\x03\x04 not a checkpoint")
    with pytest.raises(ValueError, match="not a SRTPU checkpoint"):
        load_checkpoint_raw(str(path))
