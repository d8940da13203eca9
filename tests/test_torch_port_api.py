"""The port's public surface against the JAX package's, on the CPU.

Every name a JAX subpackage's ``__init__`` exports resolves in the
port's namesake, except the JAX sharding concepts listed in
``JAX_ONLY`` (each with the port name that does its work). The four
public functions that the port copies without a caller of its own
(``ops.l1``, ``data.get_paired_frames``, ``data.get_paired_slices``,
``utils.grids.generate_batch_compare_grid``) are held to JAX's on
seeded numpy inputs: ``l1`` within ``L1_RTOL`` relative (float32 sums in
another order), the others exactly.
"""
import ast
import importlib
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import superresolution_aniso_mri_tpu as jpkg
from superresolution_aniso_mri_tpu.data import volume as jvolume
from superresolution_aniso_mri_tpu.ops import losses as jlosses
from superresolution_aniso_mri_tpu.utils import grids as jgrids
from superresolution_aniso_mri_tpu_torch import data as pdata
from superresolution_aniso_mri_tpu_torch import ops as pops
from superresolution_aniso_mri_tpu_torch.utils import grids as pgrids

PORT = "superresolution_aniso_mri_tpu_torch"
L1_RTOL = 1e-6

# JAX names that are sharding concepts of jax.sharding and flax, mapped
# to the port name that does the same work
JAX_ONLY = {
    # a NamedSharding of the batch axis: the port's ranks each hold
    # their rows, cut by shard_batch
    ("parallel", "batch_sharding"): "parallel.shard_batch",
    # a NamedSharding with no axis: the port broadcasts rank 0's state
    ("parallel", "replicated"): "parallel.replicate_state",
    # flax's TrainState + BatchNorm statistics: the port's module holds
    # its statistics, its optimizer and its step count
    ("train", "SRTrainState"): "train.TrainState",
}


def _jax_exports():
    """(subpackage, name) for every name a JAX ``__init__`` imports
    from its package or lists in ``__all__``."""
    root = os.path.dirname(jpkg.__file__)
    out = []
    for d, _, files in sorted(os.walk(root)):
        if "__init__.py" not in files or "__pycache__" in d:
            continue
        sub = os.path.relpath(d, root).replace(os.sep, ".")
        sub = "" if sub == "." else sub
        with open(os.path.join(d, "__init__.py")) as f:
            tree = ast.parse(f.read())
        names = set()
        for node in ast.walk(tree):
            if isinstance(node, ast.ImportFrom) and node.level >= 1:
                names.update(a.asname or a.name for a in node.names)
            target = (node.targets[0] if isinstance(node, ast.Assign)
                      else node.target if isinstance(node, ast.AugAssign)
                      else None)
            if getattr(target, "id", None) == "__all__" and isinstance(
                    node.value, (ast.List, ast.Tuple)):
                names.update(e.value for e in node.value.elts)
        out += [(sub, n) for n in sorted(names)]
    return out


JAX_EXPORTS = _jax_exports()


def test_jax_exports_are_found():
    subs = {s for s, _ in JAX_EXPORTS}
    assert {"cli", "data", "evaluate", "infer", "models", "ops",
            "parallel", "train"} <= subs
    assert len(JAX_EXPORTS) > 200
    assert set(JAX_ONLY) <= set(JAX_EXPORTS)


@pytest.mark.parametrize("sub", sorted({s for s, _ in JAX_EXPORTS}))
def test_every_jax_export_resolves_in_the_port(sub):
    mod = importlib.import_module(PORT + (f".{sub}" if sub else ""))
    missing = []
    for s, name in JAX_EXPORTS:
        if s != sub:
            continue
        if (s, name) in JAX_ONLY:
            psub, pname = JAX_ONLY[(s, name)].split(".")
            assert hasattr(importlib.import_module(f"{PORT}.{psub}"),
                           pname), JAX_ONLY[(s, name)]
            assert not hasattr(mod, name), (
                f"{sub}.{name} is ported now: take it out of JAX_ONLY")
            continue
        if not hasattr(mod, name):
            missing.append(name)
        elif name in getattr(mod, "__all__", [name]):
            continue
        else:
            missing.append(f"{name} (not in __all__)")
    assert not missing, f"{PORT}.{sub} lacks {missing}"


@pytest.mark.parametrize("shape", [(7,), (4, 1, 16, 16), (3, 33, 17)])
def test_l1_matches_jax(shape):
    rs = np.random.RandomState(sum(shape))
    a = rs.rand(*shape).astype(np.float32)
    b = rs.randn(*shape).astype(np.float32)
    want = float(jlosses.l1(jnp.asarray(a), jnp.asarray(b)))
    got = pops.l1(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.float32 and got.shape == ()
    assert abs(float(got) - want) <= L1_RTOL * abs(want)


@pytest.mark.parametrize("num_frames", [2, 3, 12, 30])
@pytest.mark.parametrize("seed", range(4))
def test_get_paired_frames_matches_jax(num_frames, seed):
    jrs, prs = np.random.RandomState(seed), np.random.RandomState(seed)
    for _ in range(3):   # the draws go on alike
        want = jvolume.get_paired_frames(num_frames, jrs)
        got = pdata.get_paired_frames(num_frames, prs)
        for w, g in zip(want, got):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
    assert jrs.randint(1 << 30) == prs.randint(1 << 30)


@pytest.mark.parametrize("num_slices", [2, 5, 37])
@pytest.mark.parametrize("seed", [None, 0, 1, 2, 3])
def test_get_paired_slices_matches_jax(num_slices, seed):
    jrs = None if seed is None else np.random.RandomState(seed)
    prs = None if seed is None else np.random.RandomState(seed)
    for _ in range(3):
        want = jvolume.get_paired_slices(num_slices, jrs)
        got = pdata.get_paired_slices(num_slices, prs)
        for w, g in zip(want, got):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("b,max_items,channel", [
    (2, 6, False), (4, 6, True), (8, 6, True), (8, 3, False), (1, 6, True)])
def test_generate_batch_compare_grid_matches_jax(b, max_items, channel):
    rs = np.random.RandomState(b * 10 + max_items)
    tail = (12, 10, 1) if channel else (12, 10)
    image = rs.rand(2 * b, *tail).astype(np.float32)
    between, synth, recon = (rs.rand(b, *tail).astype(np.float32)
                             for _ in range(3))
    want = jgrids.generate_batch_compare_grid(image, between, synth, recon,
                                              max_items=max_items)
    got = pgrids.generate_batch_compare_grid(image, between, synth, recon,
                                             max_items=max_items)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
