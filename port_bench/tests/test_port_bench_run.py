"""A run without a card fails and prints no result; the JAX check
compares whole top-level names; the verdict holds every number to its
limit."""
from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest

from port_bench import harness


def test_a_cpu_run_fails_without_a_result(tmp_path):
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": "", "HOME": str(tmp_path),
           "TMPDIR": str(tmp_path)}
    proc = subprocess.run(
        [sys.executable, "-m", "port_bench.run", "--workload",
         "dhcp-train-spd8", "--seed", "3000000019", "--seconds", "1",
         "--trace", "0"], cwd=harness.ROOT, env=env, capture_output=True,
        text=True, timeout=300)
    assert proc.returncode != 0
    for line in proc.stdout.splitlines():
        try:
            json.loads(line)
        except ValueError:
            continue
        raise AssertionError(f"a result line was printed: {line}")


def test_banned_names_are_whole_top_level_names(monkeypatch):
    before = set(harness.banned_modules())
    monkeypatch.setitem(sys.modules, "jaxtyping_like", sys)
    monkeypatch.setitem(sys.modules, "superresolution_aniso_mri_tpu_torch.x",
                        sys)
    assert set(harness.banned_modules()) == before
    monkeypatch.setitem(sys.modules, "jaxlib.xla_client", sys)
    assert "jaxlib" in harness.banned_modules()


def test_verdict():
    cell = harness.Cell("c", 1, {}, {}, {"a": {"limit": 1.0}}, [], [])
    assert harness.verdict(cell, {"a": 0.5}, [{"a": 0.5}])[0]
    assert not harness.verdict(cell, {"a": 1.5}, [{"a": 1.5}])[0]
    assert not harness.verdict(cell, {"a": float("nan")}, [])[0]
    assert not harness.verdict(cell, {"b": 0.0}, [])[0]
    assert harness.verdict(cell, {"a": 0.5}, [{"a": 0.5}, {"a": 2.0}])[1] == 1


@pytest.mark.parametrize("key,value", [
    ("train_latent_interp", "lanczos3"), ("slice_selection", "mix"),
    ("image_mix_loss_func", "perceptual"), ("compute_dtype", "bfloat16")])
def test_a_recipe_the_reference_does_not_follow_is_refused(key, value):
    from port_bench.drivers.train import check_recipe

    for name in ("dhcp-train-spd8", "oasis-train-spd8"):
        recipe = dict(harness.load_cell(name).config["recipe"])
        check_recipe(recipe)
        recipe[key] = value
        with pytest.raises(ValueError, match=key):
            check_recipe(recipe)
