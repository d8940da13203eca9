"""PyTorch port, the span facility (``utils/profiling.py``) on the CPU:
spans are off without a profiler and on under one; a stored span
carries its parent and request and lies on its ``sr.*`` kineto range;
serving, scoring and training emit their stages inside their root span,
and a second call builds nothing; the benchmark's span readers.

No JAX here: every call is the port's own, at tiny shapes.
"""
import gc
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from port_bench import harness
from superresolution_aniso_mri_tpu_torch.utils import profiling
from superresolution_aniso_mri_tpu_torch.utils.profiling import (
    Span, clear_spans, span, spans, trace)

MODEL = dict(model="ae_combined", dataset="OASIS", width=16,
             latent_width=8, depth=4, latent=6, use_batchnorm=True,
             use_sigmoid=True, lr=1e-4, seed=0)


def _traced(fn):
    """``fn()`` under a CPU profiler: (its result, the spans it stored)."""
    clear_spans()
    with profile(activities=[ProfilerActivity.CPU]):
        out = fn()
    return out, list(spans())


def _names(stored):
    return [s.name for s in stored]


def _check_tree(stored, root_name):
    """One root named ``root_name``; every other span inside its parent,
    with its request."""
    roots = [s for s in stored if s.parent is None]
    assert _names(roots) == [root_name]
    for s in stored:
        assert s.end_ns is not None and s.start_ns <= s.end_ns
        if s.parent is not None:
            parent = stored[s.parent]
            assert parent.start_ns <= s.start_ns <= s.end_ns <= parent.end_ns
            assert s.request == parent.request


def test_off_without_a_profiler_is_the_shared_noop():
    clear_spans()
    assert not torch._C._autograd._profiler_enabled()
    a, b = span("serve.request", volumes=2), span("data.gather")
    assert a is b
    with a, b:
        pass
    assert spans() == []


def test_nested_spans_carry_parent_and_request():
    def run():
        with span("serve.request", volumes=2):
            with span("serve.prep"):
                pass
            with span("serve.readback"):
                with span("synth.decode"):
                    pass
        with span("score.request", volumes=4):
            pass

    _, stored = _traced(run)
    assert _names(stored) == ["serve.request", "serve.prep",
                              "serve.readback", "synth.decode",
                              "score.request"]
    assert [s.parent for s in stored] == [None, 0, 0, 2, None]
    assert [s.index for s in stored] == list(range(5))
    assert len({s.request for s in stored[:4]}) == 1
    assert stored[4].request != stored[0].request
    assert stored[0].counts == {"volumes": 2} and stored[1].counts == {}


def _kineto_offsets_ns():
    """The largest gap, in ns, between a span's start or end and its
    ``sr.*`` range's in the profiler's own events, for two nested spans."""
    clear_spans()
    gc.disable()
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with span("train.dispatch", steps=1):
                time.sleep(0.005)
                with span("train.replay"):
                    time.sleep(0.005)
    finally:
        gc.enable()
    ranges = sorted((e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
                    for e in prof.profiler.kineto_results.events()
                    if e.name().startswith("sr."))
    stored = sorted(spans(), key=lambda s: s.start_ns)
    assert [r[2] for r in ranges] == ["sr." + s.name for s in stored]
    return max(max(abs(start - s.start_ns), abs(end - s.end_ns))
               for (start, end, _), s in zip(ranges, stored))


def test_spans_lie_on_their_kineto_ranges():
    """Each span's start and end within 1 ms of its ``sr.*`` range in the
    profiler's own events (one host clock). Two adjacent stamps are apart
    by more only when the scheduler or the garbage collector (held off
    here) pauses the thread between them, so of up to five tries one
    must come within 1 ms, and none may be 50 ms off."""
    offsets = []
    for _ in range(5):
        offsets.append(_kineto_offsets_ns())
        assert offsets[-1] < 50e6, offsets
        if offsets[-1] < 1e6:
            break
    assert min(offsets) < 1e6, offsets


def test_trace_empties_the_store_and_writes_the_ranges(tmp_path):
    import json

    def run():
        with span("serve.request"):
            pass

    assert _names(_traced(run)[1]) == ["serve.request"]
    with trace(str(tmp_path), "cpu"):
        assert spans() == []
        with span("score.request", volumes=1):
            torch.ones(2) + 1
    (path,) = tmp_path.iterdir()
    names = {e.get("name") for e in json.loads(path.read_text())
             ["traceEvents"]}
    assert "sr.score.request" in names
    assert _names(spans()) == ["score.request"]


@pytest.fixture
def serving_model():
    from superresolution_aniso_mri_tpu_torch.infer import ServingModel
    from superresolution_aniso_mri_tpu_torch.models import AEConfig

    return ServingModel(AEConfig(width=16, latent_width=8, depth=4,
                                 latent=6), device="cpu",
                        generator=torch.Generator().manual_seed(0))


SERVE_STAGES = {"serve.prep", "serve.upload", "synth.encode", "synth.mix",
                "synth.decode", "serve.readback", "serve.finalize"}


@pytest.mark.parametrize("volumes", [2, 1])
def test_serving_emits_its_stages_inside_the_request(serving_model,
                                                     volumes):
    """``create_super_volumes``: the batched path (2 volumes) and the
    per-volume path (a lone volume), then a second call without a build."""
    from superresolution_aniso_mri_tpu_torch.infer import \
        create_super_volumes

    rng = np.random.RandomState(0)
    vols = [rng.rand(5, 16, 16).astype(np.float32) for _ in range(volumes)]

    def serve():
        return create_super_volumes(serving_model, vols,
                                    alpha_range=[1 / 3, 2 / 3],
                                    latent_interp="lanczos3")

    first, stored = _traced(serve)
    _check_tree(stored, "serve.request")
    assert stored[0].counts == {"volumes": volumes}
    assert set(_names(stored)) == SERVE_STAGES | {"serve.request",
                                                  "build.core"}
    assert _names(stored).count("serve.finalize") == volumes
    again, stored = _traced(serve)
    assert not [n for n in _names(stored) if n.startswith("build.")]
    assert SERVE_STAGES <= set(_names(stored))
    for a, b in zip(first, again):
        np.testing.assert_array_equal(a["upsampled_image"],
                                      b["upsampled_image"])


def test_scoring_emits_its_stages_inside_the_request():
    from superresolution_aniso_mri_tpu_torch.data import Volume
    from superresolution_aniso_mri_tpu_torch.evaluate.sweep import (
        evaluate_prepared, prepare_sweep_batches)
    from superresolution_aniso_mri_tpu_torch.train import Trainer

    trainer = Trainer(dict(MODEL), eval_mode=True, device="cpu")
    rng = np.random.RandomState(1)
    prep = prepare_sweep_batches(
        trainer, [Volume(image=rng.rand(7, 16, 16).astype(np.float32),
                         spacing=np.ones(3), patient_id=f"v{i}")
                  for i in range(3)], 3)
    first, stored = _traced(lambda: evaluate_prepared(trainer, prep))
    _check_tree(stored, "score.request")
    assert stored[0].counts == {"volumes": 3}
    assert {"score.upload", "score.ssim", "score.psnr", "score.vif",
            "score.readback", "score.means", "synth.encode", "synth.mix",
            "synth.decode", "build.core"} <= set(_names(stored))
    again, stored = _traced(lambda: evaluate_prepared(trainer, prep))
    assert not [n for n in _names(stored) if n.startswith("build.")]
    assert again == first


def test_training_emits_dispatch_ema_gather_and_augment():
    """Two batches from the device cache on the CPU, one ``train_many``
    dispatch with the EMA on: the gather and augment spans are roots of
    their own, the dispatch holds the EMA."""
    from superresolution_aniso_mri_tpu_torch.data import (TripletSampler,
                                                          Volume,
                                                          device_batch)
    from superresolution_aniso_mri_tpu_torch.data.device_cache import \
        DeviceCachedSampler
    from superresolution_aniso_mri_tpu_torch.data.transforms import \
        AugmentConfig
    from superresolution_aniso_mri_tpu_torch.train import Trainer

    trainer = Trainer(dict(MODEL, ema_decay=0.9, batch_size=2), device="cpu")
    rng = np.random.RandomState(2)
    sampler = DeviceCachedSampler(TripletSampler(
        [Volume(image=rng.rand(9, 16, 16).astype(np.float32),
                spacing=np.ones(3))], 3, "adjacent_plus", pad_size=16,
        seed=0), "cpu")
    aug = AugmentConfig(patch_size=16)
    gen = torch.Generator().manual_seed(0)

    def dispatch():
        batches = [device_batch(sampler.sample_batch(2), aug, "cpu",
                                generator=gen) for _ in range(2)]
        return trainer.train_many(batches)

    for _ in range(2):
        _, stored = _traced(dispatch)
        assert _names(stored) == ["data.gather", "data.augment"] * 2 + [
            "train.dispatch", "train.ema"]
        assert [s.parent for s in stored] == [None] * 5 + [4]
        assert len({s.request for s in stored[:5]}) == 5
        assert stored[4].counts == {"steps": 2}


def _store(kind):
    """A hand-built store of one traced window of ``kind`` (durations in
    ms: 1 ns = 1e-6 ms, so a span of ``d`` ms is ``d * 1e6`` ns)."""
    rows = {
        "train": [("data.gather", 2.0, None, {}),
                  ("data.augment", 3.0, None, {}),
                  ("data.gather", 4.0, None, {}),
                  ("data.augment", 5.0, None, {}),
                  ("train.dispatch", 16.0, None, {"steps": 8}),
                  ("train.replay", 1.0, 4, {}),
                  ("build.graph", 1.0, 4, {})],
        "score": [("score.request", 100.0, None, {"volumes": 4}),
                  ("score.upload", 10.0, 0, {}),
                  ("score.upload", 6.0, 0, {}),
                  ("score.vif", 8.0, 0, {}),
                  ("score.means", 2.0, 0, {})],
        "serve": [("serve.request", 80.0, None, {"volumes": 2}),
                  ("serve.prep", 6.0, 0, {}),
                  ("serve.upload", 2.0, 0, {}),
                  ("serve.request", 40.0, 0, {"volumes": 1}),
                  ("serve.readback", 12.0, 3, {}),
                  ("serve.finalize", 14.0, 0, {}),
                  ("build.core", 1.0, 0, {}),
                  ("build.kernel", 1.0, 0, {})],
    }[kind]
    out, t = [], 0
    for i, (name, ms, parent, counts) in enumerate(rows):
        out.append(Span(name, t, t + int(ms * 1e6), parent,
                        0 if parent is not None else i, counts, i))
        t += 10
    return out


READERS = [
    ("data.gather_host_ms", "train", 3.0),
    ("data.augment_host_ms", "train", 4.0),
    ("train.dispatch_host_ms_per_step", "train", 2.0),
    ("score.upload_host_ms_per_volume", "score", 4.0),
    ("score.vif_host_ms_per_volume", "score", 2.0),
    ("score.means_host_ms_per_volume", "score", 0.5),
    ("serve.prep_host_ms_per_volume", "serve", 4.0),
    ("serve.readback_host_ms_per_volume", "serve", 6.0),
    ("serve.finalize_host_ms_per_volume", "serve", 7.0),
    ("program.builds.train", "train", 1),
    ("program.builds.score", "score", 0),
    ("program.builds.serve", "serve", 2),
]


@pytest.mark.parametrize("metric, kind, value", READERS,
                         ids=[r[0] for r in READERS])
def test_span_readers(metric, kind, value, monkeypatch):
    """Each reader: its value on a hand-built store of its kind; None for
    the other kinds, and for an empty store."""
    read = harness.reader(metric)
    for other in ("train", "score", "serve"):
        monkeypatch.setattr(profiling, "_STORE", _store(other))
        got = read(harness.Record(other, 1.0, {}, {}, None))
        if other == kind:
            assert got == pytest.approx(value, rel=1e-9), other
        else:
            assert got is None, other
    monkeypatch.setattr(profiling, "_STORE", [])
    assert read(harness.Record(kind, 1.0, {}, {}, None)) is None
