"""PyTorch port of the perceptual tools against the JAX package's
``tools/``: the distortion suite and its tables (``lpips_gap_study``),
the encoder-perceptual artifact (``fit_perceptual_head``) and the LPIPS
weight converter (``convert_lpips_weights``), on the CPU at 32² slices.

Tolerances: the suite and the slices are copied numpy (equal arrays);
the gap study's per-pair distances within 1e-5 relative (JAX under
``jax.default_matmul_precision("highest")``) with equal rounded tables;
the fitted lins within 1e-4 relative after 50 Adam iterations (2.6e-6
measured); the converted npz bit for bit.
"""
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from superresolution_aniso_mri_tpu.config.settings import \
    save_experiment_settings
from superresolution_aniso_mri_tpu.train import checkpoint as jckpt
from superresolution_aniso_mri_tpu_torch.tools import (convert_lpips_weights,
                                                       fit_perceptual_head,
                                                       lpips_gap_study)
from torch_port_helpers import (SMALL, jax_model, jax_train_state,  # noqa: F401
                                one_torch_thread)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))
import convert_lpips_weights as jconvert  # noqa: E402
import fit_perceptual_head as jfit  # noqa: E402
import lpips_gap_study as jgap  # noqa: E402

SHIPPED_ENC = os.path.join(REPO, "weights", "perceptual_enc.npz")
SIZE, N_SLICES = 32, 2
FIT_ITERS = 50


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


# ---------------------------------------------------------------------------
# lpips_gap_study
# ---------------------------------------------------------------------------

def test_suite_slices_and_statistics_match_jax():
    sl_j = jgap.reference_slices(3, SIZE, seed_base=1000)
    sl_p = lpips_gap_study.reference_slices(3, SIZE, seed_base=1000)
    for a, b in zip(sl_j, sl_p):
        np.testing.assert_array_equal(a, b)
    suite_j = jgap.distortion_suite(np.random.RandomState(5))
    suite_p = lpips_gap_study.distortion_suite(np.random.RandomState(5))
    assert [s[:3] for s in suite_j] == [s[:3] for s in suite_p]
    for sl in sl_p:
        want = np.stack([np.clip(fn(sl), 0.0, 1.0).astype(np.float32)
                         for _, _, _, fn in suite_j])
        np.testing.assert_array_equal(
            lpips_gap_study.distorted(sl, suite_p), want)
    rng = np.random.RandomState(0)
    a, b = rng.rand(16), rng.rand(16)
    b[3] = b[4]
    assert lpips_gap_study.spearman(a, b) == jgap.spearman(a, b)
    assert (lpips_gap_study.pairwise_agreement(a, b)
            == jgap.pairwise_agreement(a, b))


def _recording(module, name, store):
    fn = getattr(module, name)

    def rec(*a, **kw):
        out = fn(*a, **kw)
        store.append(np.asarray(out, np.float64).ravel())
        return out

    return rec


def test_run_study_matches_jax(monkeypatch):
    """Per-pair distances (JAX's recorded from its own run) within 1e-5
    relative, and the same rounded correlation tables, with the encoder
    artifact gated too."""
    from superresolution_aniso_mri_tpu.ops import lpips as jl
    from superresolution_aniso_mri_tpu.ops import metrics as jm
    from superresolution_aniso_mri_tpu.ops import perceptual as jp

    rec = {k: [] for k in ("lpips", "msssim", "vif", "enc")}
    for mod, name, key in ((jl, "lpips_distance", "lpips"),
                           (jm, "msssim2d", "msssim"),
                           (jm, "vif2d", "vif"),
                           (jp, "enc_lpips_distance", "enc")):
        monkeypatch.setattr(mod, name, _recording(mod, name, rec[key]))
    with jax.default_matmul_precision("highest"):
        want = jgap.run_study(N_SLICES, SIZE, seed=0, enc_npz=SHIPPED_ENC)
    got = lpips_gap_study.run_study(N_SLICES, SIZE, seed=0,
                                    enc_npz=SHIPPED_ENC, device="cpu")
    assert got == want

    # the port's per-pair distances on the same slices and distortions
    rs = np.random.RandomState(0)
    suite = lpips_gap_study.distortion_suite(rs)
    params = lpips_gap_study.get_lpips_params(device="cpu")
    enc = lpips_gap_study.load_enc_perceptual(SHIPPED_ENC, "cpu")
    rows = {k: [] for k in rec}
    for sl in lpips_gap_study.reference_slices(N_SLICES, SIZE):
        d = lpips_gap_study.score_suite(
            sl, lpips_gap_study.distorted(sl, suite), params, enc,
            lpips_gap_study.msssim_levels(SIZE), "cpu")
        for k in rows:
            rows[k].extend(d[k])
    for k in rows:
        jax_vals = np.concatenate(rec[k])
        if k in ("msssim", "vif"):
            jax_vals = 1.0 - jax_vals
        assert len(jax_vals) == len(rows[k]) == 16 * N_SLICES
        assert _rel(rows[k], jax_vals) <= 1e-5, k


# ---------------------------------------------------------------------------
# fit_perceptual_head
# ---------------------------------------------------------------------------

EXPER_ARGS = dict(model="ae_combined", dataset="OASIS", lr=1e-4, epochs=1,
                  seed=0, use_batchnorm=True, use_sigmoid=True, **SMALL)


@pytest.fixture(scope="module")
def jax_exper(tmp_path_factory):
    """A JAX-written experiment directory (settings.yaml and
    models/caisr.models) and its flax tree."""
    model, params, stats = jax_model(3)
    exper = str(tmp_path_factory.mktemp("fit") / "exper")
    os.makedirs(os.path.join(exper, "models"))
    save_experiment_settings(EXPER_ARGS,
                             os.path.join(exper, "settings.yaml"))
    jckpt.save_checkpoint(os.path.join(exper, "models", "caisr.models"),
                          jax_train_state(model, params, stats, lr=1e-4), 3)
    return exper, model, params, stats


def _jax_enc_params(model, params, stats, lins):
    return {"kind": "enc", "cfg": model.config,
            "variables": {"params": params["enc"],
                          "batch_stats": stats["enc"]},
            "lins": lins, "meta": {}}


def test_harvest_encoder_reads_a_jax_experiment(jax_exper):
    exper, model, params, stats = jax_exper
    cfg, variables, family = fit_perceptual_head.harvest_encoder(
        exper, "caisr", "cpu")
    assert family == "ae_combined"
    assert {k: getattr(cfg, k) for k in ("width", "latent_width", "depth",
                                         "latent", "use_batchnorm")} == {
        k: getattr(model.config, k) for k in ("width", "latent_width",
                                              "depth", "latent",
                                              "use_batchnorm")}
    for coll, tree in (("params", params), ("batch_stats", stats)):
        got = jax.tree_util.tree_leaves_with_path(variables[coll])
        want = jax.tree_util.tree_leaves_with_path(tree["enc"])
        assert [p for p, _ in got] == [p for p, _ in want]
        for (_, a), (_, b) in zip(got, want):
            np.testing.assert_array_equal(a, b)


def test_harvest_encoder_takes_the_ae_of_a_family(tmp_path):
    """An acai_combined experiment's encoder is its ``ae``'s."""
    from superresolution_aniso_mri_tpu_torch.models.convert import \
        torch_to_flax
    from superresolution_aniso_mri_tpu_torch.train import Trainer

    tr = Trainer(dict(EXPER_ARGS, model="acai_combined",
                      output_dir=str(tmp_path / "exp")), device="cpu")
    tr.prepare_run()
    tr.save_models(os.path.join(tr.dir_models, "caisr.models"), 1)
    _, variables, family = fit_perceptual_head.harvest_encoder(
        str(tmp_path / "exp"), "caisr", "cpu")
    assert family == "acai_combined"
    params, stats = torch_to_flax(tr.model["ae"].state_dict())
    for coll, tree in (("params", params), ("batch_stats", stats)):
        got = jax.tree_util.tree_leaves(variables[coll])
        want = jax.tree_util.tree_leaves(tree["enc"])
        assert len(got) == len(want)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


def test_harvest_without_an_encoder_exits_like_jax(monkeypatch):
    from superresolution_aniso_mri_tpu_torch.models.acai import Decoder
    from superresolution_aniso_mri_tpu_torch.models.config import AEConfig

    class PortStub:
        args = {"model": "nothing"}
        model_config = AEConfig(**SMALL)

        def _ae_model(self):
            return torch.nn.ModuleDict({"dec": Decoder(self.model_config)})

    class JaxStub:
        args = {"model": "nothing"}

        class state:
            params = {"dec": {}}
            batch_stats = {}

    monkeypatch.setattr(fit_perceptual_head, "get_trainer",
                        lambda *a, **kw: PortStub())
    import superresolution_aniso_mri_tpu.train as jtrain
    monkeypatch.setattr(jtrain, "get_trainer", lambda *a, **kw: JaxStub())
    for harvest, args in ((fit_perceptual_head.harvest_encoder,
                           ("x", "caisr", "cpu")),
                          (jfit.harvest_encoder, ("x", "caisr"))):
        with pytest.raises(SystemExit, match="has no 'enc' subtree"):
            harvest(*args)


def test_fit_lins_matches_jax(jax_exper):
    """The same fit set, the same uniform start: the fitted w within
    1e-4 relative after 50 iterations (2.6e-6 measured), the same pairs
    and rank accuracy."""
    from superresolution_aniso_mri_tpu_torch.ops.perceptual import (
        enc_perceptual_params, uniform_lins)

    _, model, params, stats = jax_exper
    data_p = fit_perceptual_head.build_fit_set(N_SLICES, SIZE, device="cpu")
    with jax.default_matmul_precision("highest"):
        data_j = jfit.build_fit_set(N_SLICES, SIZE)
        for a, b in zip(data_j, data_p):
            np.testing.assert_array_equal(a[1], b[1])
            assert _rel(b[2], a[2]) <= 1e-5
            np.testing.assert_array_equal(a[3], b[3])
        lins = uniform_lins(model.config)
        w_j, diag_j = jfit.fit_lins(
            _jax_enc_params(model, params, stats, lins), data_j,
            iters=FIT_ITERS)
    from superresolution_aniso_mri_tpu_torch.models import AEConfig
    from superresolution_aniso_mri_tpu_torch.ops.perceptual import _CFG_KEYS

    cfg = AEConfig(**{k: getattr(model.config, k) for k in _CFG_KEYS})
    port = enc_perceptual_params(
        cfg, {"params": params["enc"], "batch_stats": stats["enc"]},
        lins, device="cpu")
    w_p, diag_p = fit_perceptual_head.fit_lins(port, data_p, iters=FIT_ITERS)
    assert w_p.dtype == np.float32 and w_p.shape == w_j.shape
    assert _rel(w_p, w_j) <= 1e-4
    assert diag_p["pairs"] == diag_j["pairs"]
    assert diag_p["rank_accuracy"] == diag_j["rank_accuracy"]
    assert abs(diag_p["final_loss"] - diag_j["final_loss"]) <= 1e-5


def test_artifact_matches_jax_and_loads_in_both(jax_exper, monkeypatch):
    """The port's command and JAX's tool on the same experiment write the
    same artifact (lins within 1e-4 relative, the rest equal); each
    loads in the other package."""
    from superresolution_aniso_mri_tpu.ops import perceptual as jp
    from superresolution_aniso_mri_tpu_torch.ops import perceptual as tp

    exper, model, params, stats = jax_exper
    out = os.path.dirname(exper)
    argv = ["--exper_dir", exper, "--n_slices", str(N_SLICES), "--size",
            str(SIZE), "--iters", str(FIT_ITERS)]
    # JAX's harvest builds a flax Trainer (an eager init); the tree is
    # the one the checkpoint holds
    monkeypatch.setattr(jfit, "harvest_encoder", lambda d, m: (
        model.config, {"params": params["enc"], "batch_stats": stats["enc"]},
        "ae_combined"))
    monkeypatch.setattr(sys, "argv", ["fit_perceptual_head.py"] + argv
                        + ["--out", os.path.join(out, "jax.npz")])
    with jax.default_matmul_precision("highest"):
        jfit.main()
    meta, lins = fit_perceptual_head.main(
        argv + ["--out", os.path.join(out, "port.npz"), "--device", "cpu"])
    with np.load(os.path.join(out, "jax.npz")) as a, \
            np.load(os.path.join(out, "port.npz")) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            if k.startswith("lin_"):
                assert _rel(b[k], a[k]) <= 1e-4, k
            elif k != "meta_json":
                np.testing.assert_array_equal(b[k], a[k])
        meta_j = json.loads(bytes(a["meta_json"]).decode())
    fit_j, fit_p = meta_j.pop("fit"), dict(meta["fit"])
    assert {k: v for k, v in meta.items() if k != "fit"} == meta_j
    assert fit_p.pop("pairs") == fit_j.pop("pairs")
    assert fit_p.pop("mode") == fit_j.pop("mode") == "fitted"
    assert fit_p.pop("rank_accuracy") == fit_j.pop("rank_accuracy")
    for k in fit_j:
        assert abs(fit_p[k] - fit_j[k]) <= 1e-4 * abs(fit_j[k]), k

    from_port = jp.load_enc_perceptual(os.path.join(out, "port.npz"))
    from_jax = tp.load_enc_perceptual(os.path.join(out, "jax.npz"), "cpu")
    assert from_port["meta"] == meta
    for a, b in zip(from_port["lins"], lins):
        np.testing.assert_array_equal(np.asarray(a), b)
    rng = np.random.RandomState(1)
    x, y = (rng.rand(2, SIZE, SIZE, 1).astype(np.float32) for _ in range(2))
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jp.enc_lpips_distance(from_port, x, y))
    got = tp.enc_lpips_distance(
        tp.load_enc_perceptual(os.path.join(out, "port.npz"), "cpu"),
        torch.from_numpy(x).permute(0, 3, 1, 2),
        torch.from_numpy(y).permute(0, 3, 1, 2))
    assert _rel(got.numpy(), want) <= 1e-5
    with np.load(os.path.join(out, "jax.npz")) as a:
        for i, lw in enumerate(from_jax["lins"]):
            np.testing.assert_array_equal(lw.numpy(), a[f"lin_{i}"])


# ---------------------------------------------------------------------------
# convert_lpips_weights
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def torch_weights(tmp_path_factory):
    """A torchvision-shaped VGG16 state dict and LPIPS lin state dict,
    seeded, saved with torch.save."""
    from superresolution_aniso_mri_tpu_torch.ops.lpips import (_VGG_PLAN,
                                                               LPIPS_CHANNELS)

    rng = np.random.RandomState(0)
    sd, cin = {}, 3
    for idx, (cout, _) in zip(convert_lpips_weights._VGG16_CONV_IDX,
                              _VGG_PLAN):
        sd[f"features.{idx}.weight"] = torch.from_numpy(
            rng.randn(cout, cin, 3, 3).astype(np.float32) * 0.05)
        sd[f"features.{idx}.bias"] = torch.from_numpy(
            rng.randn(cout).astype(np.float32) * 0.01)
        cin = cout
    sd["classifier.0.weight"] = torch.zeros(4, 4)
    lin = {f"lin{k}.model.1.weight": torch.from_numpy(
        np.abs(rng.randn(1, c, 1, 1)).astype(np.float32) / c)
        for k, c in enumerate(LPIPS_CHANNELS)}
    d = tmp_path_factory.mktemp("lpips_w")
    torch.save(sd, str(d / "vgg16.pth"))
    torch.save({"state_dict": sd}, str(d / "vgg16_wrapped.pth"))
    torch.save(lin, str(d / "lin.pth"))
    return d


@pytest.mark.parametrize("vgg", ["vgg16.pth", "vgg16_wrapped.pth", None])
def test_convert_matches_jax_bit_for_bit(torch_weights, tmp_path, vgg):
    d = torch_weights
    vgg_path = str(d / vgg) if vgg else None
    jconvert.convert(vgg_path, str(d / "lin.pth"), str(tmp_path / "j.npz"))
    convert_lpips_weights.main(
        (["--vgg16", vgg_path] if vgg else [])
        + ["--lin", str(d / "lin.pth"), "--out", str(tmp_path / "p.npz")])
    with np.load(tmp_path / "j.npz") as a, np.load(tmp_path / "p.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        assert len(a.files) == (31 if vgg else 5)
        for k in a.files:
            assert b[k].dtype == a[k].dtype
            np.testing.assert_array_equal(b[k], a[k])


def test_converted_weights_load_in_both_packages(torch_weights, tmp_path):
    """The converted npz resolves as true LPIPS in both packages, and
    the port's distance with it equals the distance with the same
    arrays passed directly."""
    from superresolution_aniso_mri_tpu.ops import lpips as jl
    from superresolution_aniso_mri_tpu_torch.ops import lpips as tl

    d = torch_weights
    out = str(tmp_path / "lpips_vgg.npz")
    convert_lpips_weights.convert(str(d / "vgg16.pth"), str(d / "lin.pth"),
                                  out)
    jparams = jl.load_lpips_params(out)
    tparams = tl.load_lpips_params(out)
    for a, b in zip(jax.tree_util.tree_leaves(jparams),
                    jax.tree_util.tree_leaves(tparams)):
        np.testing.assert_array_equal(np.asarray(a), b)
    resolved = tl.get_lpips_params(out, device="cpu")
    assert tl.lpips_weights_info()["mode"] == "converted"
    sd = torch.load(str(d / "vgg16.pth"), weights_only=True)
    lin = torch.load(str(d / "lin.pth"), weights_only=True)
    direct = tl._device({
        "convs": [{"kernel": sd[f"features.{i}.weight"].numpy().transpose(
            2, 3, 1, 0), "bias": sd[f"features.{i}.bias"].numpy()}
            for i in convert_lpips_weights._VGG16_CONV_IDX],
        "lins": [{"kernel": lin[f"lin{k}.model.1.weight"].numpy().transpose(
            2, 3, 1, 0)} for k in range(5)]}, "cpu")
    rng = np.random.RandomState(2)
    x, y = (torch.from_numpy(rng.rand(2, 1, SIZE, SIZE).astype(np.float32))
            for _ in range(2))
    assert torch.equal(tl.lpips_distance(resolved, x, y),
                       tl.lpips_distance(direct, x, y))


def test_convert_refuses_vgg_without_lin_like_jax(torch_weights, tmp_path):
    d = str(torch_weights / "vgg16.pth")
    for convert in (jconvert.convert, convert_lpips_weights.convert):
        with pytest.raises(SystemExit, match="without --lin"):
            convert(d, None, str(tmp_path / "x.npz"))
    assert not os.path.exists(tmp_path / "x.npz")
    with pytest.raises(SystemExit):
        convert_lpips_weights.main(["--out", str(tmp_path / "y.npz")])
    # a lin-only npz without any input: the uniform placeholders
    jconvert.convert(None, None, str(tmp_path / "j.npz"))
    convert_lpips_weights.convert(None, None, str(tmp_path / "p.npz"))
    with np.load(tmp_path / "j.npz") as a, np.load(tmp_path / "p.npz") as b:
        for k in a.files:
            np.testing.assert_array_equal(b[k], a[k])


# ---------------------------------------------------------------------------
# the commands, with jax blocked
# ---------------------------------------------------------------------------

def test_commands_run_without_jax(jax_exper, torch_weights, tmp_path):
    """The three subcommands through ``cli.__main__.main`` in a process
    where jax cannot be imported; nothing of the JAX package is loaded."""
    exper = jax_exper[0]
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "from superresolution_aniso_mri_tpu_torch.cli.__main__ import main\n"
        f"assert main(['convert-lpips-weights', '--lin', "
        f"{str(torch_weights / 'lin.pth')!r}, '--out', "
        f"{str(tmp_path / 'lin.npz')!r}]) == 0\n"
        f"assert main(['fit-perceptual-head', '--exper_dir', {exper!r}, "
        f"'--n_slices', '1', '--size', '32', '--iters', '3', '--out', "
        f"{str(tmp_path / 'enc.npz')!r}, '--device', 'cpu']) == 0\n"
        f"assert main(['lpips-gap-study', '--n_slices', '1', '--size', "
        f"'32', '--enc_npz', {str(tmp_path / 'enc.npz')!r}, '--json_out', "
        f"{str(tmp_path / 'gap.json')!r}, '--device', 'cpu']) == 0\n"
        "bad = [m for m in sys.modules if m == "
        "'superresolution_aniso_mri_tpu' or m.startswith("
        "'superresolution_aniso_mri_tpu.')]\n"
        "assert not bad, bad\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=240,
                       env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert r.returncode == 0, r.stderr[-3000:]
    assert "rank accuracy" in r.stdout and "enc_vs_msssim" in r.stdout
    with open(tmp_path / "gap.json") as f:
        gap = json.load(f)
    assert gap["enc_meta"]["n_slices"] == 1
