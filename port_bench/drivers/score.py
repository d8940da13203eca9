"""Checkpoint scoring traffic (find-best's ``--batched`` sweep): one
request scores one checkpoint over the validation volumes through
``evaluate/sweep.py::evaluate_prepared`` (one batched synthesis and one
SSIM launch a chunk, per-slice SSIM, PSNR and VIF on the device), the
stacks prepared once in set-up by ``prepare_sweep_batches``. Before each
request the next of ``weight_sets`` seeded weight sets, held on the
device, is loaded into the model, as the sweep moves from one epoch's
checkpoint to the next.

Every request's per-slice stacks (the sweep evaluator's outputs) and
per-volume means are kept; the reference scores each weight set once,
and every request is compared with its weight set's scores.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np
import torch
from torch.profiler import record_function

from .. import data, weights
from ..counts.flops import ssim_counts, synthesis_flops
from ..counts.peaks import F32_FLOPS, HBM_BYTES_PER_S
from ..harness import Stopwatch
from ..reference import compare, metrics
from ..reference.model import Arch, Net
from ..reference.precision import precision
from ..reference.synth import synthesize
from ..seeds import sub_seeds
from .train import _sync

FAULTS = ("half_batch", "altered_answer")
PER_SLICE = ("ssim", "psnr", "vif", "sq")


class Job:
    kind = "score"

    def __init__(self, cell, seed: int, device):
        from superresolution_aniso_mri_tpu_torch.data import Volume
        from superresolution_aniso_mri_tpu_torch.evaluate.sweep import (
            evaluate_prepared, prepare_sweep_batches)
        from superresolution_aniso_mri_tpu_torch.ops import cuda_kernels
        from superresolution_aniso_mri_tpu_torch.train import Trainer

        self.cell, self.device = cell, torch.device(device)
        watch = Stopwatch(self.device)
        cfg, tr = cell.config, cell.traffic
        self.seeds = sub_seeds(seed)
        self.arch = Arch.from_config(cfg["model"])
        ds = cfg["dataset"]
        self.ds = int(cfg["recipe"]["downsample_steps"])
        self.interp = str(tr["latent_interp"])
        self.n_sets = int(tr["weight_sets"])
        self.hr = data.volumes(self.seeds["volumes"],
                               int(tr["volumes_per_request"]),
                               int(ds["slices"]), int(ds["inplane"]),
                               int(ds["inplane"]), self.device)
        watch.lap("volumes")
        self.sets = [weights.weight_set(self.arch, self.seeds["weights"] + k,
                                        self.device, trained=True)
                     for k in range(self.n_sets)]
        args = {**cfg["recipe"], **cfg["model"], "seed": self.seeds["program"],
                "output_dir": None}
        self.trainer = Trainer(args, eval_mode=True, device=self.device)
        self.model = self.trainer._ae_model()
        watch.lap("program")
        spacing = np.asarray(ds["spacing"], np.float64)
        self.prep = prepare_sweep_batches(
            self.trainer, [Volume(image=v, spacing=spacing, patient_id=f"v{i}")
                           for i, v in enumerate(self.hr)], self.ds)
        self.chunk_meta = [c["meta"] for c in self.prep["chunks"]]
        watch.lap("prepare")
        self._evaluate = evaluate_prepared
        self._launches = cuda_kernels.LAUNCHES
        for k in range(min(2, self.n_sets)):
            self._request(k)
        # the sweep evaluators are built now: record what they return
        self.captured: List = []
        for key, fn in list(self.trainer.synth_cache.items()):
            if key[0] == "sweep":
                self.trainer.synth_cache[key] = self._recording(fn)
        self.requests: List = []
        watch.lap("warm_requests")
        self.setup_parts = watch.parts

    def _recording(self, fn):
        def evaluate(*args, **kwargs):
            out = fn(*args, **kwargs)
            if self.captured:
                self.captured[-1].append(out)
            return out
        return evaluate

    def _request(self, k: int):
        self.model.load_state_dict(self.sets[k])
        return self._evaluate(self.trainer, self.prep, self.interp)

    def window(self, seconds: float) -> Dict:
        n = 0
        launches0 = self._launches["ssim_slice"]
        _sync(self.device)
        t0 = time.perf_counter()
        with record_function("port_bench.window"):
            while time.perf_counter() - t0 < seconds:
                k = len(self.requests) % self.n_sets
                with record_function("port_bench.request"):
                    self.captured.append([])
                    res = self._request(k)
                self.requests.append((k, self.captured[-1], res))
                n += 1
            _sync(self.device)
        window_s = time.perf_counter() - t0
        vols = n * len(self.hr)
        return {"window_s": window_s, "attempted": n,
                "end_to_end": {"score_volumes_per_s": vols / window_s},
                "counters": {"requests": n, "volumes": vols,
                             "ssim_launches":
                                 self._launches["ssim_slice"] - launches0},
                "spans": {}}

    def work_counts(self) -> Dict[str, float]:
        """FLOPs of one scored volume (useful work: the kept slices
        encoded and decoded, the in-between slices decoded) and the least
        time of one request's SSIM: the slices that the function scores
        (every slice of the synthesized volume that the reference volume
        has), from the volumes' shapes, whatever the program pads them
        to."""
        s, h, w = self.hr[0].shape
        kept = (s - 1) // self.ds + 1  # the kept grid, the tail stripped
        scored = sum(min((kept - 1) * self.ds + 1, v.shape[0])
                     for v in self.hr)
        flops, nbytes = ssim_counts(scored, h, w)
        return {"flops_per_volume": synthesis_flops(
                    self.arch, kept, self.ds - 1, h, w, False),
                "ssim_least_s_per_request": max(flops / F32_FLOPS,
                                                nbytes / HBM_BYTES_PER_S)}

    def release(self) -> None:
        self.trainer = self.model = self.prep = None

    # ------------------------------------------------------------------

    def program_outputs(self) -> Dict:
        """Per request: its weight set and, per volume, the per-slice
        stacks of the valid slices and the per-volume means."""
        out = []
        for k, chunks, res in self.requests:
            per = {}
            for c_meta, st in zip(self.chunk_meta, chunks):
                for row, (pid, n_valid) in enumerate(c_meta):
                    per[pid] = {key: st[key][row, :n_valid]
                                for key in PER_SLICE}
                    per[pid]["means"] = res[pid]
            out.append((k, per))
        return {"requests": out}

    @staticmethod
    def as_program(ref: Dict) -> Dict:
        """Reference outputs in the program's place (a control or a
        fault): one request of each weight set."""
        return {"requests": list(ref["sets"].items())}

    def _ref_set(self, k: int, mode: str) -> Dict[str, Dict]:
        net = Net(self.arch, self.sets[k], mode)
        alphas = np.linspace(0, 1, self.ds + 1)[1:-1]
        out = {}
        with precision(mode):
            for i, v in enumerate(self.hr):
                hr = torch.from_numpy(v).to(self.device)
                remain = (hr.shape[0] - 1) % self.ds
                kept = hr[:hr.shape[0] - remain][::self.ds][:, None]
                vol = synthesize(net, kept, alphas, self.interp, False)
                n = min(vol.shape[0], hr.shape[0])
                r, u = hr[:n], vol[:n]
                out[f"v{i}"] = {"ssim": metrics.ssim(r, u),
                                "psnr": metrics.psnr(r, u),
                                "vif": metrics.vif(r, u),
                                "sq": metrics.mse(r, u)}
        for pid, d in out.items():
            d["means"] = _means(d, self.ds)
        return out

    def reference_outputs(self, mode: str = "float32",
                          fault: Optional[str] = None) -> Dict:
        """The reference's scores of each weight set; with ``fault`` a
        broken program in the program's place (one request a set):
        ``half_batch`` averages each volume's means over its first half
        of slices, ``altered_answer`` changes one slice's scores."""
        sets = {k: self._ref_set(k, mode) for k in
                sorted({k for k, _, _ in self.requests} or {0})}
        if fault == "half_batch":
            for d in sets.values():
                for v in d.values():
                    half = {key: v[key][:v[key].shape[0] // 2]
                            for key in PER_SLICE}
                    v["means"] = _means(half, self.ds)
        elif fault == "altered_answer":
            for d in sets.values():
                v = d["v0"]
                for key in PER_SLICE:
                    v[key] = v[key].clone()
                    v[key][1] = v[key][1] * 1.01
        elif fault is not None:
            raise ValueError(f"unknown fault {fault!r}")
        return {"sets": sets}

    def compare(self, prog: Dict, ref: Dict):
        """Per request, the largest gap of each per-slice score (SSIM,
        PSNR in dB, VIF; the MSE relative) and of the per-volume means of
        the same kind."""
        answers = []
        for k, per in prog["requests"]:
            want = ref["sets"][k]
            a = {f"{key}_gap": 0.0 for key in ("ssim", "psnr", "vif", "mse")}
            if set(per) != set(want):
                a = {name: float("inf") for name in a}
            for pid in want:
                if pid not in per:
                    continue
                p, r = per[pid], want[pid]
                for key in ("ssim", "psnr", "vif"):
                    a[f"{key}_gap"] = max(
                        a[f"{key}_gap"], compare.abs_gap(p[key], r[key]),
                        *(abs(p["means"][m] - r["means"][m])
                          for m in (key, key + "_synth")))
                sq_gap = compare.abs_gap(p["sq"] / r["sq"].to(p["sq"].device),
                                         torch.ones_like(r["sq"]))
                a["mse_gap"] = max(a["mse_gap"], sq_gap, abs(
                    p["means"]["mse"] / r["means"]["mse"] - 1.0))
            answers.append(a)
        numbers = {name: max(a[name] for a in answers) for name in answers[0]}
        return numbers, answers


def _means(d: Dict[str, torch.Tensor], ds: int) -> Dict[str, float]:
    """The per-volume means of the valid slices, and of the synthesized
    ones (every slice but each ``ds``-th), over finite values."""
    n = d["ssim"].shape[0]
    synth = torch.tensor([j % ds != 0 for j in range(n)])
    out = {}
    for key in ("ssim", "psnr", "vif"):
        v = d[key].double().cpu()
        fin = torch.isfinite(v)
        out[key] = float(v[fin].mean())
        out[key + "_synth"] = float(v[fin & synth].mean())
    out["mse"] = float(d["sq"].double().cpu().mean())
    return out
