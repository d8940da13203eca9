"""Serving traffic (``generate-hr-volumes``' synthesis): a closed loop of
one client; each request is ``volumes_per_request`` same-shaped thick-
slice volumes of ``lr_slices`` slices through
``infer.create_super_volumes`` (one batched encode, the latent mix,
decode and interleave; the kept slices returned as given), read back to
the host as float32 numpy. Latency runs from the call until the result
is in host memory.

Requests cycle through a pool of seeded volumes. A sample of requests,
drawn from the seed before the window, and the last one keep their
returned volumes; the reference synthesizes each pooled volume once and
every kept volume is compared with it.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np
import torch
from torch.profiler import record_function

from .. import data, weights
from ..counts.flops import synthesis_flops
from ..harness import Stopwatch
from ..reference import compare
from ..reference.model import Arch, Net
from ..reference.precision import precision
from ..reference.synth import synthesize
from ..seeds import sub_seeds
from .train import _sync

FAULTS = ("half_batch", "altered_answer")


class Job:
    kind = "serve"

    def __init__(self, cell, seed: int, device):
        from superresolution_aniso_mri_tpu_torch.infer import (
            ServingModel, create_super_volumes)
        from superresolution_aniso_mri_tpu_torch.models import AEConfig

        self.cell, self.device = cell, torch.device(device)
        watch = Stopwatch(self.device)
        cfg, tr = cell.config, cell.traffic
        self.seeds = sub_seeds(seed)
        self.arch = Arch.from_config(cfg["model"])
        self.per_request = int(tr["volumes_per_request"])
        self.ds = int(tr["downsample_steps"])
        self.alphas = np.linspace(0, 1, self.ds + 1)[1:-1]
        self.interp = str(tr["latent_interp"])
        self.use_original = bool(tr["use_original"])
        size = int(cfg["dataset"]["inplane"])
        self.pool = data.volumes(self.seeds["volumes"],
                                 int(tr["pool_volumes"]), int(tr["lr_slices"]),
                                 size, size, self.device)
        watch.lap("volumes")
        self.weights = weights.weight_set(self.arch, self.seeds["weights"],
                                          self.device, trained=True)
        model_cfg = AEConfig(**cfg["model"], compute_dtype=str(
            cfg["recipe"].get("compute_dtype", "float32")))
        self.model = ServingModel(model_cfg, state_dict=self.weights,
                                  device=self.device)
        watch.lap("program")
        self._serve = create_super_volumes
        rng = np.random.RandomState(self.seeds["sample"])
        self.sampled = set(rng.choice(int(tr["sample_range"]),
                                      int(tr["checked_requests"]),
                                      replace=False).tolist())
        for i in range(2):
            self._request(i)
        self.kept: Dict[int, List[np.ndarray]] = {}
        self.latency: List[float] = []
        watch.lap("warm_requests")
        self.setup_parts = watch.parts

    def _volumes(self, i: int) -> List[int]:
        return [(i * self.per_request + j) % len(self.pool)
                for j in range(self.per_request)]

    def _request(self, i: int):
        res = self._serve(self.model, [self.pool[j] for j in self._volumes(i)],
                          alpha_range=self.alphas,
                          use_original=self.use_original,
                          downsample_steps=None,
                          generate_inbetween_slices=False,
                          latent_interp=self.interp)
        return [r["upsampled_image"] for r in res]

    def window(self, seconds: float) -> Dict:
        self.latency, self.kept, last = [], {}, None
        _sync(self.device)
        t0 = time.perf_counter()
        with record_function("port_bench.window"):
            while time.perf_counter() - t0 < seconds:
                i = len(self.latency)
                t = time.perf_counter()
                with record_function("port_bench.request"):
                    out = self._request(i)
                self.latency.append(time.perf_counter() - t)
                if i in self.sampled:
                    self.kept[i] = out
                last = (i, out)
        window_s = time.perf_counter() - t0
        if last is not None:
            self.kept[last[0]] = last[1]
        n = len(self.latency)
        vols = n * self.per_request
        return {"window_s": window_s, "attempted": n,
                "end_to_end": {"serve_volumes_per_s": vols / window_s},
                "counters": {"requests": n, "volumes": vols},
                "spans": {"request": list(self.latency)}}

    def work_counts(self) -> Dict[str, float]:
        """FLOPs of one served volume: the kept slices encoded, the
        in-between slices decoded (the kept ones too unless they are
        returned as given)."""
        k, h, w = self.pool[0].shape
        return {"flops_per_volume": synthesis_flops(
            self.arch, k, len(self.alphas), h, w, self.use_original)}

    def release(self) -> None:
        self.model = None

    # ------------------------------------------------------------------

    def program_outputs(self) -> Dict:
        return {"requests": {i: dict(zip(self._volumes(i), out))
                             for i, out in self.kept.items()}}

    def as_program(self, ref: Dict) -> Dict:
        """Reference outputs in the program's place (a control or a
        fault): one request of each pooled volume."""
        return {"requests": {j: {j: v} for j, v in ref["volumes"].items()}}

    def reference_outputs(self, mode: str = "float32",
                          fault: Optional[str] = None) -> Dict:
        """The reference's volume for each pooled volume that a kept
        request returned (all of them without requests); with ``fault``
        a broken program in the program's place: ``half_batch`` returns
        the first half of each request's volumes in place of the second
        (here: each volume's in-between slices from its first half of
        pairs repeated), ``altered_answer`` one volume with one slice
        changed."""
        used = sorted({j for i in self.kept for j in self._volumes(i)}
                      or range(len(self.pool)))
        net = Net(self.arch, self.weights, mode)
        out = {}
        with precision(mode):
            for j in used:
                lr = torch.from_numpy(self.pool[j]).to(self.device)[:, None]
                out[j] = synthesize(net, lr, self.alphas, self.interp,
                                    self.use_original).cpu().numpy()
        if fault == "half_batch":
            for j, v in out.items():
                v = v.copy()
                half = v.shape[0] // 2
                v[half:2 * half] = v[:half]
                out[j] = v
        elif fault == "altered_answer":
            j = used[0]
            out[j] = out[j].copy()
            out[j][1] = np.clip(out[j][1] + 0.01, 0.0, 1.0)
        elif fault is not None:
            raise ValueError(f"unknown fault {fault!r}")
        return {"volumes": out}

    def compare(self, prog: Dict, ref: Dict):
        """Per kept request, the largest absolute gap of a returned
        volume's voxels (inf for a volume of another shape)."""
        answers = []
        for i, vols in prog["requests"].items():
            gap = max(compare.abs_gap(torch.from_numpy(np.asarray(v)),
                                      torch.from_numpy(ref["volumes"][j]))
                      for j, v in vols.items())
            answers.append({"volume_gap": gap})
        if not answers:
            return {"volume_gap": float("inf")}, []
        return {"volume_gap": max(a["volume_gap"] for a in answers)}, answers
