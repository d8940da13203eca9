"""Training traffic: ``Trainer.train_many`` over batches of the recipe's
pairs, drawn by ``DeviceCachedSampler.sample_batch`` from seeded volumes
and augmented on the device by ``data.device_batch``, ``steps_per_dispatch``
batches a dispatch (the step captured in a CUDA graph and replayed).

Set-up drives the one trainer through its first ``check_steps`` steps
one batch a dispatch (three eager steps, then the capture and graph
replays), keeping the batches, losses, the first gradient (from Adam's
first moment after step 1) and the parameters after steps 3 and
``check_steps``; then one full dispatch warms the window's call. The
reference follows the same steps from the same weights on batches it
draws itself from the same seeds.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np
import torch
from torch.profiler import record_function

from .. import data, weights
from ..counts.flops import train_step_flops
from ..harness import Stopwatch
from ..reference import compare
from ..reference.model import Arch
from ..reference.precision import precision
from ..reference.train import Augment, Sampler, follow, make_batch
from ..seeds import sub_seeds

BATCH_KEYS = ("image", "slice_between", "alpha_from", "alpha_to",
              "is_inbetween")
FAULTS = ("half_batch", "altered_batch")
# what the reference follows, per recipe key (the first value stands for
# a key the recipe leaves out): a configuration that asks for anything
# else is refused, not fed to the program and judged by another recipe
FOLLOWS = {"model": ("ae_combined",), "ae_class": ("VanillaACAI",),
           "image_mix_loss_func": ("mse",),
           "slice_selection": ("adjacent_plus",),
           "train_latent_interp": ("linear",),
           "compute_dtype": ("float32",)}
# slices a training item carries, by the latent mix it trains
LATENT_TAPS = {"linear": 2}


def check_recipe(recipe: Dict) -> None:
    """Raise where ``recipe`` asks for what the reference does not
    follow (``FOLLOWS``)."""
    for key, values in FOLLOWS.items():
        got = recipe.get(key) or values[0]
        if got not in values:
            raise ValueError(f"the reference follows {key} in {values}; "
                             f"the configuration asks for {got!r}")


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class Job:
    kind = "train"

    def __init__(self, cell, seed: int, device):
        from superresolution_aniso_mri_tpu_torch.cli.train_loop import \
            build_augment_config
        from superresolution_aniso_mri_tpu_torch.data import (TripletSampler,
                                                               Volume,
                                                               device_batch)
        from superresolution_aniso_mri_tpu_torch.data.device_cache import \
            DeviceCachedSampler
        from superresolution_aniso_mri_tpu_torch.train import Trainer

        self.cell, self.device = cell, torch.device(device)
        watch = Stopwatch(self.device)
        cfg, tr = cell.config, cell.traffic
        self.seeds = sub_seeds(seed)
        self.arch = Arch.from_config(cfg["model"])
        self.recipe = dict(cfg["recipe"])
        check_recipe(self.recipe)
        self.taps = LATENT_TAPS[self.recipe.get("train_latent_interp")
                                or "linear"]
        ds = cfg["dataset"]
        self.batch = int(self.recipe["batch_size"])
        self.spd = int(tr["steps_per_dispatch"])
        self.check_steps = int(tr["check_steps"])
        self.volumes = data.volumes(self.seeds["volumes"],
                                    int(ds["train_patients"]),
                                    int(ds["slices"]), int(ds["inplane"]),
                                    int(ds["inplane"]), self.device)
        watch.lap("volumes")
        args = {**self.recipe, **cfg["model"], "seed": self.seeds["program"],
                "output_dir": None,
                "steps_per_dispatch": self.spd}
        self.trainer = Trainer(args, device=self.device)
        self.init = weights.weight_set(self.arch, self.seeds["weights"],
                                       self.device, trained=False)
        self.trainer.model.load_state_dict(self.init)
        pad = int(self.recipe.get("aug_patch_size") or cfg["model"]["width"])
        sampler = TripletSampler(
            [Volume(image=v, spacing=np.asarray(ds["spacing"], np.float64))
             for v in self.volumes], int(self.recipe["downsample_steps"]),
            self.recipe.get("slice_selection") or "adjacent_plus",
            pad_size=pad, seed=self.seeds["sampler"], latent_taps=self.taps)
        watch.lap("program")
        self.sampler = DeviceCachedSampler(sampler, self.device)
        watch.lap("cache_fill")
        self.aug = build_augment_config(args)
        self.gen = torch.Generator().manual_seed(self.seeds["augment"])
        self.sample_s: List[float] = []
        self._device_batch = device_batch

        state = self.trainer.state
        self.fed, self.losses, self.snap = [], [], {}
        for step in range(1, self.check_steps + 1):
            if step == 4:
                watch.lap("eager_steps")
            b = self.feed()
            self.fed.append({k: b[k].detach().clone() for k in BATCH_KEYS})
            self.losses.append(self.trainer.train_many([b])["loss_ae"][0])
            if step == 1:
                self.grad1 = {k: v.detach() / (1.0 - state.tx.b1)
                              for k, v in state.opt_state.mu.items()}
            if step in (3, self.check_steps):
                self.snap[step] = {k: p.detach().clone()
                                   for k, p in state.params().items()}
        watch.lap("capture_steps")
        self.trainer.train_many([self.feed() for _ in range(self.spd)])
        watch.lap("warm_dispatch")
        self.setup_parts = watch.parts

    def feed(self) -> Dict[str, torch.Tensor]:
        t0 = time.perf_counter()
        with record_function("port_bench.sample"):
            raw = self.sampler.sample_batch(self.batch)
            out = self._device_batch(raw, self.aug, self.device, self.taps,
                                     generator=self.gen)
        self.sample_s.append(time.perf_counter() - t0)
        return out

    def window(self, seconds: float) -> Dict:
        steps = 0
        self.sample_s = []
        _sync(self.device)
        t0 = time.perf_counter()
        with record_function("port_bench.window"):
            while time.perf_counter() - t0 < seconds:
                with record_function("port_bench.dispatch"):
                    self.trainer.train_many(
                        [self.feed() for _ in range(self.spd)])
                steps += self.spd
            _sync(self.device)
        window_s = time.perf_counter() - t0
        return {"window_s": window_s, "attempted": steps,
                "end_to_end": {
                    "train_pairs_per_s": steps * self.batch / window_s},
                "counters": {"steps": steps, "batch": self.batch},
                "spans": {"sample": list(self.sample_s)}}

    def work_counts(self) -> Dict[str, float]:
        """The frozen FLOPs of one step (``counts.flops``)."""
        return {"flops_per_step": train_step_flops(
            self.arch, self.batch, int(self.cell.config["model"]["width"]),
            bool(self.recipe.get("use_laploss")))}

    def release(self) -> None:
        self.trainer = self.sampler = None

    # ------------------------------------------------------------------
    # the two sides of the comparison
    # ------------------------------------------------------------------

    def program_outputs(self) -> Dict:
        return {"batches": self.fed, "loss": [float(v) for v in self.losses],
                "grad1": self.grad1, "params": self.snap}

    @staticmethod
    def as_program(ref: Dict) -> Dict:
        """Reference outputs in the program's place (a control or a
        fault)."""
        return ref

    def _ref_batches(self) -> List[Dict[str, torch.Tensor]]:
        sampler = Sampler(self.volumes, int(self.recipe["downsample_steps"]),
                          self.seeds["sampler"])
        aug = Augment(**self.cell.config["augment"])
        g = torch.Generator().manual_seed(self.seeds["augment"])
        return [make_batch(sampler, aug, g, self.batch, self.device)
                for _ in range(self.check_steps)]

    def reference_outputs(self, mode: str = "float32",
                          fault: Optional[str] = None) -> Dict:
        """The reference's outputs; with ``fault`` (``FAULTS``) a broken
        program put in the program's place: ``half_batch`` trains on the
        first half of each batch's pairs alone, ``altered_batch`` hands
        the step a batch with one slice changed."""
        batches = self._ref_batches()
        fed = batches
        if fault == "half_batch":
            h = self.batch // 2
            fed = [{"image": torch.cat([b["image"][:h],
                                        b["image"][self.batch:self.batch + h]]),
                    **{k: b[k][:h] for k in BATCH_KEYS if k != "image"}}
                   for b in batches]
        elif fault == "altered_batch":
            fed = [{**b, "slice_between": b["slice_between"].clone()}
                   for b in batches]
            for b in fed:
                b["slice_between"][0] = 1.0 - b["slice_between"][0]
            batches = fed
        elif fault is not None:
            raise ValueError(f"unknown fault {fault!r}")
        with precision(mode):
            out = follow(self.arch, self.init, fed, float(self.recipe["lr"]),
                         float(self.recipe.get("momentum", 0.9)),
                         float(self.recipe["ex_loss_weight1"]),
                         bool(self.recipe.get("use_laploss")), mode,
                         snapshots=(3, self.check_steps))
        out["batches"] = batches
        return out

    def readings(self, prog: Dict, ref: Dict) -> Dict[str, float]:
        """Every number the comparison reads: the worst batch value's gap,
        the worst step's relative loss gap, the worst leaf's gap of the
        first gradient's norm, and of the parameters' change after step 3
        and after the last checked step (the graph-replayed steps) both
        the worst leaf's gap (``delta<n>_worst_gap``) and the median
        leaf's (``delta<n>_gap``)."""
        batch_gap = max(compare.abs_gap(p[k], r[k])
                        for p, r in zip(prog["batches"], ref["batches"])
                        for k in BATCH_KEYS)
        moving = compare.moving(ref["grad1"])
        out = {"batch_gap": batch_gap,
               "loss_gap": compare.rel_gap(prog["loss"], ref["loss"]),
               "grad1_gap": compare.leaf_norm_gap(prog["grad1"],
                                                  ref["grad1"])}
        for step in (3, self.check_steps):
            change = [{k: (side["params"][step][k] - self.init[k])[m]
                       for k, m in moving.items()} for side in (prog, ref)]
            out[f"delta{step}_gap"] = compare.median_leaf_norm_gap(*change)
            out[f"delta{step}_worst_gap"] = compare.leaf_norm_gap(*change)
        return out

    def compare(self, prog: Dict, ref: Dict):
        """(numbers, answers): the readings (``readings``) but the worst
        leaf's change, whose one small leaf swings from seed to seed
        (Adam's normalisation magnifies the round-off of an entry whose
        gradient passes near zero in a later step)."""
        numbers = {k: v for k, v in self.readings(prog, ref).items()
                   if "_worst_" not in k}
        return numbers, [numbers]
