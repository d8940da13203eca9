"""Training traffic of the β-VAE (``vae_combined``): ``Trainer.train_many``
over batches of the recipe's pairs, as ``drivers/train.py`` drives the
autoencoder cells (the device cache, the recipe's augmentation on the
card, ``steps_per_dispatch`` batches a dispatch, the step captured in a
CUDA graph and replayed), with that module's ``feed`` and ``window``.

Set-up drives the one trainer through its first ``check_steps`` steps
one batch a dispatch (three eager steps, then the capture and graph
replays). For each it keeps the batch, the loss and the step's
reparametrisation noise: the trainer's noise generator is saved before
the dispatch and drawn again from that state after it, so the noise is
the program's own draw and the reference takes it as an input. After
step 1 it keeps the float64 norm of each leaf's first gradient (from
Adam's first moment); after steps 3 and ``check_steps`` the parameters,
those of a leaf over ``HOST_BYTES`` (the heads) in host memory. One
full dispatch then warms the window's call.

The weights are drawn again from the seed where they are needed, so the
card holds no copy of them beside the program's. The reference runs
after the program is released, from the same weights, on batches it
draws itself from the same seeds; it and the comparison go leaf by leaf
and chunk by chunk (``CHUNK``), so the card's peak stays under the
program's. The compared numbers are the autoencoder cells' (the heads
are leaves like any other; every entry of every leaf is compared) and
``noise_gap``, which holds the program's draws to N(0, 1).
"""
from __future__ import annotations

import gc
import math
import resource
import sys
from typing import Dict, List, Optional

import numpy as np
import torch

from .. import data, weights
from ..counts import vae as counts
from ..harness import Stopwatch
from ..reference import compare
from ..reference.model import Arch
from ..reference.precision import precision
from ..reference.vae import HEADS, flat_size, follow
from ..seeds import sub_seeds
from . import train as ae

BATCH_KEYS = ae.BATCH_KEYS
FAULTS = ae.FAULTS + ("zero_noise",)
# what the reference follows, per recipe key, as drivers/train.py's
# FOLLOWS (the first value stands for a key the recipe leaves out)
FOLLOWS = {**ae.FOLLOWS, "model": ("vae_combined",), "ae_class": ("VAE",),
           "use_laploss": (False,), "use_extra_latent_loss": (False,),
           "max_grad_norm": (0.0,), "weight_decay": (0.0,)}
# a checked leaf larger than this is kept in host memory
HOST_BYTES = 256 << 20
# elements of one chunk of a norm taken on the card
CHUNK = 1 << 26


def check_recipe(recipe: Dict) -> None:
    """Raise where ``recipe`` asks for what the reference does not
    follow (``FOLLOWS``)."""
    for key, values in FOLLOWS.items():
        got = recipe.get(key) or values[0]
        if got not in values:
            raise ValueError(f"the reference follows {key} in {values}; "
                             f"the configuration asks for {got!r}")


def weight_set(arch: Arch, seed: int, device) -> Dict[str, torch.Tensor]:
    """A fresh set: the trunk as ``weights.weight_set`` draws it
    (``trained=False``); each head's kernel N(0, 1 / flat), flax's
    ``lecun_normal`` without its truncation, and its bias N(0, 0.01^2),
    drawn on the device from a generator of their own (seeded from
    ``seed`` by ``numpy.random.SeedSequence``), μ's head first."""
    out = weights.weight_set(arch, seed, device, trained=False)
    f = flat_size(arch)
    g = torch.Generator(device=device).manual_seed(
        int(np.random.SeedSequence([int(seed), 1]).generate_state(1)[0]))
    for head in HEADS:
        out[head + ".weight"] = torch.randn(
            f, f, generator=g, device=device).mul_(f ** -0.5)
        out[head + ".bias"] = 0.01 * torch.randn(f, generator=g,
                                                 device=device)
    return out


def keep(t: torch.Tensor) -> torch.Tensor:
    """A copy of ``t``: in host memory when it is over ``HOST_BYTES``."""
    t = t.detach()
    return t.cpu() if t.numel() * t.element_size() > HOST_BYTES else \
        t.clone()


def norm(t: torch.Tensor, device, div: float = 1.0,
         minus: Optional[torch.Tensor] = None,
         mask: Optional[torch.Tensor] = None) -> float:
    """The float64 norm of ``(t / div - minus)[mask]``, the element-wise
    work in float32 as ``reference.compare`` takes it, chunk by chunk on
    ``device``."""
    flat, total = t.reshape(-1), 0.0
    for s in range(0, flat.numel(), CHUNK):
        x = flat[s:s + CHUNK].to(device)
        if div != 1.0:
            x = x / div
        if minus is not None:
            x = x - minus.reshape(-1)[s:s + CHUNK].to(device)
        if mask is not None:
            x = x[mask.reshape(-1)[s:s + CHUNK].to(device)]
        total += float(torch.sum(x.double() ** 2))
    return math.sqrt(total)


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float],
              names: List[str]) -> List[float]:
    """``reference.compare.leaf_norm_gaps`` over leaves' norms."""
    if not names or any(k not in prog for k in names):
        return [float("inf")]
    med = float(torch.tensor([ref[k] for k in names]).median())
    return [abs(prog[k] - ref[k]) / max(ref[k], med) for k in names]


def moving(grad1: Dict[str, torch.Tensor], norms: Dict[str, float],
           share: float = 1e-3) -> Dict[str, torch.Tensor]:
    """``reference.compare.moving`` from the gradients and their
    norms."""
    rms = [norms[k] / grad1[k].numel() ** 0.5 for k in grad1]
    thr = share * float(torch.tensor(rms).median())
    masks = {k: g.abs() >= thr for k, g in grad1.items()}
    return {k: m for k, m in masks.items() if bool(m.any())}


def noise_gap(noise: List[torch.Tensor]) -> float:
    """The largest of |mean| and |std - 1| over each step's draws."""
    out = 0.0
    for e in noise:
        e = e.double()
        out = max(out, abs(float(e.mean())), abs(float(e.std()) - 1.0))
    return out


class Job(ae.Job):
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
        self.cuda = self.device.type == "cuda"
        # an earlier job's program (calibration sets up one seed after
        # another) leaves the card before this one's arrives
        gc.collect()
        if self.cuda:
            torch.cuda.empty_cache()
        watch = Stopwatch(self.device)
        cfg, tr = cell.config, cell.traffic
        self.seeds = sub_seeds(seed)
        self.arch = Arch.from_config(cfg["model"])
        self.flat = flat_size(self.arch)
        self.recipe = dict(cfg["recipe"])
        check_recipe(self.recipe)
        self.taps = ae.LATENT_TAPS["linear"]
        ds = cfg["dataset"]
        self.batch = int(self.recipe["batch_size"])
        self.spd = int(tr["steps_per_dispatch"])
        self.check_steps = int(tr["check_steps"])
        self._init_state = self._moving = None
        self.volumes = data.volumes(self.seeds["volumes"],
                                    int(ds["train_patients"]),
                                    int(ds["slices"]), int(ds["inplane"]),
                                    int(ds["inplane"]), self.device)
        watch.lap("volumes")
        args = {**self.recipe, **cfg["model"], "seed": self.seeds["program"],
                "output_dir": None, "steps_per_dispatch": self.spd}
        self.trainer = Trainer(args, device=self.device)
        self.trainer.model.load_state_dict(
            weight_set(self.arch, self.seeds["weights"], self.device))
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

        state, noise_gen = self.trainer.state, self.trainer.noise_generator
        self.fed, self.losses, self.noise, self.snap = [], [], [], {}
        for step in range(1, self.check_steps + 1):
            if step == 4:
                watch.lap("eager_steps")
            b = self.feed()
            self.fed.append({k: b[k].detach().clone() for k in BATCH_KEYS})
            drawn_from = noise_gen.get_state()
            self.losses.append(self.trainer.train_many([b])["loss_ae"][0])
            again = torch.Generator(device=self.device)
            again.set_state(drawn_from)
            self.noise.append(torch.randn(2 * self.batch, self.flat,
                                          generator=again,
                                          device=self.device))
            if step == 1:
                self.grad1 = {k: norm(v, self.device, 1.0 - state.tx.b1)
                              for k, v in state.opt_state.mu.items()}
            if step in (3, self.check_steps):
                self.snap[step] = {k: keep(p)
                                   for k, p in state.params().items()}
        watch.lap("capture_steps")
        self.trainer.train_many([self.feed() for _ in range(self.spd)])
        watch.lap("warm_dispatch")
        self.setup_parts = watch.parts

    def work_counts(self) -> Dict[str, float]:
        """The frozen FLOPs of one step and the least bytes of its Adam
        update (``counts.vae``)."""
        return {"flops_per_step": counts.train_step_flops(
                    self.arch, self.batch,
                    int(self.cell.config["model"]["width"])),
                "optimizer_least_bytes_per_step":
                    counts.optimizer_least_bytes(self.arch)}

    def release(self) -> None:
        self.trainer = self.sampler = None
        gc.collect()
        if self.cuda:
            torch.cuda.empty_cache()

    # ------------------------------------------------------------------
    # the two sides of the comparison
    # ------------------------------------------------------------------

    def program_outputs(self) -> Dict:
        """The program's side; the parameters' snapshots are handed
        over, not kept, so that the comparison frees their host memory
        once it has reduced them to norms."""
        snap, self.snap = self.snap, None
        return {"batches": self.fed, "loss": [float(v) for v in self.losses],
                "grad1": self.grad1, "params": snap, "noise": self.noise}

    def _init(self) -> Dict[str, torch.Tensor]:
        if self._init_state is None:
            self._init_state = weight_set(self.arch, self.seeds["weights"],
                                          self.device)
        return self._init_state

    def _change(self, params: Dict[str, torch.Tensor]) -> Dict[str, float]:
        """Per moving leaf, the norm of the parameters' change over the
        entries that move (``moving``)."""
        init = self._init()
        return {k: norm(params[k], self.device, minus=init[k], mask=m)
                for k, m in self._moving.items()}

    def reference_outputs(self, mode: str = "float32",
                          fault: Optional[str] = None) -> Dict:
        """The reference's outputs, reduced to what the comparison reads
        (per leaf, the first gradient's norm and the norms of the change
        after the snapshot steps); with ``fault`` (``FAULTS``) a broken
        program put in the program's place: ``drivers/train.py``'s
        ``half_batch`` (with the kept pairs' noise) and
        ``altered_batch``, and ``zero_noise``, which trains on the mean.
        The program is released first: the reference needs the card.
        The float32 reference's first gradient picks the entries that
        move; any other run follows it."""
        self.release()
        if self._moving is None and (mode, fault) != ("float32", None):
            self.reference_outputs("float32")
        if self.cuda:
            torch.cuda.reset_peak_memory_stats(self.device)
        batches = self._ref_batches()
        fed, noise = batches, list(self.noise)
        if fault == "half_batch":
            h, b = self.batch // 2, self.batch
            fed = [{"image": torch.cat([x["image"][:h],
                                        x["image"][b:b + h]]),
                    **{k: x[k][:h] for k in BATCH_KEYS if k != "image"}}
                   for x in batches]
            noise = [torch.cat([e[:h], e[b:b + h]]) for e in noise]
        elif fault == "altered_batch":
            fed = [{**x, "slice_between": x["slice_between"].clone()}
                   for x in batches]
            for x in fed:
                x["slice_between"][0] = 1.0 - x["slice_between"][0]
            batches = fed
        elif fault == "zero_noise":
            noise = [torch.zeros_like(e) for e in noise]
        elif fault is not None:
            raise ValueError(f"unknown fault {fault!r}")
        out = {"grad1": {}, "change": {}}

        def visit(step, grads, params):
            if step == 1:
                out["grad1"] = {k: norm(g, self.device)
                                for k, g in grads.items()}
                if self._moving is None:
                    self._moving = moving(grads, out["grad1"])
            if step in (3, self.check_steps):
                out["change"][step] = self._change(params)

        r = self.recipe
        with precision(mode):
            res = follow(self.arch, self._init(), fed, noise, float(r["lr"]),
                         float(r.get("momentum", 0.9)),
                         float(r["ex_loss_weight1"]), float(r["vae_beta"]),
                         float(r["lamb"]), mode, visit)
        out.update(loss=res["loss"], batches=batches, noise=noise)
        return out

    def readings(self, prog: Dict, ref: Dict) -> Dict[str, float]:
        """``drivers/train.py``'s readings (the batches, the losses, the
        first gradient, the change after step 3 and after the last
        checked step), each leaf's norm taken leaf by leaf on the card,
        and ``noise_gap`` of the side in the program's place. Prints the
        card's peak since the reference began and the host's peak
        resident memory."""
        if "change" not in prog:
            prog["change"] = {s: self._change(p)
                              for s, p in prog.pop("params").items()}
        batch_gap = max(compare.abs_gap(p[k], r[k])
                        for p, r in zip(prog["batches"], ref["batches"])
                        for k in BATCH_KEYS)
        out = {"batch_gap": batch_gap,
               "loss_gap": compare.rel_gap(prog["loss"], ref["loss"]),
               "grad1_gap": max(leaf_gaps(prog["grad1"], ref["grad1"],
                                          list(ref["grad1"])))}
        for step in (3, self.check_steps):
            gaps = leaf_gaps(prog["change"][step], ref["change"][step],
                             list(self._moving))
            out[f"delta{step}_gap"] = float(
                torch.tensor(gaps, dtype=torch.float64).median())
            out[f"delta{step}_worst_gap"] = max(gaps)
        out["noise_gap"] = noise_gap(prog["noise"])
        card = (torch.cuda.max_memory_allocated(self.device)
                if self.cuda else 0)
        host = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
        print(f"train_vae: reference and comparison card peak "
              f"{card / 1e9:.2f} GB; host peak resident {host / 1e9:.2f} GB",
              file=sys.stderr, flush=True)
        return out
