"""The training path: triplet sampling, the recipe's augmentations, the
``ae_combined`` step and Adam.

Sampling and augmentation follow the reference repository's data
contract and draw from the same seeded streams as the program, so that
one seed gives one sequence of batches: a ``numpy.random.RandomState``
picks each batch's flat slice indices (with replacement), then per item
the neighbour ``downsample_steps`` away (``adjacent_plus``, clamped at the
volume's ends), the in-between slice uniformly inside the gap, and the
from/to order; a CPU ``torch.Generator`` draws each batch's crop windows,
the intensity gain in [2.5, 7.5) and cutoff in [0.25, 0.75), and the
rot90 turns, in that order. The maps: centred pad / crop to the
augmentation size, the crop window (or the centre), ``sigmoid(gain * (x -
cutoff))``, and ``rot90`` over the image axes.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from .losses import lap_loss, lap_loss_per_sample, mse, weighted
from .model import Arch, Net, clone_state, is_buffer


class Sampler:
    """Triplet draws over ``volumes`` ([S, P, P] float32 numpy stacks)."""

    def __init__(self, volumes: Sequence[np.ndarray], downsample_steps: int,
                 seed: int):
        self.volumes = list(volumes)
        self.ds = int(downsample_steps)
        self.rs = np.random.RandomState(seed)
        self.index = np.asarray([(vi, s) for vi, v in enumerate(self.volumes)
                                 for s in range(v.shape[0])], np.int64)

    def _neighbour(self, s1: int, n: int, step: int) -> int:
        last = n - 1
        if s1 + step > last:
            res = s1 - step
        elif s1 == 0:
            res = step
        elif s1 - step < 0:
            res = s1 + step
        else:
            res = int(self.rs.choice([s1 - step, s1 + step]))
        return int(np.clip(res, 0, last))

    def _item(self, flat: int) -> Dict:
        vi, s1 = (int(v) for v in self.index[flat])
        n = self.volumes[vi].shape[0]
        s2 = self._neighbour(s1, n, max(1, min(self.ds, n - 1)))
        lo, hi = min(s1, s2), max(s1, s2)
        between = (int(self.rs.choice(np.arange(lo + 1, hi))) if hi - lo > 1
                   else lo)
        s_from, s_to = (s1, s2) if self.rs.choice([0, 1]) == 0 else (s2, s1)
        if hi - lo > 1:
            gap = s_to - s_from
            a_from = 1.0 - (between - s_from) / gap
            a_to = 1.0 - (s_to - between) / gap
        else:
            a_from = a_to = 0.5
        return {"vi": vi, "slots": (s_from, s_to, between), "a_from": a_from,
                "a_to": a_to, "is_inbetween": float(hi - lo > 1)}

    def draw(self, batch: int) -> Dict[str, np.ndarray]:
        """{triplet [B, 3, P, P], alpha_from, alpha_to, is_inbetween}."""
        sel = self.rs.randint(0, len(self.index), size=batch)
        items = [self._item(int(i)) for i in sel]
        trip = np.stack([self.volumes[it["vi"]][list(it["slots"])]
                         for it in items]).astype(np.float32)
        return {"triplet": trip,
                **{k: np.array([it[k] for it in items], np.float32)
                   for k in ("a_from", "a_to", "is_inbetween")}}


@dataclasses.dataclass(frozen=True)
class Augment:
    """The recipe's augmentation (the configuration's ``augment``)."""

    patch_size: int
    aug_patch_size: Optional[int] = None
    random_crop: bool = True
    crop_next_to_center: bool = False
    max_translation: int = 35
    intensity: bool = True
    rot90: bool = True

    def working_size(self, h: int) -> int:
        return max(self.aug_patch_size or h, self.patch_size)

    def draw(self, g: torch.Generator, batch: int, h: int) -> Dict:
        hh, p, out = self.working_size(h), self.patch_size, {}
        crop = hh > p and (self.random_crop or self.crop_next_to_center)
        if crop and self.crop_next_to_center:
            mt = int(self.max_translation)
            dy = torch.randint(-mt, mt + 1, (batch,), generator=g)
            dx = torch.randint(-mt, mt + 1, (batch,), generator=g)
            out["top"] = ((hh - p) // 2 + dy).clamp(0, hh - p)
            out["left"] = ((hh - p) // 2 + dx).clamp(0, hh - p)
        elif crop:
            out["top"] = torch.randint(0, hh - p + 1, (batch,), generator=g)
            out["left"] = torch.randint(0, hh - p + 1, (batch,), generator=g)
        if self.intensity:
            out["gain"] = 2.5 + 5.0 * torch.rand(batch, generator=g)
            out["cutoff"] = 0.25 + 0.5 * torch.rand(batch, generator=g)
        if self.rot90:
            out["k"] = torch.randint(0, 4, (batch,), generator=g)
        return out

    def apply(self, x: torch.Tensor, draws: Dict) -> torch.Tensor:
        """[B, C, H, W] → [B, C, p, p]."""
        if self.aug_patch_size is not None:
            x = _centre(x, self.aug_patch_size)
        x = _centre(x, max(x.shape[-1], self.patch_size))
        p = self.patch_size
        if x.shape[-1] > p:
            if "top" in draws:
                x = torch.stack([x[b, :, t:t + p, l:l + p] for b, (t, l) in
                                 enumerate(zip(draws["top"].tolist(),
                                               draws["left"].tolist()))])
            else:
                x = _centre(x, p)
        if self.intensity:
            gain = draws["gain"].to(x.device).view(-1, 1, 1, 1)
            cutoff = draws["cutoff"].to(x.device).view(-1, 1, 1, 1)
            x = torch.sigmoid(-gain * (cutoff - x))
        if self.rot90:
            x = torch.stack([torch.rot90(x[b], int(k), dims=(-2, -1))
                             for b, k in enumerate(draws["k"].tolist())])
        return x


def _centre(x: torch.Tensor, size: int) -> torch.Tensor:
    """Centred zero pad up to ``size``, then a centred crop to it."""
    h, w = x.shape[-2:]
    ph, pw = max(0, size - h), max(0, size - w)
    if ph or pw:
        x = F.pad(x, (pw // 2, pw - pw // 2, ph // 2, ph - ph // 2))
    h, w = x.shape[-2:]
    top, left = (h - size) // 2, (w - size) // 2
    return x[..., top:top + size, left:left + size]


def make_batch(sampler: Sampler, aug: Augment, g: torch.Generator,
               batch: int, device) -> Dict[str, torch.Tensor]:
    """One training batch: ``image`` [2B, 1, p, p] (from ∥ to),
    ``slice_between`` [B, 1, p, p], ``alpha_from``, ``alpha_to``,
    ``is_inbetween`` [B]."""
    raw = sampler.draw(batch)
    trip = torch.from_numpy(raw["triplet"]).to(device)
    x = aug.apply(trip, aug.draw(g, batch, trip.shape[-1]))
    return {"image": torch.cat([x[:, 0:1], x[:, 1:2]]).contiguous(),
            "slice_between": x[:, 2:3].contiguous(),
            "alpha_from": torch.from_numpy(raw["a_from"]).to(device),
            "alpha_to": torch.from_numpy(raw["a_to"]).to(device),
            "is_inbetween": torch.from_numpy(raw["is_inbetween"]).to(device)}


def ae_combined_loss(net: Net, batch: Dict[str, torch.Tensor],
                     mix_weight: float, use_laploss: bool = True):
    """(loss, metrics) of one ``ae_combined`` step: reconstruction MSE
    (+ the pyramid loss) of the from/to slices, plus ``mix_weight`` times
    the synthesis loss of the slice decoded from the latents mixed at the
    in-between position, each pair weighted by ``is_inbetween``. The
    encoder and decoder passes over the from/to slices move the running
    statistics; the others only use their batch's."""
    x, between, mode = batch["image"], batch["slice_between"], net.mode
    b = between.shape[0]
    z = net.encode(x, train=True, update_stats=True)
    out = net.decode(z, train=True, update_stats=True)
    dist = mse(out, x)
    lap = lap_loss(out, x, mode) if use_laploss else dist.new_zeros(())
    shape = (b, 1, 1, 1)
    z_mix = (batch["alpha_from"].view(shape) * z[:b]
             + batch["alpha_to"].view(shape) * z[b:])
    s_mix = net.decode(z_mix, train=True)
    z_ref = net.encode(between, train=True)
    w = batch.get("is_inbetween")
    loss_mix = weighted(((between - s_mix) ** 2).mean(dim=(1, 2, 3)), w)
    if use_laploss:
        loss_mix = loss_mix + weighted(
            lap_loss_per_sample(s_mix, between, mode), w)
    total = dist + lap + mix_weight * loss_mix
    return total, {"loss_ae": total.detach(), "loss_ae_dist": dist.detach(),
                   "loss_latent_1": mse(z_mix, z_ref).detach()}


@dataclasses.dataclass
class Adam:
    """optax's Adam (b2 0.999, eps 1e-8 outside the square root), the
    bias corrections in float32 at the advanced count."""

    lr: float
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8

    def step(self, params: Dict[str, torch.Tensor],
             grads: Dict[str, torch.Tensor], mu: Dict, nu: Dict,
             count: int) -> None:
        c1 = float(np.float32(1) - np.float32(self.b1) ** np.float32(count))
        c2 = float(np.float32(1) - np.float32(self.b2) ** np.float32(count))
        with torch.no_grad():
            for k, g in grads.items():
                mu[k] = self.b1 * mu[k] + (1.0 - self.b1) * g
                nu[k] = self.b2 * nu[k] + (1.0 - self.b2) * g * g
                upd = (mu[k] / c1) / (torch.sqrt(nu[k] / c2) + self.eps)
                params[k] = params[k] - self.lr * upd


def follow(arch: Arch, init: Dict[str, torch.Tensor],
           batches: List[Dict[str, torch.Tensor]], lr: float, b1: float,
           mix_weight: float, use_laploss: bool, mode: str = "float32",
           snapshots: Sequence[int] = (3,)):
    """Train from the state ``init`` on ``batches``, one Adam step each.
    Returns {"loss": [per step], "grad1": {leaf: first gradient},
    "params": {step: {leaf: parameters after that step}}}."""
    state = clone_state(init)
    names = [k for k in state if not is_buffer(k)]
    mu = {k: torch.zeros_like(state[k]) for k in names}
    nu = {k: torch.zeros_like(state[k]) for k in names}
    adam = Adam(lr, b1)
    out = {"loss": [], "grad1": None, "params": {}}
    for i, batch in enumerate(batches, start=1):
        for k in names:
            state[k] = state[k].detach().requires_grad_(True)
        net = Net(arch, state, mode)
        loss, _ = ae_combined_loss(net, batch, mix_weight, use_laploss)
        grads = dict(zip(names, torch.autograd.grad(
            loss, [state[k] for k in names])))
        out["loss"].append(float(loss.detach()))
        if i == 1:
            out["grad1"] = {k: g.detach().clone() for k, g in grads.items()}
        params = {k: state[k].detach() for k in names}
        adam.step(params, grads, mu, nu, i)
        state.update(params)
        if i in snapshots:
            out["params"][i] = {k: params[k].clone() for k in names}
    return out
