"""Train state and the optimizer: optax's chain, in plain tensor ops.

Port of ``superresolution_aniso_mri_tpu/train/state.py``. ``make_optimizer``
gives what ``optax.chain(clip_by_global_norm(max_grad_norm),
add_decayed_weights(weight_decay), adam(schedule, b1=momentum, b2=0.999,
eps=1e-8))`` computes, each link present only when its option is set:

- clipping is optax's ``t / ‖g‖ * max_norm`` when ``‖g‖ >= max_norm``
  (not ``clip_grad_norm_``, whose ``+1e-6`` differs);
- weight decay is L2 added to the (clipped) gradient before the moments,
  torch Adam's ``weight_decay`` and not AdamW;
- the learning rate comes from the schedule at the update count BEFORE
  the update, so the first update of a warmup uses lr 0.

The moments live as ``{parameter name: tensor}`` dicts beside an integer
count; ``opt_state_tree`` / ``load_opt_state_tree`` map them to and from
the flax state dict of the optax state (``models/convert.py`` names).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional

import numpy as np
import torch

from ..models import VanillaACAI
from ..models.convert import flax_moments_to_torch, torch_to_flax

B2 = 0.999
EPS = 1e-8


class Schedule:
    """optax's ``constant`` / ``cosine_decay_schedule(alpha=0)`` /
    ``linear_schedule(0 → lr)`` / ``warmup_cosine_decay_schedule(0 → lr →
    0)``, chosen as ``make_optimizer`` chooses them."""

    def __init__(self, lr: float, cosine_steps: Optional[int] = None,
                 warmup_steps: int = 0):
        self.lr = float(lr)
        self.cosine_steps = int(cosine_steps) if cosine_steps else 0
        self.warmup_steps = int(warmup_steps or 0)
        if self.cosine_steps and self.cosine_steps <= self.warmup_steps:
            raise ValueError(f"cosine_steps ({self.cosine_steps}) must "
                             f"exceed warmup_steps ({self.warmup_steps})")

    @property
    def constant(self) -> bool:
        return not (self.cosine_steps or self.warmup_steps)

    def _cosine(self, count: float, peak: float, steps: int) -> float:
        count = min(count, steps)
        return peak * 0.5 * (1.0 + math.cos(math.pi * count / steps))

    def __call__(self, count: int) -> float:
        lr, warm = self.lr, self.warmup_steps
        if self.cosine_steps and warm:
            if count < warm:
                return lr * min(max(count, 0), warm) / warm
            return self._cosine(count - warm, lr, self.cosine_steps - warm)
        if self.cosine_steps:
            return self._cosine(count, lr, self.cosine_steps)
        if warm:
            return lr * min(max(count, 0), warm) / warm
        return lr


@dataclasses.dataclass
class AdamState:
    """optax ``ScaleByAdamState`` (count, mu, nu) plus the schedule's own
    count (None for a constant learning rate, whose state is empty)."""

    count: int
    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]
    schedule_count: Optional[int]


class Optimizer:
    """The optax chain of ``make_optimizer`` on named float32 tensors."""

    def __init__(self, lr: float, weight_decay: float = 0.0,
                 momentum: float = 0.9, cosine_steps: Optional[int] = None,
                 max_grad_norm: float = 0.0, warmup_steps: int = 0):
        self.schedule = Schedule(lr, cosine_steps, warmup_steps)
        self.weight_decay = float(weight_decay or 0.0)
        self.b1 = float(momentum)
        self.max_grad_norm = float(max_grad_norm or 0.0)

    def init(self, params: Dict[str, torch.Tensor]) -> AdamState:
        zeros = {k: torch.zeros_like(p, memory_format=torch.preserve_format)
                 for k, p in params.items()}
        return AdamState(0, zeros,
                         {k: torch.zeros_like(v) for k, v in zeros.items()},
                         None if self.schedule.constant else 0)

    def _clip(self, grads: List[torch.Tensor]) -> List[torch.Tensor]:
        norm = torch.linalg.vector_norm(torch.stack(
            torch._foreach_norm(grads)))
        keep = norm < self.max_grad_norm
        # the ratio is only taken where the norm reached max_norm
        div = torch.where(keep, torch.ones_like(norm), norm)
        mul = torch.where(keep, torch.ones_like(norm),
                          torch.full_like(norm, self.max_grad_norm))
        return torch._foreach_mul(torch._foreach_div(grads, div), mul)

    @torch.no_grad()
    def step(self, params: Dict[str, torch.Tensor],
             grads: Dict[str, torch.Tensor], state: AdamState) -> None:
        """One update of ``params`` in place; ``state`` advances."""
        names = list(params)
        p = [params[k] for k in names]
        g = [grads[k] for k in names]
        if self.max_grad_norm:
            g = self._clip(g)
        if self.weight_decay:
            g = torch._foreach_add(g, p, alpha=self.weight_decay)
        mu = [state.mu[k] for k in names]
        nu = [state.nu[k] for k in names]
        b1 = self.b1
        # (1 - b) * g + b * m, as optax orders it
        torch._foreach_mul_(mu, b1)
        torch._foreach_add_(mu, torch._foreach_mul(g, 1.0 - b1))
        torch._foreach_mul_(nu, B2)
        torch._foreach_add_(nu, torch._foreach_mul(
            torch._foreach_mul(g, g), 1.0 - B2))
        count = state.count + 1
        # bias corrections in float32, as optax computes b ** count
        c1 = float(np.float32(1) - np.float32(b1) ** np.float32(count))
        c2 = float(np.float32(1) - np.float32(B2) ** np.float32(count))
        denom = torch._foreach_sqrt(torch._foreach_div(nu, c2))
        torch._foreach_add_(denom, EPS)
        upd = torch._foreach_div(torch._foreach_div(mu, c1), denom)
        lr = self.schedule(state.schedule_count or 0)
        torch._foreach_add_(p, torch._foreach_mul(upd, -lr))
        state.count = count
        if state.schedule_count is not None:
            state.schedule_count += 1

    def opt_state_tree(self, state: AdamState) -> dict:
        """The flax state dict of the optax chain's state: the chain's
        links as ``'0'``, ``'1'``, …; clip and decay hold ``{}``; adam is
        ``{'0': {count, mu, nu}, '1': {} or {count}}``; counts int32."""
        adam = {"0": {"count": np.asarray(state.count, np.int32),
                      "mu": torch_to_flax(state.mu)[0],
                      "nu": torch_to_flax(state.nu)[0]},
                "1": ({} if state.schedule_count is None else
                      {"count": np.asarray(state.schedule_count, np.int32)})}
        links = [{} for _ in range(bool(self.max_grad_norm)
                                   + bool(self.weight_decay))] + [adam]
        return {str(i): link for i, link in enumerate(links)}

    def load_opt_state_tree(self, tree: dict, state: AdamState,
                            model: VanillaACAI) -> None:
        """Set ``state`` from a tree of ``opt_state_tree``'s layout.
        Raises ValueError (changing nothing) when the layout differs:
        other links, another schedule or other parameter shapes."""
        keys = [str(i) for i in range(bool(self.max_grad_norm)
                                      + bool(self.weight_decay) + 1)]
        if not isinstance(tree, dict) or sorted(tree) != sorted(keys):
            raise ValueError(f"optimizer chain links {sorted(tree or {})} "
                             f"!= {keys}")
        if any(not isinstance(tree[k], dict) or tree[k] for k in keys[:-1]):
            raise ValueError("a clip or decay link holds state")
        adam = tree[keys[-1]]
        sched = [] if state.schedule_count is None else ["count"]
        if not (isinstance(adam, dict) and sorted(adam) == ["0", "1"]
                and isinstance(adam["1"], dict) and sorted(adam["1"]) == sched
                and isinstance(adam["0"], dict)
                and sorted(adam["0"]) == ["count", "mu", "nu"]):
            raise ValueError("adam state does not match this optimizer")
        mu = flax_moments_to_torch(adam["0"]["mu"], model.config)
        nu = flax_moments_to_torch(adam["0"]["nu"], model.config)
        with torch.no_grad():
            for k in state.mu:
                state.mu[k].copy_(mu[k])
                state.nu[k].copy_(nu[k])
        state.count = int(adam["0"]["count"])
        if sched:
            state.schedule_count = int(adam["1"]["count"])


def make_optimizer(lr: float, weight_decay: float = 0.0,
                   momentum: float = 0.9,
                   cosine_steps: Optional[int] = None,
                   max_grad_norm: float = 0.0,
                   warmup_steps: int = 0) -> Optimizer:
    return Optimizer(lr, weight_decay, momentum, cosine_steps,
                     max_grad_norm, warmup_steps)


@dataclasses.dataclass
class TrainState:
    """A ``VanillaACAI`` (parameters and BatchNorm running statistics),
    its optimizer and the optimizer's state, and the step count."""

    model: VanillaACAI
    tx: Optimizer
    opt_state: AdamState
    step: int = 0

    def params(self) -> Dict[str, torch.Tensor]:
        return dict(self.model.named_parameters())


def create_train_state(model: VanillaACAI, lr: float,
                       weight_decay: float = 0.0, momentum: float = 0.9,
                       cosine_steps: Optional[int] = None,
                       max_grad_norm: float = 0.0,
                       warmup_steps: int = 0) -> TrainState:
    """A fresh state around ``model`` (already on its device)."""
    tx = make_optimizer(lr, weight_decay, momentum, cosine_steps,
                        max_grad_norm, warmup_steps)
    return TrainState(model, tx,
                      tx.init({k: p.detach() for k, p in
                               model.named_parameters()}))
