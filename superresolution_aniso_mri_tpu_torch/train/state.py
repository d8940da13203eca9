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

``PartitionOptimizer`` is ``optax.multi_transform`` over the top-level
parameter groups of the ACAI family's ``{"ae", "disc"}`` model (JAX
``train/trainer.py:217-234``): one ``Optimizer`` per group, each
clipping by its own global norm, with its own schedule and moments.

On a 2-D mesh (``parallel.shard_state_2d``) the parameters named in
``model_sharded`` and their moments are this rank's shards: the global
norm adds their squares summed over the model group to those of the
replicated parameters, whose gradients are first averaged over the
group so that they update to the same bits on every rank; decay and
Adam are element-wise, so they run on the shards as on whole tensors.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional

import numpy as np
import torch

from ..device import byte_groups
from ..parallel.distributed import model_mean, model_sum
from ..models.convert import (flax_key, flax_moments_to_torch, set_in,
                              torch_to_flax)

B2 = 0.999
EPS = 1e-8


def scalar_tensor(values, device) -> torch.Tensor:
    """Host floats as a float32 tensor on ``device``, copied without a
    host sync: a pageable host buffer is staged by the copy itself
    before it returns, so nothing waits for the device."""
    return torch.tensor(values, dtype=torch.float32).to(device,
                                                        non_blocking=True)


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

    # the parameters that are model-group shards: set by
    # ``parallel.shard_state_2d``, None for a state it has not placed
    model_sharded: Optional[frozenset] = None

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

    def _global_norm(self, names: List[str],
                     grads: Dict[str, torch.Tensor]) -> torch.Tensor:
        """The norm of the whole gradient; the shards' squares are summed
        over the model group and added once to the replicated leaves'."""
        if not self.model_sharded:
            return torch.linalg.vector_norm(torch.stack(
                torch._foreach_norm([grads[k] for k in names])))
        zero = grads[names[0]].new_zeros(())

        def squares(keys):
            return (torch.stack(torch._foreach_norm([grads[k] for k in keys]))
                    .square().sum() if keys else zero)

        own = [k for k in names if k in self.model_sharded]
        rest = [k for k in names if k not in self.model_sharded]
        return torch.sqrt(squares(rest) + model_sum(squares(own)))

    def _replicas_agree(self, names: List[str],
                        grads: Dict[str, torch.Tensor]
                        ) -> Dict[str, torch.Tensor]:
        """``grads`` with each replicated parameter's gradient averaged
        over the model group. Its ranks computed it from the same values,
        but a backward on the card need not give the same bits twice
        (cuDNN's algorithms, atomic adds), and the replicated parameters
        must stay the same bits on every rank of the group."""
        rest = [k for k in names if k not in self.model_sharded]
        return {**grads, **dict(zip(rest, model_mean(
            [grads[k] for k in rest])))}

    def _clip_factors(self, norm: torch.Tensor):
        """(div, mul) of optax's clip: ``g / div * mul``."""
        keep = norm < self.max_grad_norm
        # the ratio is only taken where the norm reached max_norm
        div = torch.where(keep, torch.ones_like(norm), norm)
        mul = torch.where(keep, torch.ones_like(norm),
                          torch.full_like(norm, self.max_grad_norm))
        return div, mul

    def host_scalars(self, state: AdamState) -> List[float]:
        """``[c1, c2, lr]`` of the next update: the bias corrections
        ``1 - b ** count`` in float32 at the advanced count, as optax
        computes them, and the schedule's rate at the count BEFORE the
        update."""
        count = np.float32(state.count + 1)
        return [float(np.float32(1) - np.float32(self.b1) ** count),
                float(np.float32(1) - np.float32(B2) ** count),
                self.schedule(state.schedule_count or 0)]

    def scalar_rows(self, state: AdamState, mix_weight: float) -> List[float]:
        """The step's ``scalars``: ``host_scalars`` and the synthesis-loss
        weight."""
        return self.host_scalars(state) + [float(mix_weight)]

    @staticmethod
    def advance(state: AdamState) -> None:
        """The host counts of one update."""
        state.count += 1
        if state.schedule_count is not None:
            state.schedule_count += 1

    @torch.no_grad()
    def apply(self, params: Dict[str, torch.Tensor],
              grads: Dict[str, torch.Tensor], state: AdamState,
              scalars: torch.Tensor) -> None:
        """One update of ``params`` and the moments in place, reading
        ``scalars`` (a float32 tensor on their device that starts with
        ``host_scalars(state)``). Device work only: it neither syncs with
        the host nor advances the counts, so a CUDA graph can capture it
        and replay it with new ``scalars``. The element-wise work runs in
        groups of at most ``GROUP_BYTES`` (the same numbers as one pass)."""
        names = list(params)
        if self.model_sharded is not None:
            grads = self._replicas_agree(names, grads)
        clip = (self._clip_factors(self._global_norm(names, grads))
                if self.max_grad_norm else None)
        c1, c2, lr = scalars[0], scalars[1], scalars[2]
        b1 = self.b1
        for group in byte_groups([params[k] for k in names]):
            keys = [names[i] for i in group]
            p = [params[k] for k in keys]
            g = [grads[k] for k in keys]
            if clip is not None:
                g = torch._foreach_mul(torch._foreach_div(g, clip[0]),
                                       clip[1])
            if self.weight_decay:
                g = torch._foreach_add(g, p, alpha=self.weight_decay)
            mu = [state.mu[k] for k in keys]
            nu = [state.nu[k] for k in keys]
            # (1 - b) * g + b * m, as optax orders it
            torch._foreach_mul_(mu, b1)
            torch._foreach_add_(mu, torch._foreach_mul(g, 1.0 - b1))
            torch._foreach_mul_(nu, B2)
            torch._foreach_add_(nu, torch._foreach_mul(
                torch._foreach_mul(g, g), 1.0 - B2))
            del g
            denom = torch._foreach_sqrt(torch._foreach_div(nu, c2))
            torch._foreach_add_(denom, EPS)
            upd = torch._foreach_div(torch._foreach_div(mu, c1), denom)
            del denom
            torch._foreach_sub_(p, torch._foreach_mul(upd, lr))

    def step(self, params: Dict[str, torch.Tensor],
             grads: Dict[str, torch.Tensor], state: AdamState) -> None:
        """One update of ``params`` in place; ``state`` advances."""
        device = next(iter(params.values())).device
        self.apply(params, grads, state,
                   scalar_tensor(self.host_scalars(state), device))
        self.advance(state)

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
                            params_like: Dict[str, torch.Tensor],
                            cfg=None) -> None:
        """Set ``state`` from a tree of ``opt_state_tree``'s layout, its
        moments matched against ``params_like``'s names and shapes.
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
        mu = flax_moments_to_torch(adam["0"]["mu"], cfg, params_like)
        nu = flax_moments_to_torch(adam["0"]["nu"], cfg, params_like)
        with torch.no_grad():
            for k in state.mu:
                state.mu[k].copy_(mu[k])
                state.nu[k].copy_(nu[k])
        state.count = int(adam["0"]["count"])
        if sched:
            state.schedule_count = int(adam["1"]["count"])


def _label(name: str) -> str:
    return name.split(".", 1)[0]


class PartitionOptimizer:
    """``optax.multi_transform`` over top-level parameter groups: each
    parameter named ``<label>.…`` is updated by ``groups[label]`` alone.
    The state is ``{label: AdamState}``; ``scalars`` has one row per
    group, in the order of ``groups``."""

    def __init__(self, groups: Dict[str, Optimizer]):
        self.groups = groups
        self.names: Dict[str, List[str]] = {}

    def split(self, named: Dict[str, torch.Tensor]):
        out: Dict[str, Dict[str, torch.Tensor]] = {g: {} for g in self.groups}
        for k, v in named.items():
            out[_label(k)][k] = v
        return out

    def init(self, params: Dict[str, torch.Tensor]) -> Dict[str, AdamState]:
        parts = self.split(params)
        self.names = {g: list(parts[g]) for g in self.groups}
        return {g: tx.init(parts[g]) for g, tx in self.groups.items()}

    def scalar_rows(self, state, mix_weight: float) -> List[List[float]]:
        return [tx.scalar_rows(state[g], mix_weight)
                for g, tx in self.groups.items()]

    def advance(self, state) -> None:
        for g, tx in self.groups.items():
            tx.advance(state[g])

    @torch.no_grad()
    def apply(self, params, grads, state, scalars: torch.Tensor) -> None:
        p, g = self.split(params), self.split(grads)
        for i, (label, tx) in enumerate(self.groups.items()):
            tx.apply(p[label], g[label], state[label], scalars[i])

    def _masked(self, label: str) -> dict:
        """The params tree of every group but ``label`` with ``{}``
        leaves: optax's ``MaskedNode`` in flax's state dict."""
        tree: dict = {}
        for g, names in self.names.items():
            if g != label:
                for name in names:
                    _, path, leaf = flax_key(name)
                    set_in(tree, path + (leaf,), {})
        return tree

    def opt_state_tree(self, state) -> dict:
        """``{'inner_states': {label: {'inner_state': chain}}}`` where each
        group's chain holds moment trees over ALL parameters, the other
        groups' leaves masked to ``{}``."""
        inner = {}
        for label, tx in self.groups.items():
            chain = tx.opt_state_tree(state[label])
            masked = self._masked(label)
            adam = chain[max(chain, key=int)]["0"]
            for mom in ("mu", "nu"):
                adam[mom] = {**masked, **adam[mom]}
            inner[label] = {"inner_state": chain}
        return {"inner_states": inner}

    def load_opt_state_tree(self, tree: dict, state,
                            params_like: Dict[str, torch.Tensor],
                            cfg=None) -> None:
        """Set ``state`` from a tree of ``opt_state_tree``'s layout;
        raises ValueError (changing nothing) when it differs."""
        if not (isinstance(tree, dict) and list(tree) == ["inner_states"]
                and isinstance(tree["inner_states"], dict)
                and sorted(tree["inner_states"]) == sorted(self.groups)
                and all(isinstance(v, dict) and list(v) == ["inner_state"]
                        for v in tree["inner_states"].values())):
            raise ValueError("optimizer state is not a multi_transform over "
                             f"the groups {sorted(self.groups)}")
        staged = {label: dataclasses.replace(
            state[label], mu={k: v.clone() for k, v in state[label].mu.items()},
            nu={k: v.clone() for k, v in state[label].nu.items()})
            for label in self.groups}
        parts = self.split(params_like)
        for label, tx in self.groups.items():
            tx.load_opt_state_tree(
                tree["inner_states"][label]["inner_state"], staged[label],
                parts[label], cfg)
        for label in self.groups:
            with torch.no_grad():
                for k in state[label].mu:
                    state[label].mu[k].copy_(staged[label].mu[k])
                    state[label].nu[k].copy_(staged[label].nu[k])
            state[label].count = staged[label].count
            state[label].schedule_count = staged[label].schedule_count


def make_optimizer(lr: float, weight_decay: float = 0.0,
                   momentum: float = 0.9,
                   cosine_steps: Optional[int] = None,
                   max_grad_norm: float = 0.0,
                   warmup_steps: int = 0) -> Optimizer:
    return Optimizer(lr, weight_decay, momentum, cosine_steps,
                     max_grad_norm, warmup_steps)


@dataclasses.dataclass
class TrainState:
    """A model (parameters and BatchNorm running statistics; for the
    ACAI family the ``{"ae", "disc"}`` ``ModuleDict``), its optimizer
    and the optimizer's state, and the step count."""

    model: torch.nn.Module
    tx: object
    opt_state: object
    step: int = 0

    def params(self) -> Dict[str, torch.Tensor]:
        return dict(self.model.named_parameters())


def create_train_state(model: torch.nn.Module, lr: float,
                       weight_decay: float = 0.0, momentum: float = 0.9,
                       cosine_steps: Optional[int] = None,
                       max_grad_norm: float = 0.0,
                       warmup_steps: int = 0, tx=None) -> TrainState:
    """A fresh state around ``model`` (already on its device); ``tx``
    (e.g. a ``PartitionOptimizer``) replaces the ``make_optimizer``
    chain of the other arguments."""
    if tx is None:
        tx = make_optimizer(lr, weight_decay, momentum, cosine_steps,
                            max_grad_norm, warmup_steps)
    return TrainState(model, tx,
                      tx.init({k: p.detach() for k, p in
                               model.named_parameters()}))
