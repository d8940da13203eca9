"""Data-parallel training and sharded volume inference over a mesh.

Port of ``superresolution_aniso_mri_tpu/parallel/mesh.py:26-178``. A
mesh here is an ordered list of ``torch.device``s.

Training runs one rank per mesh entry (``distributed.launch``): rank r
holds a replica of the state on ``mesh[r]`` and steps on its rows of
the global batch; the losses and the train-mode BatchNorm statistics
are reduced over the group inside the step and the gradient is
all-reduced before the clip and Adam, so the N-rank step computes the
single-process step on the global batch (JAX's GSPMD program does the
same from sharding annotations).

Inference runs in one process that drives every device of the mesh: a
replica of the model per device, the kept slices (or the volumes)
split in contiguous blocks, work on each device issued in turn (the
devices run concurrently), outputs gathered on ``mesh[0]``. The slice
axis needs no halo exchange: the latent stack is small, so every shard
mixes its pairs from the whole gathered stack, the multi-tap taps of a
pair near a shard boundary included.

The 2-D data × model mesh (``:181-232``) also runs one rank per mesh
entry, rank ``d * mp + m`` at row d, column m. The rows of the global
batch are split over the data axis; each conv kernel whose output
channels divide by ``mp`` (JAX's ``_param_spec``) is split along them
over the model axis, its Adam moments too, and every other tensor is
replicated. A sharded conv gathers its channels over the model group
(``models/acai.py``), so what follows it is replicated there; the loss,
BatchNorm and gradient reductions run over the data group, and the
replicated parameters' gradients are also averaged over the model
group, so that those parameters stay the same bits on its ranks. JAX's
GSPMD derives the same program from the sharding annotations.
"""
from __future__ import annotations

import copy
import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ..device import f32_exact
from . import distributed

DATA_AXIS = "data"
MODEL_AXIS = "model"


def create_mesh(devices: Optional[Sequence] = None) -> List[torch.device]:
    """The mesh of ``devices`` (default: the devices of the running
    group's ranks, else every CUDA device)."""
    if devices is None:
        if distributed.is_rank():
            return distributed.rank_mesh()
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    mesh = [distributed.as_device(d) for d in devices]
    if not mesh:
        raise ValueError("a mesh needs at least one device")
    return mesh


def local_mesh(num_devices: int, device) -> List[torch.device]:
    """The first ``num_devices`` devices of ``device``'s type: N shards
    of the CPU, or ``cuda:0 … cuda:N-1`` (ValueError when fewer are
    attached, as JAX raises)."""
    n = int(num_devices)
    if torch.device(device).type != "cuda":
        return [torch.device("cpu")] * n
    count = torch.cuda.device_count()
    if count < n:
        raise ValueError(
            f"num_devices={n} but only {count} device(s) attached; for "
            f"CPU testing pass device='cpu' (N shards or gloo ranks on "
            f"the CPU)")
    return [torch.device("cuda", i) for i in range(n)]


def shard_batch(mesh: Sequence[torch.device], batch: Dict) -> Dict:
    """This rank's rows of the global ``batch`` (the same on every rank;
    ``distributed.global_batch_from_host``, pairs kept whole) on its
    mesh device. JAX returns global arrays sharded over the mesh; here
    each rank holds its shard."""
    rank = distributed.process_index()
    rows = distributed.global_batch_from_host(batch, rank, len(mesh))
    return {k: v.to(mesh[rank], non_blocking=True) for k, v in rows.items()}


@torch.no_grad()
def replicate_state(mesh: Sequence[torch.device], state):
    """``state`` with rank 0's parameters, BatchNorm statistics and Adam
    moments on every rank (broadcast over the group; the host counts are
    equal by construction). Outside a group: ``state`` as it is."""
    if not distributed.is_rank():
        return state
    if dist.get_world_size() != len(mesh):
        raise ValueError(f"mesh of {len(mesh)} devices for a group of "
                         f"{dist.get_world_size()} ranks")
    tensors = list(state.model.state_dict().values())
    opt = state.opt_state
    for adam in (opt.values() if isinstance(opt, dict) else [opt]):
        tensors += list(adam.mu.values()) + list(adam.nu.values())
    for t in tensors:
        dist.broadcast(t, src=0)
    return state


def make_sharded_train_step(loss_config, lpips_params, mesh: Sequence):
    """``step(state, batch, mix_weight) → (state, metrics)`` of
    ``train.steps.make_train_step`` on one rank of the process group of
    ``len(mesh)`` ranks: ``batch`` is the global batch, its noise
    included; the rank steps on its rows
    (``shard_batch``) with every loss, BatchNorm statistic and the
    gradient reduced over the group, and returns the global metrics.
    Every rank's state stays equal to the others'."""
    from ..train.steps import make_train_step

    base = make_train_step(loss_config, lpips_params)
    mesh = list(mesh)

    def step(state, batch, mix_weight):
        if not distributed.is_rank():
            raise RuntimeError(
                f"a sharded train step over {len(mesh)} devices needs a "
                f"process group of {len(mesh)} ranks: start them with "
                f"parallel.launch (the train CLI does with --num_devices)")
        local = shard_batch(mesh, batch)
        with distributed.reducing_over(dist.group.WORLD):
            return base(state, local, mix_weight)

    return step


class _Replicas:
    """A copy of ``model`` on each mesh device (``model`` itself on its
    own device); ``sync()`` copies the model's current weights into the
    copies, so a synthesizer cached for a model that trains on serves
    its weights of the moment."""

    def __init__(self, model, mesh: Sequence[torch.device]):
        home = next(model.parameters()).device
        made: Dict[torch.device, object] = {home: model}
        for dev in mesh:
            if dev not in made:
                made[dev] = copy.deepcopy(model).to(dev)
        self.model = model
        self.copies = [m for m in made.values() if m is not model]
        self.per_device = [made[dev] for dev in mesh]

    @torch.no_grad()
    def sync(self) -> None:
        src = list(self.model.state_dict().values())
        for replica in self.copies:
            torch._foreach_copy_(list(replica.state_dict().values()), src)


def make_sharded_synthesizer(model, mesh: Sequence,
                             decode_batch: Optional[int] = None,
                             latent_interp: str = "linear"):
    """``synth(kept [K,C,H,W] or [B,K,C,H,W], alphas [A], use_original,
    interleave)`` of ``infer.super_volume.make_synthesis_core`` with the
    kept-slice axis split over the mesh (K divisible by its size;
    ``create_super_volume`` pads): each device encodes its block, the
    latents are gathered (small), each device mixes the pairs that start
    in its block from the whole stack and decodes them with its block's
    reconstructions. ``decode_batch`` bounds each device's chunks.
    Outputs lie on ``mesh[0]``."""
    from ..infer.super_volume import SynthesisStages

    mesh = [distributed.as_device(d) for d in mesh]
    replicas = _Replicas(model, mesh)
    stages = [SynthesisStages(m, decode_batch, latent_interp=latent_interp)
              for m in replicas.per_device]
    n = len(mesh)

    def synth(kept: torch.Tensor, alphas: torch.Tensor,
              use_original: bool = False, interleave: bool = False):
        single = kept.ndim == 4
        kept = kept[None] if single else kept
        k = kept.shape[1]
        if k % n:
            raise ValueError(f"kept-slice count {k} is not divisible by "
                             f"the mesh size {n}")
        step = k // n
        replicas.sync()
        blocks = [kept[:, s * step:(s + 1) * step].to(dev, non_blocking=True)
                  for s, dev in enumerate(mesh)]
        with torch.inference_mode(), f32_exact():
            z_own = [st.encode(x) for st, x in zip(stages, blocks)]
            z_all = torch.cat([z.to(mesh[0]) for z in z_own], dim=1)
            parts = []
            for s, (st, dev) in enumerate(zip(stages, mesh)):
                lo, hi = s * step, min((s + 1) * step, k - 1)
                z_mix = st.mix(z_all.to(dev), alphas.to(dev), lo, hi)
                parts.append(st.decode(blocks[s], z_own[s], z_mix,
                                       use_original))
            out = {key: torch.cat([p[key].to(mesh[0]) for p in parts], dim=1)
                   for key in ("recon", "interp")}
            return stages[0].finish(out, interleave, single)

    return synth


def make_sharded_batched_synthesizer(model, mesh: Sequence,
                                     decode_batch: Optional[int] = None,
                                     latent_interp: str = "linear"):
    """``synth(kept [B,K,C,H,W], alphas [A], use_original)`` →
    interleaved, clamped volumes ``[B, S', C, H, W]`` (the port's
    ``make_batched_synthesizer``) with the volume axis split over the
    mesh (B divisible by its size; ``create_super_volumes`` pads with
    the last volume). Outputs lie on ``mesh[0]``."""
    from ..infer.super_volume import make_synthesis_core

    mesh = [distributed.as_device(d) for d in mesh]
    replicas = _Replicas(model, mesh)
    cores = [make_synthesis_core(m, decode_batch,
                                 latent_interp=latent_interp)
             for m in replicas.per_device]
    n = len(mesh)

    def synth(kept: torch.Tensor, alphas: torch.Tensor,
              use_original: bool = False) -> torch.Tensor:
        b = kept.shape[0]
        if b % n:
            raise ValueError(f"volume count {b} is not divisible by the "
                             f"mesh size {n}")
        step = b // n
        replicas.sync()
        vols = [core(kept[s * step:(s + 1) * step].to(dev, non_blocking=True),
                     alphas.to(dev), use_original, True)["volume"]
                for s, (core, dev) in enumerate(zip(cores, mesh))]
        return torch.cat([v.to(mesh[0]) for v in vols])

    return synth


# ---------------------------------------------------------------------------
# the 2-D (data × model) mesh
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Mesh2D:
    """``dp`` rows (the data axis) of ``mp`` devices (the model axis);
    rank ``d * mp + m`` runs on ``devices[d][m]``."""

    devices: Tuple[Tuple[torch.device, ...], ...]

    @property
    def dp(self) -> int:
        return len(self.devices)

    @property
    def mp(self) -> int:
        return len(self.devices[0])

    @property
    def shape(self) -> Dict[str, int]:
        return {DATA_AXIS: self.dp, MODEL_AXIS: self.mp}

    @property
    def flat(self) -> List[torch.device]:
        return [d for row in self.devices for d in row]


def create_mesh_2d(devices: Optional[Sequence] = None,
                   dp: Optional[int] = None, mp: int = 1) -> Mesh2D:
    """The ``dp`` × ``mp`` mesh of ``devices`` (default: as
    ``create_mesh``); ``dp`` defaults to ``len(devices) // mp``.
    Raises JAX's ValueError when ``dp * mp`` is not the device count."""
    devices = create_mesh(devices)
    if dp is None:
        dp = len(devices) // mp
    if dp * mp != len(devices):
        raise ValueError(f"dp*mp = {dp}*{mp} != {len(devices)} devices")
    return Mesh2D(tuple(tuple(devices[d * mp:(d + 1) * mp])
                        for d in range(dp)))


def _sharded_layers(model, mp: int):
    """(parameter name, module) of every conv whose kernel splits over
    ``mp`` ranks: JAX's ``_param_spec`` (a 4-D kernel whose output
    channels divide by ``mp`` and number at least ``mp``) on the port's
    layouts, where a ``Conv``'s output channels are dim 0 and a
    ``ConvTranspose``'s dim 1."""
    from ..models.acai import Conv, ConvTranspose

    for prefix, mod in model.named_modules():
        if isinstance(mod, (Conv, ConvTranspose)):
            c = mod.weight.shape[mod.out_dim] * mod.model_shards
            if c % mp == 0 and c >= mp:
                yield f"{prefix}.weight" if prefix else "weight", mod


def state_sharding_2d(mesh: Mesh2D, state) -> Dict[str, Optional[int]]:
    """The partition of a train state on ``mesh``: each parameter's name
    with the dim split over the model axis, or None where it is
    replicated. An Adam moment is split as its parameter is; BatchNorm
    statistics and the counts are replicated."""
    split = {name: mod.out_dim
             for name, mod in _sharded_layers(state.model, mesh.mp)}
    return {name: split.get(name) for name, _ in
            state.model.named_parameters()}


def _adam_states(state):
    opt = state.opt_state
    return list(opt.values()) if isinstance(opt, dict) else [opt]


def _optimizers(tx):
    return list(tx.groups.values()) if hasattr(tx, "groups") else [tx]


def _kernel_and_moments(state, name: str, mod) -> List[torch.Tensor]:
    return [mod.weight] + [moments[name] for adam in _adam_states(state)
                           for moments in (adam.mu, adam.nu)
                           if name in moments]


@torch.no_grad()
def shard_state_2d(mesh: Mesh2D, state):
    """Place ``state`` by the 2-D partition rule, in place: rank 0's
    parameters, statistics and moments on every rank (broadcast), then
    each split kernel and its moments cut to this rank's block of
    output channels; the optimizer's norm then spans the model group.
    Returns ``state``."""
    if any(tx.model_sharded is not None for tx in _optimizers(state.tx)):
        raise ValueError("the state is already placed on a 2-D mesh")
    distributed.mesh_groups(mesh.dp, mesh.mp)
    tensors = list(state.model.state_dict().values())
    for adam in _adam_states(state):
        tensors += list(adam.mu.values()) + list(adam.nu.values())
    for t in tensors:
        dist.broadcast(t, src=0)
    m = distributed.process_index() % mesh.mp
    layers = list(_sharded_layers(state.model, mesh.mp)) if mesh.mp > 1 else []
    for name, mod in layers:
        c = mod.weight.shape[mod.out_dim] // mesh.mp
        for t in _kernel_and_moments(state, name, mod):
            t.data = t.narrow(mod.out_dim, m * c, c).clone()
        mod.model_shards = mesh.mp
    for tx in _optimizers(state.tx):
        tx.model_sharded = frozenset(name for name, _ in layers)
    return state


@torch.no_grad()
def gather_state_2d(mesh: Mesh2D, state):
    """The whole train state of a state placed by ``shard_state_2d`` (a
    copy; ``state`` is unchanged): every split kernel and its moments
    gathered over this rank's model group. Collective over the group;
    JAX's ``jax.device_get`` of a sharded state."""
    from ..models.acai import Conv, ConvTranspose

    full = copy.deepcopy(state)
    for prefix, mod in full.model.named_modules():
        if isinstance(mod, (Conv, ConvTranspose)) and mod.model_shards > 1:
            _, group = distributed.mesh_groups(mesh.dp, mesh.mp)
            name = f"{prefix}.weight" if prefix else "weight"
            for t in _kernel_and_moments(full, name, mod):
                t.data = distributed.gather_shards(t, mod.out_dim, group)
            del mod.model_shards
    for tx in _optimizers(full.tx):
        tx.model_sharded = None
    return full


def make_sharded_train_step_2d(loss_config, lpips_params, mesh: Mesh2D):
    """``step(state, batch, mix_weight) → (state, metrics)`` of
    ``train.steps.make_train_step`` on one rank of a ``mesh.dp`` ×
    ``mesh.mp`` group: ``batch`` is the global batch, its noise
    included, of which the rank takes its data row's rows; ``state`` is
    placed by ``shard_state_2d`` (at the first call when it is not yet).
    The losses, BatchNorm statistics and gradients reduce over the data
    group, the split convs gather over the model group and the
    replicated parameters' gradients are averaged over it; the step is
    the single-process step on the global batch."""
    from ..train.steps import make_train_step

    base = make_train_step(loss_config, lpips_params)

    def step(state, batch, mix_weight):
        data, model = distributed.mesh_groups(mesh.dp, mesh.mp)
        if _optimizers(state.tx)[0].model_sharded is None:
            shard_state_2d(mesh, state)
        rank = distributed.process_index()
        rows = distributed.global_batch_from_host(batch, rank // mesh.mp,
                                                  mesh.dp)
        local = {k: v.to(mesh.flat[rank], non_blocking=True)
                 for k, v in rows.items()}
        with distributed.reducing_over(data), \
                distributed.sharding_over(model):
            return base(state, local, mix_weight)

    return step
