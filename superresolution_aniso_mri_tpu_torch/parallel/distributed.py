"""Multi-process start-up, the reductions of a data-parallel train step,
and main-process gating.

Port of ``superresolution_aniso_mri_tpu/parallel/distributed.py`` on
``torch.distributed``: one process (a rank) per device, where JAX runs
one process per host that owns its local chips.

  * ``initialize_distributed`` — JAX's configuration rules, word for
    word: explicit ``coordinator_address`` / ``num_processes`` /
    ``process_id`` first, then ``SR_COORDINATOR_ADDRESS`` /
    ``SR_NUM_PROCESSES`` / ``SR_PROCESS_ID``; ``num_processes <= 1`` is a
    no-op; a partial configuration, or a missing process id, raises
    ValueError. A process of JAX's count is a host here: it records the
    cluster (``cluster()``), and ``launch`` starts its ranks with global
    ranks ``process_id * local + i``. ``SR_MULTIHOST=auto`` joins torch's
    ``env://`` rendezvous instead (one rank per process, as ``torchrun``
    starts them), the counterpart of JAX's cluster discovery;
  * ``launch`` — run a function on one rank per entry of a device list
    (spawned processes, one process group over ``nccl`` for CUDA devices
    or ``gloo`` for the CPU); two ranks may share a device, as tests and
    the card's smoke run place them on ``[cpu, cpu]`` or ``[cuda:0,
    cuda:0]`` (over gloo: NCCL refuses two ranks on one GPU);
  * ``process_count`` / ``process_index`` / ``is_main_process`` — rank
    0 owns the filesystem side effects;
  * ``global_batch_from_host`` — every rank draws the SAME global batch
    from the same seeds (JAX's design, so that N ranks compute what one
    process computes on the global batch) and keeps its own rows; pairs
    stay whole: a ``[2B]`` leaf (``from ∥ to``) gives the rank matching
    blocks of both halves;
  * ``reducing_over`` / ``global_sum`` / ``global_mean`` /
    ``average_gradients`` — inside a sharded train step every batch
    reduction of the losses and of train-mode BatchNorm runs over the
    group (a differentiable all-reduce), so each loss term and each
    statistic is its global value, and the gradient is the global
    gradient. Outside the step they are the single-process arithmetic,
    unchanged.
"""
from __future__ import annotations

import contextlib
import contextvars
import datetime
import os
import socket
import time
from typing import Callable, Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

# a multi-host configuration recorded by ``initialize_distributed``:
# (coordinator "host:port", number of hosts, this host's index)
_CLUSTER: Optional[tuple] = None
# this rank's launch: the devices of its host's ranks, in local order
_LOCAL_DEVICES: Optional[List[torch.device]] = None
# the process group of the running sharded train step (None: one process)
_STEP_GROUP = contextvars.ContextVar("sr_step_group", default=None)
# the model group of the running 2-D step: (group, this rank's index in
# it, its size); None outside one
_MODEL_GROUP = contextvars.ContextVar("sr_model_group", default=None)
# the data and model groups of this rank per (dp, mp), made once per
# process group (``dist.new_group`` is collective)
_MESH_GROUPS: Dict[tuple, tuple] = {}

DEFAULT_TIMEOUT_S = 1800.0


def as_device(d) -> torch.device:
    """``d`` as a ``torch.device``; a CUDA device without an index is the
    current one."""
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return d


def backend_for(devices: Sequence) -> str:
    """``nccl`` when the ranks' devices are CUDA devices (one GPU per
    rank), ``gloo`` for the CPU."""
    return ("nccl" if all(torch.device(d).type == "cuda" for d in devices)
            else "gloo")


def initialize_distributed(args: Optional[Dict] = None) -> bool:
    """Apply the multi-host configuration of ``args`` or the environment
    (JAX's priority rules); True when this process belongs to a cluster.

    An explicit ``num_processes`` P > 1 with ``coordinator_address`` and
    ``process_id`` records the cluster for ``launch`` (the train CLI
    starts this host's ranks); ``SR_MULTIHOST=auto`` with no explicit
    configuration joins the ``env://`` rendezvous (``MASTER_ADDR``,
    ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``; ``LOCAL_RANK`` picks the
    GPU) with the backend of ``args["device"]``."""
    global _CLUSTER
    if _CLUSTER is not None or _LOCAL_DEVICES is not None:
        return True
    args = args or {}
    coord = (args.get("coordinator_address")
             or os.environ.get("SR_COORDINATOR_ADDRESS"))
    nproc = args.get("num_processes") or os.environ.get("SR_NUM_PROCESSES")
    pid = args.get("process_id")
    if pid is None:
        pid = os.environ.get("SR_PROCESS_ID")
    # explicit flags win over SR_MULTIHOST=auto: every explicit branch,
    # the single-process no-op and the partial-config failure included,
    # is evaluated before the auto fallback
    if nproc is not None and int(nproc) <= 1:
        return False
    # a partial configuration fails fast: N hosts that each thought they
    # were process 0 would race on the shared experiment directory
    if bool(coord) != bool(nproc):
        raise ValueError(
            f"multi-host: incomplete configuration "
            f"(coordinator_address={coord!r}, num_processes={nproc!r}) "
            f"— set both (flags or SR_COORDINATOR_ADDRESS/"
            f"SR_NUM_PROCESSES), or neither for single-process")
    if not coord and not nproc:
        if os.environ.get("SR_MULTIHOST") == "auto":
            _join_env_rendezvous(args.get("device"))
            return True
        return False
    if pid is None:
        raise ValueError(
            "multi-host: coordinator_address and num_processes are set "
            "but process_id is missing (flag --process_id or env "
            "SR_PROCESS_ID)")
    if not 0 <= int(pid) < int(nproc):
        raise ValueError(f"multi-host: process_id {pid} is not in "
                         f"[0, {nproc})")
    _CLUSTER = (str(coord), int(nproc), int(pid))
    return True


def _join_env_rendezvous(device) -> None:
    """One rank per process from the ``env://`` variables."""
    global _LOCAL_DEVICES
    if torch.device(device or "cuda").type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", 0))
        n_local = int(os.environ.get("LOCAL_WORLD_SIZE",
                                     torch.cuda.device_count()))
        torch.cuda.set_device(local)
        _LOCAL_DEVICES = [torch.device("cuda", i) for i in range(n_local)]
    else:
        _LOCAL_DEVICES = [torch.device("cpu")]
    dist.init_process_group(backend_for(_LOCAL_DEVICES[:1]),
                            init_method="env://")


def cluster() -> tuple:
    """(coordinator address or None, hosts, this host's index) of the
    recorded multi-host configuration; (None, 1, 0) on one host."""
    return _CLUSTER if _CLUSTER is not None else (None, 1, 0)


def is_rank() -> bool:
    """True in a process that is a rank of a process group."""
    return dist.is_available() and dist.is_initialized()


def process_count() -> int:
    return dist.get_world_size() if is_rank() else 1


def process_index() -> int:
    return dist.get_rank() if is_rank() else 0


def is_main_process() -> bool:
    """True on the process that owns filesystem side effects."""
    return process_index() == 0


def rank_mesh() -> List[torch.device]:
    """The device of every rank of the group, in rank order: each host's
    ranks hold its local devices in order."""
    if not is_rank() or _LOCAL_DEVICES is None:
        raise RuntimeError("no process group: start the ranks with "
                           "parallel.launch (the train CLI does)")
    n = len(_LOCAL_DEVICES)
    return [_LOCAL_DEVICES[r % n] for r in range(dist.get_world_size())]


def free_port() -> int:
    """A free TCP port on this host for a rendezvous on localhost."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(local: int, fn: Callable, args: tuple, devices: list,
               backend: str, init_method: str, rank_offset: int,
               world_size: int, timeout_s: float) -> None:
    global _LOCAL_DEVICES
    device = devices[local]
    if device.type == "cuda":
        torch.cuda.set_device(device)
    else:
        # the ranks on this host's CPU share its threads
        torch.set_num_threads(max(1, torch.get_num_threads()
                                  // sum(d.type == "cpu" for d in devices)))
    _LOCAL_DEVICES = list(devices)
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank_offset + local,
                            timeout=datetime.timedelta(seconds=timeout_s))
    try:
        fn(*args)
    finally:
        _MESH_GROUPS.clear()
        dist.destroy_process_group()


def launch(fn: Callable, args: tuple, devices: Sequence,
           backend: Optional[str] = None, *,
           init_method: Optional[str] = None, rank_offset: int = 0,
           world_size: Optional[int] = None,
           timeout_s: float = DEFAULT_TIMEOUT_S,
           join_timeout_s: Optional[float] = None) -> None:
    """Run ``fn(*args)`` on one spawned rank per entry of ``devices``
    (rank ``rank_offset + i`` on ``devices[i]``; ``fn`` must be
    importable by name) in one process group of ``world_size`` ranks
    (default ``len(devices)``) over ``backend`` (default
    ``backend_for(devices)``), meeting at ``init_method`` (default
    ``tcp://127.0.0.1:<free port>``). ``timeout_s`` bounds each
    collective; ``join_timeout_s`` (None: no bound) the whole run, after
    which every rank is stopped and TimeoutError raised. A rank that
    fails stops the others and raises here."""
    devices = [as_device(d) for d in devices]
    backend = backend or backend_for(devices)
    world_size = int(world_size or len(devices))
    init_method = init_method or f"tcp://127.0.0.1:{free_port()}"
    ctx = torch.multiprocessing.start_processes(
        _rank_main, args=(fn, args, devices, backend, init_method,
                          int(rank_offset), world_size, float(timeout_s)),
        nprocs=len(devices), join=False, start_method="spawn")
    deadline = (None if join_timeout_s is None
                else time.monotonic() + float(join_timeout_s))
    try:
        while not ctx.join(timeout=1.0):
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError(
                    f"ranks still running after {join_timeout_s} s")
    finally:
        for proc in ctx.processes:
            if proc.is_alive():
                proc.terminate()
            proc.join(timeout=10.0)
            if proc.is_alive():
                proc.kill()


# ---------------------------------------------------------------------------
# the global batch and the reductions of a sharded train step
# ---------------------------------------------------------------------------

def global_batch_from_host(batch: Dict, rank: int, world: int) -> Dict:
    """This rank's rows of the global ``batch`` (the same on every
    rank): a leaf with the batch's pair count B (``slice_between``'s, or
    the first leaf's) on its leading axis gives rows
    ``[rank * B/world, (rank + 1) * B/world)``, a ``[2B]`` leaf
    (``from ∥ to``: ``image``, ``outer``, ``outer2``, ``noise_eps``) the
    same block of each half, so pairs stay whole. B must be divisible by
    ``world``."""
    first = next(iter(batch.values()))
    pairs = int(batch["slice_between"].shape[0] if "slice_between" in batch
                else first.shape[0])
    if pairs % world:
        raise ValueError(f"batch pairs ({pairs}) must be divisible by "
                         f"num_devices ({world})")
    n = pairs // world
    lo, hi = rank * n, (rank + 1) * n
    out = {}
    for key, leaf in batch.items():
        rows = int(leaf.shape[0])
        if rows == pairs:
            out[key] = leaf[lo:hi]
        elif rows == 2 * pairs:
            out[key] = torch.cat([leaf[lo:hi], leaf[pairs + lo:pairs + hi]])
        else:
            raise ValueError(
                f"batch leaf {key!r}: leading axis {rows} is neither the "
                f"batch's pair count {pairs} nor twice it")
    return out


@contextlib.contextmanager
def reducing_over(group):
    """Within the block, ``global_sum`` / ``global_mean`` /
    ``average_gradients`` reduce over ``group`` (a process group, e.g.
    ``dist.group.WORLD``)."""
    token = _STEP_GROUP.set(group)
    try:
        yield
    finally:
        _STEP_GROUP.reset(token)


def in_sharded_step() -> bool:
    """True inside a sharded train step (``reducing_over``)."""
    return _STEP_GROUP.get() is not None


def step_world() -> int:
    """The number of ranks the running step reduces over (1 outside a
    sharded step)."""
    group = _STEP_GROUP.get()
    return 1 if group is None else dist.get_world_size(group)


class _AllReduceSum(torch.autograd.Function):
    """The sum over the group's ranks of a tensor; its gradient is the
    sum over the ranks of the gradients of the sum's copies."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        out = t.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return _AllReduceSum.apply(grad, ctx.group), None


def global_sum(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the ranks of the running sharded step, with the
    gradient of a sum (a differentiable all-reduce); ``t`` itself
    outside one."""
    group = _STEP_GROUP.get()
    if group is None:
        return t
    return _AllReduceSum.apply(t, group)


def global_mean(t: torch.Tensor) -> torch.Tensor:
    """The mean of every element of ``t`` on every rank (equal shards);
    ``t.mean()`` outside a sharded step."""
    group = _STEP_GROUP.get()
    if group is None:
        return t.mean()
    return global_sum(t.sum()) / (t.numel() * dist.get_world_size(group))


def average_gradients(grads: List[torch.Tensor]) -> List[torch.Tensor]:
    """The global gradient from each rank's gradient of the (global)
    loss: their mean over the ranks, all-reduced as flat buffers of at
    most ``device.GROUP_BYTES``; ``grads`` unchanged outside a sharded
    step."""
    group = _STEP_GROUP.get()
    return grads if group is None else _mean_over(grads, group)


def _mean_over(grads: List[torch.Tensor], group) -> List[torch.Tensor]:
    """The mean of ``grads`` over the ranks of ``group``, all-reduced as
    flat buffers of at most ``device.GROUP_BYTES``."""
    from ..device import byte_groups

    world = dist.get_world_size(group)
    if world == 1:
        return list(grads)
    out = list(grads)
    for idx in byte_groups(grads):
        flat = torch.cat([grads[i].reshape(-1) for i in idx])
        dist.all_reduce(flat, group=group)
        flat /= world
        at = 0
        for i in idx:
            n = grads[i].numel()
            out[i] = flat[at:at + n].view_as(grads[i])
            at += n
    return out


# ---------------------------------------------------------------------------
# the model axis of a 2-D (data × model) mesh
# ---------------------------------------------------------------------------

def mesh_groups(dp: int, mp: int) -> tuple:
    """(data group, model group) of this rank on a ``dp`` × ``mp`` mesh
    over the running process group, rank ``d * mp + m`` at (d, m): the
    data group is the ``dp`` ranks of this rank's model index, the model
    group the ``mp`` ranks of its data index. Every rank makes every
    group, in the same order, at its first call (collective)."""
    if not is_rank():
        raise RuntimeError(f"a {dp} x {mp} mesh needs a process group of "
                           f"{dp * mp} ranks: start them with "
                           f"parallel.launch")
    if dist.get_world_size() != dp * mp:
        raise ValueError(f"dp*mp = {dp}*{mp} != {dist.get_world_size()} "
                         f"ranks")
    key = (dp, mp)
    if key not in _MESH_GROUPS:
        d, m = divmod(dist.get_rank(), mp)
        data = [dist.new_group([i * mp + j for i in range(dp)])
                for j in range(mp)]
        model = [dist.new_group([i * mp + j for j in range(mp)])
                 for i in range(dp)]
        _MESH_GROUPS[key] = (data[m], model[d])
    return _MESH_GROUPS[key]


@contextlib.contextmanager
def sharding_over(group):
    """Within the block, the model-sharded layers split their output
    channels over the ranks of ``group`` (a model group of
    ``mesh_groups``)."""
    token = _MODEL_GROUP.set((group, dist.get_rank(group),
                              dist.get_world_size(group)))
    try:
        yield
    finally:
        _MODEL_GROUP.reset(token)


def model_group() -> tuple:
    """(group, index, size) of the running 2-D step's model group."""
    spec = _MODEL_GROUP.get()
    if spec is None:
        raise RuntimeError("a model-sharded layer or optimizer ran outside "
                           "a 2-D train step (parallel.gather_state_2d "
                           "gives the full state)")
    return spec


def _gather(t: torch.Tensor, dim: int, group, index: int,
            size: int) -> torch.Tensor:
    """The full tensor of the ``size`` shards of ``t`` along ``dim``,
    shard ``index`` being ``t``: an all-reduce of a zero-filled buffer
    holding this rank's shard in its place (gloo reduces CUDA tensors
    but does not gather them; adding zeros is exact)."""
    shape = list(t.shape)
    c = shape[dim]
    shape[dim] = c * size
    full = t.new_zeros(shape)
    full.narrow(dim, index * c, c).copy_(t)
    dist.all_reduce(full, group=group)
    return full


class _CopyToModelRanks(torch.autograd.Function):
    """The identity; its gradient is the sum over the model group of the
    ranks' gradients, each of which reaches only the share of the input
    gradient that flows from its own output channels."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _GatherFromModelRanks(torch.autograd.Function):
    """The channels of every rank of the model group, concatenated along
    ``dim``; the gradient of this rank's shard is its slice of the
    incoming gradient, unreduced: what follows the gather is replicated
    over the group, so every rank already holds the whole gradient."""

    @staticmethod
    def forward(ctx, t, dim, group, index, size):
        ctx.dim, ctx.index, ctx.c = dim, index, t.shape[dim]
        return _gather(t, dim, group, index, size)

    @staticmethod
    def backward(ctx, grad):
        return (grad.narrow(ctx.dim, ctx.index * ctx.c, ctx.c).contiguous(),
                None, None, None, None)


def copy_to_model_ranks(x: torch.Tensor) -> torch.Tensor:
    """``x`` (the same on every rank of the model group) as the input of
    a layer whose output channels are split over the group."""
    group, _, _ = model_group()
    return _CopyToModelRanks.apply(x, group)


def gather_from_model_ranks(t: torch.Tensor) -> torch.Tensor:
    """The full NCHW output of a channel-split layer from this rank's
    channels ``t`` (differentiable; see ``_GatherFromModelRanks``)."""
    group, index, size = model_group()
    return _GatherFromModelRanks.apply(t, 1, group, index, size)


@torch.no_grad()
def gather_shards(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The full tensor of the shards of ``t`` held by the ranks of
    ``group`` (in group order), outside any step."""
    return _gather(t, dim, group, dist.get_rank(group),
                   dist.get_world_size(group))


def model_mean(grads: List[torch.Tensor]) -> List[torch.Tensor]:
    """The mean of ``grads`` over the running 2-D step's model group."""
    group, _, _ = model_group()
    return _mean_over(grads, group)


@torch.no_grad()
def model_sum(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the running 2-D step's model group."""
    group, _, _ = model_group()
    out = t.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, group=group)
    return out
