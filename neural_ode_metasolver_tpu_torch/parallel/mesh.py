"""Process mesh and data parallelism (port of parallel/mesh.py).

JAX lays one global array over a mesh of devices and lets GSPMD insert the
collectives; PyTorch runs one process per device, each with its own slice
of the work, and the collectives are written out.  Here:

  * ``initialize_distributed`` forms the process group.  Its backend is
    chosen by one rule before the group exists: the ranks first meet in the
    coordinator's TCP store (what ``init_method="tcp://<coordinator>"``
    builds) and tell each other their host and device; NCCL when every rank
    owns a CUDA device of its own, gloo for CPU ranks and for ranks that
    share one card (NCCL refuses two ranks on one device).  The choice is
    logged; nothing tries NCCL and falls back on an error.
  * ``make_mesh`` names axes over the ranks in row-major order, as JAX's
    ``make_mesh`` lays devices, and makes each axis's process subgroups.
    Without a process group it covers the one local device.
  * ``batch_sharding``, ``replicated`` and ``host_local_batch_to_global``:
    no global array exists, so the data axis is a rule: rank r keeps its
    contiguous 1/N of each global batch (``Shard.local``), and the global
    batch is the concatenation of the ranks' slices in rank order.
  * ``make_parallel_train_step`` hands the train step its ``Shard`` of the
    data axis: the step draws at the global batch's shape and keeps its
    rows, sums one flat f32 bucket of the gradients and the metrics over
    the data group, and divides it by the group's size (``training/
    train.py``); BatchNorm's statistics are the global batch's while a
    step runs (``data_shard``, read by ``models/nn.py::batch_norm``).

The tensor-parallel, spatial and pipeline axes (``model``, ``sp``, ``pp``)
are ROADMAP A21: they raise.
"""
from __future__ import annotations

import contextlib
import logging
import math
import os
import socket
from dataclasses import dataclass
from datetime import timedelta
from typing import Any, Dict, Iterator, Optional, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from ..backend import resolve_device

__all__ = [
    "initialize_distributed",
    "choose_backend",
    "Mesh",
    "Shard",
    "GlobalDraws",
    "make_mesh",
    "batch_sharding",
    "replicated",
    "host_local_batch_to_global",
    "make_parallel_train_step",
    "shard_params_tp",
    "shard_opt_state_tp",
    "data_shard",
    "active_data_shard",
    "all_sum",
    "all_sum_replicated",
    "replicate_grad",
    "all_reduce_mean",
    "barrier",
    "rank",
    "world_size",
]

log = logging.getLogger(__name__)

# how long a rank waits for the others to reach the store or a collective
_TIMEOUT = timedelta(seconds=600)


def _a21(what: str):
    return NotImplementedError(f"{what} is not ported yet (ROADMAP A21)")


def rank() -> int:
    """This process's rank; 0 without a process group."""
    return dist.get_rank() if dist.is_initialized() else 0


def world_size() -> int:
    """The process group's size; 1 without one."""
    return dist.get_world_size() if dist.is_initialized() else 1


def choose_backend(devices) -> str:
    """The backend rule: ``devices`` lists every rank's (host, device
    string); NCCL when each is a CUDA device no other rank holds, gloo
    otherwise."""
    cuda = all(d.startswith("cuda") for _, d in devices)
    distinct = len(set(devices)) == len(devices)
    return "nccl" if cuda and distinct else "gloo"


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device: Optional[Union[str, torch.device]] = None,
) -> torch.device:
    """Form the process group; call once per process, before any device
    use.  Returns this rank's device.

    ``coordinator_address`` is ``host:port`` of a free port on rank 0's
    host, the same for every rank.  With ``num_processes`` and
    ``process_id`` omitted they are read from ``WORLD_SIZE`` and ``RANK``
    (as torchrun sets them); the coordinator defaults to
    ``MASTER_ADDR:MASTER_PORT``.  Rank r's device is ``device`` if given,
    else ``cuda:(LOCAL_RANK % device_count)`` (``LOCAL_RANK`` defaults to
    r); without a card and without ``device="cpu"`` it raises."""
    if coordinator_address is None:
        coordinator_address = (f"{os.environ['MASTER_ADDR']}:"
                               f"{os.environ['MASTER_PORT']}")
    if num_processes is None:
        num_processes = int(os.environ["WORLD_SIZE"])
    if process_id is None:
        process_id = int(os.environ["RANK"])
    if device is None:
        local = int(os.environ.get("LOCAL_RANK", process_id))
        device = (f"cuda:{local % torch.cuda.device_count()}"
                  if torch.cuda.is_available() else None)
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    host, port = coordinator_address.rsplit(":", 1)
    store = dist.TCPStore(host, int(port), num_processes,
                          is_master=process_id == 0, timeout=_TIMEOUT)
    me = (socket.gethostname(), str(dev))
    store.set(f"nodems/device/{process_id}", "|".join(me))
    devices = [tuple(store.get(f"nodems/device/{r}").decode().split("|", 1))
               for r in range(num_processes)]
    backend = choose_backend(devices)
    log.info("process group: rank %d of %d on %s, backend %s (devices %s)",
             process_id, num_processes, dev, backend, devices)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, store=store, rank=process_id,
                            world_size=num_processes, timeout=_TIMEOUT)
    return dev


def barrier() -> None:
    """Wait for every rank; nothing without a process group."""
    if world_size() > 1:
        dist.barrier()


# ------------------------------------------------------------------ mesh


@dataclass(frozen=True)
class Shard:
    """This rank's place on one mesh axis: the axis's ``size``, this
    rank's ``index`` along it, and the process ``group`` of the ranks
    that differ from it only along the axis (None for an axis of one
    rank, which runs no collective)."""

    axis: str
    size: int
    index: int
    group: Any = None

    def rows(self, n_global: int) -> slice:
        """This rank's contiguous rows of ``n_global``."""
        if n_global % self.size:
            raise ValueError(
                f"a batch of {n_global} does not split over the {self.axis} "
                f"axis of {self.size}")
        per = n_global // self.size
        return slice(self.index * per, (self.index + 1) * per)

    def local(self, batch):
        """This rank's slice of a global batch: a tensor or array, or a
        tuple or list of them, sliced along the leading axis."""
        if isinstance(batch, (tuple, list)):
            return type(batch)(self.local(b) for b in batch)
        return batch[self.rows(batch.shape[0])]

    def draw(self, fn, local_shape) -> torch.Tensor:
        """``fn(shape)`` drawn at the global batch's shape (the leading
        axis ``size`` times the local one), this rank's rows kept: what a
        sharded draw of one global array gives each shard."""
        shape = (local_shape[0] * self.size,) + tuple(local_shape[1:])
        return fn(shape)[self.rows(shape[0])]


@dataclass(frozen=True)
class GlobalDraws:
    """A generator whose draws are made at the global batch's shape, of
    which this rank keeps its rows (``attacks.uniform_like``)."""

    generator: torch.Generator
    shard: Shard


class Mesh:
    """Named axes over the ranks, row-major: rank r sits at the
    coordinates of r in an array of ``shape``.  ``shape`` maps axis names
    to sizes (ordered, as JAX's ``mesh.shape``); ``shard(axis)`` is this
    rank's place on an axis."""

    def __init__(self, shape: Dict[str, int], groups: Dict[str, Any],
                 rank_: int):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)
        self.size = math.prod(shape.values())
        self.rank = rank_
        self.coords = dict(zip(self.axis_names, np.unravel_index(
            rank_, tuple(shape.values())))) if shape else {}
        self._groups = groups

    def shard(self, axis: str) -> Shard:
        if axis not in self.shape:
            raise ValueError(f"the mesh {self.shape} has no axis {axis!r}")
        return Shard(axis, self.shape[axis], int(self.coords[axis]),
                     self._groups.get(axis))

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, rank={self.rank})"


def _axis_groups(sizes: Tuple[int, ...], world: int, me: int) -> list:
    """For each axis, the process group of this rank's line along it (None
    where the axis has one rank).  Every rank creates every group, in one
    order, as ``dist.new_group`` requires."""
    out = []
    ranks = np.arange(world).reshape(sizes)
    for a, size in enumerate(sizes):
        if size == 1:
            out.append(None)
            continue
        if size == world:
            out.append(dist.group.WORLD)
            continue
        mine = None
        lines = np.moveaxis(ranks, a, -1).reshape(-1, size)
        for line in lines:
            g = dist.new_group([int(r) for r in line])
            if me in line:
                mine = g
        out.append(mine)
    return out


def make_mesh(axis_sizes: Dict[str, int]) -> Mesh:
    """Build a mesh from ``{'data': n, 'ensemble': k, ...}`` over the
    process group's ranks (one process owns one device; without a group,
    the one local device); sizes must multiply to the world size (use -1
    once for 'fill')."""
    n = world_size()
    names = list(axis_sizes.keys())
    sizes = list(axis_sizes.values())
    if -1 in sizes:
        known = int(np.prod([s for s in sizes if s != -1]))
        sizes[sizes.index(-1)] = n // known
    if int(np.prod(sizes)) != n:
        raise ValueError(f"mesh {dict(zip(names, sizes))} != {n} devices")
    groups = (_axis_groups(tuple(sizes), n, rank()) if n > 1
              else [None] * len(sizes))
    return Mesh(dict(zip(names, sizes)), dict(zip(names, groups)), rank())


def batch_sharding(mesh: Mesh, axis: str = "data") -> Shard:
    """The rule that shards the leading (batch) dim over ``axis``: its
    ``local(batch)`` is this rank's contiguous slice."""
    return mesh.shard(axis)


def replicated(mesh: Mesh) -> Shard:
    """The rule that keeps the whole batch on every rank."""
    return Shard("replicated", 1, 0, None)


def host_local_batch_to_global(batch, mesh: Mesh, axis: str = "data"):
    """The global batch from every rank's local slice along ``axis``
    (their concatenation in rank order, gathered over the axis's group);
    a one-rank axis gives its batch back.  ``batch`` is a tensor or a
    tuple or list of them."""
    if isinstance(batch, (tuple, list)):
        return type(batch)(host_local_batch_to_global(b, mesh, axis)
                           for b in batch)
    shard = mesh.shard(axis)
    t = torch.as_tensor(batch)
    if shard.group is None:
        return t
    parts = [torch.empty_like(t) for _ in range(shard.size)]
    dist.all_gather(parts, t.contiguous(), group=shard.group)
    return torch.cat(parts)


def shard_params_tp(params, mesh: Mesh, axis: str = "model"):
    """Tensor-parallel params (ROADMAP A21): raises."""
    raise _a21("tensor parallelism (shard_params_tp)")


def shard_opt_state_tp(opt_state, params, mesh: Mesh, axis: str = "model"):
    """Tensor-parallel optimizer state (ROADMAP A21): raises."""
    raise _a21("tensor parallelism (shard_opt_state_tp)")


def make_parallel_train_step(step_fn, mesh: Mesh, ts_template=None, *,
                             data_axis: str = "data",
                             model_axis: Optional[str] = None,
                             spatial_axis: Optional[str] = None,
                             donate: bool = False,
                             compiler_options: Optional[dict] = None):
    """Wrap ``step(ts, x, y, generator, ...)`` from ``make_train_step``
    (or ``make_solver_train_step``) into the data-parallel step over
    ``data_axis``: it takes this rank's slice of the global batch
    (``batch_sharding(mesh).local``) and returns the state every rank
    holds alike and the global batch's metrics.  ``model_axis`` and
    ``spatial_axis`` are ROADMAP A21; ``donate`` and ``compiler_options``
    have no counterpart (nothing is compiled) and are ignored."""
    del ts_template, donate, compiler_options
    if model_axis is not None:
        raise _a21("tensor parallelism (model_axis)")
    if spatial_axis is not None:
        raise _a21("spatial parallelism (spatial_axis)")
    shard = mesh.shard(data_axis)

    def pstep(ts, x, y, generator, **kw):
        return step_fn(ts, x, y, generator, shard=shard, **kw)

    return pstep


# ----------------------------------------------------------- collectives


_ACTIVE: Optional[Shard] = None


@contextlib.contextmanager
def data_shard(shard: Optional[Shard]) -> Iterator[None]:
    """Make ``shard`` the data axis that train-mode BatchNorm reduces its
    statistics over while the block runs (a step's forwards and their
    backward; a module global, since a CUDA backward runs on autograd's
    own thread).  None or an axis of one rank changes nothing."""
    global _ACTIVE
    saved = _ACTIVE
    _ACTIVE = shard if shard is not None and shard.group is not None \
        else None
    try:
        yield
    finally:
        _ACTIVE = saved


def active_data_shard() -> Optional[Shard]:
    """The data axis of the running step, or None."""
    return _ACTIVE


class _AllSum(torch.autograd.Function):
    """Sum over the group; the backward sums the gradients too: each
    rank's loss differs, and a rank's term reaches every rank's."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        out = t.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _AllSumReplicated(torch.autograd.Function):
    """Sum over the group for a consumer every rank computes alike: the
    gradient of each rank's term is the (replicated) incoming one."""

    @staticmethod
    def forward(ctx, t, group):
        out = t.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


class _ReplicateGrad(torch.autograd.Function):
    """Identity on a replicated input whose users differ by rank: the
    backward sums their gradients over the group."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.group)
        return g, None


def all_sum(t: torch.Tensor, shard: Shard) -> torch.Tensor:
    """Differentiable sum over ``shard``'s group, for terms of losses that
    differ by rank (BatchNorm's statistics)."""
    return t if shard.group is None else _AllSum.apply(t, shard.group)


def all_sum_replicated(t: torch.Tensor, shard: Shard) -> torch.Tensor:
    """Differentiable sum over ``shard``'s group whose result feeds a loss
    every rank computes alike (the ensemble's mean probabilities)."""
    return (t if shard.group is None
            else _AllSumReplicated.apply(t, shard.group))


def replicate_grad(t: torch.Tensor, shard: Shard) -> torch.Tensor:
    """``t`` unchanged; its gradient summed over ``shard``'s group (a
    replicated input that each rank uses for its own members)."""
    return t if shard.group is None else _ReplicateGrad.apply(t, shard.group)


def all_reduce_mean(tensors, shard: Shard):
    """The mean over ``shard``'s group of each tensor, as new f32 tensors
    of the same shapes, in one all-reduce of a flat f32 bucket."""
    tensors = list(tensors)
    if shard.group is None:
        return tensors
    flat = torch.cat([t.detach().reshape(-1).float() for t in tensors])
    dist.all_reduce(flat, group=shard.group)
    flat.div_(shard.size)
    out, at = [], 0
    for t in tensors:
        out.append(flat[at:at + t.numel()].view(t.shape))
        at += t.numel()
    return out
