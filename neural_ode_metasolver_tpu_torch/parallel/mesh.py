"""Process mesh and the data, tensor and spatial axes (port of
parallel/mesh.py).

JAX lays one global array over a mesh of devices and lets GSPMD insert the
collectives; PyTorch runs one process per device, each with its own slice
of the work, and the collectives are written out.  Here:

  * ``initialize_distributed`` forms the process group.  Its backend is
    chosen by one rule before the group exists: the ranks first meet in the
    coordinator's TCP store (what ``init_method="tcp://<coordinator>"``
    builds) and tell each other their host and device; NCCL when every rank
    owns a CUDA device of its own, gloo for CPU ranks and for ranks that
    share one card (NCCL refuses two ranks on one device).  The choice is
    logged; nothing tries NCCL and falls back on an error.  gloo takes CUDA
    tensors for ``all_reduce`` and ``all_gather`` (torch 2.11 on an H100;
    it stages them through the host itself); its point-to-point sends
    and receives take CPU tensors, so those go through pinned host
    buffers here.
  * ``make_mesh`` names axes over the ranks in row-major order, as JAX's
    ``make_mesh`` lays devices, and makes each axis's process subgroups
    (and the data x sp group where both exist).  Without a process group it
    covers the one local device.
  * ``batch_sharding``, ``replicated`` and ``host_local_batch_to_global``:
    no global array exists, so the data axis is a rule: rank r keeps its
    contiguous 1/N of each global batch (``Shard.local``), and the global
    batch is the concatenation of the ranks' slices in rank order.
  * ``make_parallel_train_step`` hands the train step its ``StepShards``:
    the step draws at the global batch's shape and keeps its rows, sums one
    flat f32 bucket of the gradients and the metrics over the data (x sp)
    group, and divides it by the group's size (``training/train.py``);
    BatchNorm's statistics are the global batch's while a step runs
    (``data_shard``, read by ``models/nn.py::batch_norm``).
  * The ``model`` axis (tensor parallelism): ``shard_params_tp`` and
    ``shard_opt_state_tp`` keep JAX's name rule and return a tree of
    ``LeafSharding`` rules, the counterpart of JAX's ``NamedSharding``
    tree; ``shard_tree`` / ``gather_tree`` give this rank's slice of a
    global tree and gather it back.  Under ``make_parallel_train_step(
    model_axis=)`` the model's parameters hold this rank's slices of the
    sharded leaves (and the optimizer state the slices of their mirrors),
    each parameter marked with its rule (``tp_sharding_of``), which the
    layers read: a conv or linear whose kernel is marked runs on its local
    output channels between ``replicate_grad`` and an all-gather of the
    channels (``models/nn.py``).
  * The ``sp`` axis (spatial parallelism): the step keeps this rank's rows
    of the input's height and runs under ``spatial_rows``; every conv takes
    a halo of its neighbours' rows (``halo_rows``), and the layers that
    need the whole height (GroupNorm's statistics, the average pool) gather
    or sum over the axis.
  * Two conventions for the backward of a collective, by axis: over
    ``model`` and ``pp`` every rank computes the same loss, so an all-gather
    whose consumer runs alike on every rank takes its slice back
    (``gather(..., sum_grads=False)``); over ``data`` and ``sp`` each rank's
    loss is a term of their mean, so sums all-reduce their gradients and
    all-gathers reduce-scatter them (``sum_grads=True``).
"""
from __future__ import annotations

import contextlib
import logging
import math
import os
import socket
from dataclasses import dataclass
from datetime import timedelta
from typing import (Any, Callable, Dict, Iterator, List, Optional, Sequence,
                    Tuple, Union)

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.utils.weak import WeakIdKeyDictionary

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
    "StepShards",
    "LeafSharding",
    "shard_params_tp",
    "shard_opt_state_tp",
    "shard_tree",
    "gather_tree",
    "tp_sharding_of",
    "shard_state_tp",
    "map_tp_state",
    "tp_global_norm",
    "data_shard",
    "active_data_shard",
    "all_sum",
    "all_sum_replicated",
    "replicate_grad",
    "all_reduce_mean",
    "gather",
    "halo_rows",
    "send_to",
    "recv_from",
    "spatial_rows",
    "active_spatial",
    "run_spatial",
    "barrier",
    "rank",
    "world_size",
    "num_hosts",
]

log = logging.getLogger(__name__)

# how long a rank waits for the others to reach the store or a collective
_TIMEOUT = timedelta(seconds=600)


# every rank's (host, device), as the process group's ranks told them
_DEVICES: List[Tuple[str, str]] = []


def num_hosts() -> int:
    """The number of hosts the process group's ranks run on (1 without a
    group)."""
    return len({h for h, _ in _DEVICES}) or 1


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
    _DEVICES[:] = devices
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
    """This rank's place on one mesh axis (or on several taken together,
    named ``"a+b"``): the axis's ``size``, this rank's ``index`` along it,
    the process ``group`` of the ranks that differ from it only along the
    axis (None for an axis of one rank, which runs no collective), and
    those ranks' global ``ranks`` in index order."""

    axis: str
    size: int
    index: int
    group: Any = None
    ranks: Tuple[int, ...] = ()

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

    def draw(self, fn, local_shape, rows: Optional["Shard"] = None
             ) -> torch.Tensor:
        """``fn(shape)`` drawn at the global batch's shape (the leading
        axis ``size`` times the local one; with ``rows``, the sp axis, the
        height, axis -3, ``rows.size`` times too), this rank's part kept:
        what a sharded draw of one global array gives each shard."""
        shape = [local_shape[0] * self.size] + list(local_shape[1:])
        if rows is not None:
            shape[-3] *= rows.size
        out = fn(tuple(shape))[self.rows(shape[0])]
        if rows is not None:
            out = out[..., rows.rows(shape[-3]), :, :]
        return out


@dataclass(frozen=True)
class GlobalDraws:
    """A generator whose draws are made at the global batch's shape, of
    which this rank keeps its rows (``attacks.uniform_like``) and, with
    ``rows`` (the sp axis), its rows of the height."""

    generator: torch.Generator
    shard: Shard
    rows: Optional[Shard] = None

    def draw(self, fn, local_shape) -> torch.Tensor:
        return self.shard.draw(fn, local_shape, self.rows)


class Mesh:
    """Named axes over the ranks, row-major: rank r sits at the
    coordinates of r in an array of ``shape``.  ``shape`` maps axis names
    to sizes (ordered, as JAX's ``mesh.shape``); ``shard(axis)`` is this
    rank's place on an axis, ``shard((a, b))`` on two taken together
    (the groups ``make_mesh`` made: data x sp)."""

    def __init__(self, shape: Dict[str, int], groups: Dict[Any, Any],
                 rank_: int):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)
        self.size = math.prod(shape.values())
        self.rank = rank_
        self.coords = dict(zip(self.axis_names, np.unravel_index(
            rank_, tuple(shape.values())))) if shape else {}
        self._groups = groups

    def _line(self, axes: Tuple[str, ...]) -> Tuple[Tuple[int, ...], int]:
        """The global ranks that differ from this one only along ``axes``
        (row-major over them) and this rank's index among them."""
        sizes = tuple(self.shape.values())
        ranks = np.arange(self.size).reshape(sizes)
        sel = tuple(slice(None) if a in axes else int(self.coords[a])
                    for a in self.axis_names)
        line = ranks[sel].reshape(-1)
        return tuple(int(r) for r in line), int(
            np.nonzero(line == self.rank)[0][0])

    def shard(self, axis) -> Shard:
        axes = (axis,) if isinstance(axis, str) else tuple(axis)
        for a in axes:
            if a not in self.shape:
                raise ValueError(f"the mesh {self.shape} has no axis {a!r}")
        ranks, index = self._line(axes)
        key = axes[0] if len(axes) == 1 else axes
        group = self._groups.get(key)
        if len(axes) > 1 and len(ranks) > 1 and key not in self._groups:
            raise ValueError(f"the mesh made no group over {axes}")
        return Shard("+".join(axes), len(ranks), index, group, ranks)

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, rank={self.rank})"


def _line_groups(sizes: Tuple[int, ...], axes: Tuple[int, ...], world: int,
                 me: int):
    """The process group of this rank's line along the mesh dims ``axes``
    (None where it holds one rank).  Every rank creates every group, in
    one order, as ``dist.new_group`` requires."""
    size = math.prod(sizes[a] for a in axes)
    if size == 1:
        return None
    if size == world:
        return dist.group.WORLD
    ranks = np.arange(world).reshape(sizes)
    rest = [a for a in range(len(sizes)) if a not in axes]
    lines = np.transpose(ranks, rest + list(axes)).reshape(-1, size)
    mine = None
    for line in lines:
        g = dist.new_group([int(r) for r in line])
        if me in line:
            mine = g
    return mine


def make_mesh(axis_sizes: Dict[str, int]) -> Mesh:
    """Build a mesh from ``{'data': n, 'model': m, ...}`` over the
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
    groups: Dict[Any, Any] = {}
    for a, name in enumerate(names):
        groups[name] = (_line_groups(tuple(sizes), (a,), n, rank())
                        if n > 1 else None)
    if "data" in names and "sp" in names:
        both = (names.index("data"), names.index("sp"))
        groups[("data", "sp")] = (_line_groups(tuple(sizes), both, n,
                                               rank()) if n > 1 else None)
    return Mesh(dict(zip(names, sizes)), groups, rank())


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
    return t if shard.group is None else _all_gather(t, shard, 0)


# ------------------------------------------------ tensor parallelism (tp)

# Param leaf names of the port's layers (models/nn.py): "kernel" for
# conv/linear weights, "bias"/"scale" for additive/multiplicative 1-D
# channel params.  TP sharding is keyed on these names, as JAX's is, so
# unrelated state that merely happens to be divisible never shards.
_TP_WEIGHT_NAMES = frozenset({"kernel"})
_TP_CHANNEL_NAMES = frozenset({"bias", "scale"})


@dataclass(frozen=True)
class LeafSharding:
    """One leaf's tensor-parallel rule, JAX's ``NamedSharding``
    counterpart: ``spec`` has JAX's ``PartitionSpec`` entries (``()``
    replicated, ``(None, None, None, "model")`` a conv kernel's output
    channels), ``shard`` the axis it names.  ``local(t)`` is this rank's
    slice of a global leaf, ``gather(t)`` the global leaf from every
    rank's slice (a collective: every rank of the axis calls it)."""

    spec: Tuple[Optional[str], ...] = ()
    shard: Optional[Shard] = None

    @property
    def dim(self) -> Optional[int]:
        for i, a in enumerate(self.spec):
            if a is not None:
                return i
        return None

    def local(self, t):
        d = self.dim
        if d is None or not isinstance(t, torch.Tensor):
            return t
        per = t.shape[d] // self.shard.size
        return t.narrow(d, self.shard.index * per, per).clone(
            memory_format=torch.contiguous_format)

    def gather(self, t):
        d = self.dim
        if d is None or self.shard.group is None \
                or not isinstance(t, torch.Tensor):
            return t
        return _all_gather(t.detach(), self.shard, d)


_REPLICATED = LeafSharding()


def _leaf_name(path: Tuple) -> str:
    """The leaf's own name: the last path key, or the last component of a
    dotted ``named_parameters`` name."""
    return str(path[-1]).rsplit(".", 1)[-1] if path else ""


def _tp_spec_for(path, leaf, axis: str, size: int) -> Tuple:
    """JAX's rule (``mesh.py:_tp_spec_for``): conv kernels (H, W, I, O)
    and linear kernels (I, O) shard the output dim, 1-D bias/scale their
    only dim, each only where the dim divides the axis; else replicated."""
    name = _leaf_name(path)
    shp = tuple(getattr(leaf, "shape", ()))
    if name in _TP_WEIGHT_NAMES:
        if len(shp) == 4 and shp[3] % size == 0:
            return (None, None, None, axis)
        if len(shp) == 2 and shp[1] % size == 0:
            return (None, axis)
    if name in _TP_CHANNEL_NAMES and len(shp) == 1 and shp[0] % size == 0:
        return (axis,)
    return ()


def _map_tree(fn, tree, path=()):
    """``fn(path, leaf)`` over nested dicts, lists and tuples."""
    if isinstance(tree, dict):
        return {k: _map_tree(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_tree(fn, v, path + (i,))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def shard_params_tp(params, mesh: Mesh, axis: str = "model"):
    """The tensor-parallel rule of every param leaf over ``axis``: a tree
    of ``LeafSharding`` matching ``params`` (a flat dict by
    ``named_parameters`` name, or nested dicts and lists); leaves whose
    name is not a recognized param kind, or that do not split evenly, are
    replicated."""
    shard = mesh.shard(axis)

    def rule(path, leaf):
        spec = _tp_spec_for(path, leaf, axis, shard.size)
        return LeafSharding(spec, shard) if spec else _REPLICATED

    return _map_tree(rule, params)


def _same_structure(a, b) -> bool:
    if isinstance(a, dict) and isinstance(b, dict):
        return a.keys() == b.keys() and all(_same_structure(a[k], b[k])
                                            for k in a)
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        return len(a) == len(b) and all(map(_same_structure, a, b))
    return not isinstance(a, (dict, list, tuple)) \
        and not isinstance(b, (dict, list, tuple))


def shard_opt_state_tp(opt_state, params, mesh: Mesh, axis: str = "model"):
    """The rule of every optimizer-state leaf under tensor parallelism:
    subtrees with the structure of ``params`` (momentum, RMS ``nu``,
    MultiSteps ``acc``) take the param rules by structure; every other
    leaf (counts, schedule state, the backoff's scale) is replicated, with
    no shape sniffing."""
    param_rules = shard_params_tp(params, mesh, axis)

    def walk(node):
        if isinstance(node, (dict, list, tuple)) and _same_structure(
                node, params):
            return param_rules
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v) for v in node)
        return _REPLICATED

    return walk(opt_state)


def _zip_tree(fn, tree, rules):
    if isinstance(rules, LeafSharding):
        return _map_tree(lambda p, v: fn(rules, v), tree)
    if isinstance(tree, dict):
        return {k: _zip_tree(fn, v, rules[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_zip_tree(fn, v, r) for v, r in zip(tree, rules))
    return fn(rules, tree)


def shard_tree(tree, rules):
    """This rank's slice of every leaf of a global ``tree`` under its
    ``rules`` (from ``shard_params_tp`` / ``shard_opt_state_tp``)."""
    return _zip_tree(lambda r, v: r.local(v), tree, rules)


def gather_tree(tree, rules):
    """The global tree from this rank's slices (every rank of the axis
    calls it)."""
    return _zip_tree(lambda r, v: r.gather(v), tree, rules)


# a tensor holding this rank's slice of a tp-sharded leaf -> its rule
_TP_LOCAL = WeakIdKeyDictionary()


def mark_tp(t: torch.Tensor, rule: LeafSharding) -> torch.Tensor:
    """Record that ``t`` is this rank's slice under ``rule``; returns t."""
    if rule.dim is not None:
        _TP_LOCAL[t] = rule
    return t


def tp_sharding_of(t) -> Optional[LeafSharding]:
    """The rule of a tensor that holds this rank's slice of a tp-sharded
    leaf (a sharded parameter, its detached view, a layer's sliced
    effective kernel), else None."""
    return _TP_LOCAL.get(t) if isinstance(t, torch.Tensor) else None


def shard_state_tp(ts, rules) -> None:
    """Make a train state's params this rank's slices under ``rules``
    (a dict by param name), in place: each sharded parameter's data
    becomes its slice and the parameter is marked; each optimizer-state
    mirror (a dict keyed by the param names) gets its slices.  Parameters
    and mirrors already sliced stay, so the call is idempotent."""
    for name, p in ts.params.items():
        rule = rules[name]
        if rule.dim is None or tp_sharding_of(p) is not None:
            continue
        with torch.no_grad():
            p.data = rule.local(p.data)
        mark_tp(p, rule)
    _, opt_state = map_tp_state(
        ts.params, {}, ts.opt_state,
        lambda name, rule, t: (rule.local(t) if isinstance(t, torch.Tensor)
                               and t.shape != ts.params[name].shape else t))
    ts.opt_state.update(opt_state)


def map_tp_state(params: Dict[str, torch.Tensor], values, opt_state,
                 fn: Callable):
    """``(values', opt_state')``: ``fn(name, rule, t)`` applied to each
    entry of ``values`` (a dict by param name) whose parameter in
    ``params`` is tp-marked, and to the same entry of every
    optimizer-state mirror (a dict keyed by the param names); the others
    as they are.  Used to slice a state's mirrors, to gather a state for a
    checkpoint and to slice a global one restored into tp slices."""
    rules = {k: tp_sharding_of(p) for k, p in params.items()}

    def one(d):
        return {k: (fn(k, rules[k], v) if rules.get(k) is not None else v)
                for k, v in d.items()}

    def walk(node):
        if isinstance(node, dict):
            if set(node) == set(params):
                return one(node)
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v) for v in node]
        return node

    return one(values), walk(opt_state)


def tp_global_norm(tensors: Sequence[torch.Tensor],
                   like: Sequence[torch.Tensor]) -> torch.Tensor:
    """The L2 norm of the global tensors of which ``tensors`` hold this
    rank's parts: ``like[i]`` (a parameter) tells whether tensors[i] is a
    tp slice; the slices' squares are summed over their axis (one
    all-reduce per axis), the replicated ones counted once."""
    rep, by_axis = [], {}
    for t, p in zip(tensors, like):
        rule = tp_sharding_of(p)
        sq = t.detach().float().pow(2).sum()
        if rule is None or rule.shard.group is None:
            rep.append(sq)
        else:
            by_axis.setdefault(rule.shard.axis, (rule.shard, []))[1] \
                .append(sq)
    total = torch.stack(rep).sum() if rep else None
    for shard, sqs in by_axis.values():
        part = torch.stack(sqs).sum()
        dist.all_reduce(part, group=shard.group)
        total = part if total is None else total + part
    return total.sqrt()


# ---------------------------------------------------------- the step


@dataclass(frozen=True)
class StepShards:
    """A parallel train step's axes: ``data`` (its rows of the batch),
    ``spatial`` (its rows of the height, or None), ``reduce`` (the data x
    sp group the gradients, the metrics and BatchNorm's statistics sum
    over) and ``model`` (the tp axis, or None)."""

    data: Shard
    spatial: Optional[Shard] = None
    reduce: Optional[Shard] = None
    model: Optional[Shard] = None


def make_parallel_train_step(step_fn, mesh: Mesh, ts_template=None, *,
                             data_axis: str = "data",
                             model_axis: Optional[str] = None,
                             spatial_axis: Optional[str] = None,
                             donate: bool = False,
                             compiler_options: Optional[dict] = None):
    """Wrap ``step(ts, x, y, generator, ...)`` from ``make_train_step``
    (or ``make_solver_train_step``) into the step over the mesh: it takes
    this rank's slice of the global batch (``batch_sharding(mesh).local``)
    at full height and returns the global batch's metrics.

    ``model_axis``: the params and their optimizer mirrors are tensor
    parallel, sharded in place by JAX's name rule at the first call (or
    here, given ``ts_template``), every later state passed re-sharded the
    same way; counts, schedule state and the backoff's scale stay
    replicated.  ``spatial_axis``: the step keeps this rank's rows of the
    input's height, as JAX's ``P(data, sp)`` does, and its gradients and
    metrics sum over data x sp.  ``donate`` and ``compiler_options`` have
    no counterpart (nothing is compiled) and are ignored."""
    del donate, compiler_options
    data = mesh.shard(data_axis)
    sp = mesh.shard(spatial_axis) if spatial_axis is not None else None
    reduce = (mesh.shard((data_axis, spatial_axis))
              if spatial_axis is not None else data)
    tp = mesh.shard(model_axis) if model_axis is not None else None
    plan = StepShards(data, sp, reduce, tp)
    rules: Dict[str, Any] = {}

    def reshard(ts):
        if model_axis is None:
            return
        if not rules:
            rules.update(shard_params_tp(ts.params, mesh, model_axis))
        shard_state_tp(ts, rules)

    if ts_template is not None:
        reshard(ts_template)

    def pstep(ts, x, y, generator, **kw):
        reshard(ts)
        if sp is not None:
            x = x[:, sp.rows(x.shape[1])]
        return step_fn(ts, x, y, generator, shard=plan, **kw)

    pstep.shards = plan
    return pstep


# ----------------------------------------------------------- collectives


_ACTIVE: Optional[Shard] = None
_SPATIAL: Optional[Shard] = None


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


@contextlib.contextmanager
def spatial_rows(shard: Optional[Shard]) -> Iterator[None]:
    """Make ``shard`` (the sp axis) the axis whose rows of the height the
    activations hold while the block runs: convs take halos, the average
    pool and GroupNorm reach over it.  None (or an axis of one rank)
    means whole images."""
    global _SPATIAL
    saved = _SPATIAL
    _SPATIAL = shard if shard is not None and shard.group is not None \
        else None
    try:
        yield
    finally:
        _SPATIAL = saved


def active_spatial() -> Optional[Shard]:
    """The sp axis whose rows the activations hold, or None."""
    return _SPATIAL


def run_spatial(shard: Optional[Shard], fn: Callable) -> Callable:
    """``fn`` run under ``spatial_rows(shard)`` whenever it is called, so a
    re-forward (remat) sees the layout of its first forward."""
    def call(*args, **kw):
        with spatial_rows(shard):
            return fn(*args, **kw)
    return call


def _staged(t: torch.Tensor) -> bool:
    """Whether a send or receive of ``t`` goes through the host (gloo's
    point-to-point operations take CPU tensors)."""
    return t.is_cuda and dist.get_backend() == "gloo"


def _host(t: torch.Tensor) -> torch.Tensor:
    buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    return buf.copy_(t)


def _all_gather(t: torch.Tensor, shard: Shard, dim: int) -> torch.Tensor:
    """The concatenation along ``dim`` of every rank's ``t`` (same shape
    on every rank), in index order; not differentiable."""
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(shard.size)]
    dist.all_gather(parts, t, group=shard.group)
    return torch.cat(parts, dim)


def send_to(t: torch.Tensor, shard: Shard, index: int):
    """Start sending ``t`` to the rank at ``index`` of ``shard``'s axis;
    returns (work, buffer): keep both until ``work.wait()``."""
    t = t.detach().contiguous()
    buf = _host(t) if _staged(t) else t
    return dist.isend(buf, dst=shard.ranks[index], group=shard.group), buf


def recv_from(like: torch.Tensor, shard: Shard, index: int) -> torch.Tensor:
    """Receive a tensor of ``like``'s shape and dtype from the rank at
    ``index`` of ``shard``'s axis, onto ``like``'s device."""
    staged = _staged(like)
    buf = (torch.empty(like.shape, dtype=like.dtype, pin_memory=True)
           if staged else torch.empty_like(
               like, memory_format=torch.contiguous_format))
    dist.recv(buf, src=shard.ranks[index], group=shard.group)
    return buf.to(like.device) if staged else buf


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


class _Gather(torch.autograd.Function):
    """All-gather along ``dim``; the backward takes this rank's slice of
    the gradient, after summing it over the group when ``sum_grads``."""

    @staticmethod
    def forward(ctx, t, shard, dim, sum_grads):
        ctx.shard, ctx.dim, ctx.sum_grads = shard, dim, sum_grads
        ctx.n = t.shape[dim]
        return _all_gather(t, shard, dim)

    @staticmethod
    def backward(ctx, g):
        if ctx.sum_grads:
            g = g.clone(memory_format=torch.contiguous_format)
            dist.all_reduce(g, group=ctx.shard.group)
        g = g.narrow(ctx.dim, ctx.shard.index * ctx.n, ctx.n)
        return g.contiguous(), None, None, None


class _Halo(torch.autograd.Function):
    """x's rows along axis -3 with ``above`` rows of the previous rank's
    last ones before them and ``below`` of the next rank's first ones
    after (zeros at the global edges); the backward sends those rows'
    gradients back, where they add to the rows they came from."""

    @staticmethod
    def forward(ctx, x, shard, above, below):
        ctx.shard, ctx.above, ctx.below = shard, above, below
        i, n = shard.index, shard.size
        h = x.shape[-3]
        if max(above, below) > h:
            raise ValueError(f"a halo of {max(above, below)} rows is more "
                             f"than the {h} rows a rank of the "
                             f"{shard.axis} axis holds")
        rows = lambda a, b: x[..., a:b, :, :]  # noqa: E731
        works = []
        if above and i + 1 < n:
            works.append(send_to(rows(h - above, h), shard, i + 1))
        if below and i > 0:
            works.append(send_to(rows(0, below), shard, i - 1))
        parts = []
        if above:
            like = rows(h - above, h)
            parts.append(recv_from(like, shard, i - 1) if i > 0
                         else torch.zeros_like(like))
        parts.append(x)
        if below:
            like = rows(0, below)
            parts.append(recv_from(like, shard, i + 1) if i + 1 < n
                         else torch.zeros_like(like))
        for w, _ in works:
            w.wait()
        return torch.cat(parts, dim=-3)

    @staticmethod
    def backward(ctx, g):
        shard, above, below = ctx.shard, ctx.above, ctx.below
        i, n = shard.index, shard.size
        h = g.shape[-3] - above - below
        rows = lambda a, b: g[..., a:b, :, :]  # noqa: E731
        works = []
        if above and i > 0:
            works.append(send_to(rows(0, above), shard, i - 1))
        if below and i + 1 < n:
            works.append(send_to(rows(above + h, above + h + below), shard,
                                 i + 1))
        dx = rows(above, above + h).clone(
            memory_format=torch.contiguous_format)
        if above and i + 1 < n:
            dx[..., h - above:, :, :] += recv_from(
                rows(0, above), shard, i + 1)
        if below and i > 0:
            dx[..., :below, :, :] += recv_from(
                rows(above + h, above + h + below), shard, i - 1)
        for w, _ in works:
            w.wait()
        return dx, None, None, None


def all_sum(t: torch.Tensor, shard: Shard) -> torch.Tensor:
    """Differentiable sum over ``shard``'s group, for terms of losses that
    differ by rank (BatchNorm's statistics, the sp axis's pool)."""
    return t if shard.group is None else _AllSum.apply(t, shard.group)


def all_sum_replicated(t: torch.Tensor, shard: Shard) -> torch.Tensor:
    """Differentiable sum over ``shard``'s group whose result feeds a loss
    every rank computes alike (the ensemble's mean probabilities)."""
    return (t if shard.group is None
            else _AllSumReplicated.apply(t, shard.group))


def replicate_grad(t: torch.Tensor, shard: Shard) -> torch.Tensor:
    """``t`` unchanged; its gradient summed over ``shard``'s group (a
    replicated input that each rank uses for its own members or output
    channels)."""
    return t if shard.group is None else _ReplicateGrad.apply(t, shard.group)


def gather(t: torch.Tensor, shard: Shard, dim: int,
           sum_grads: bool) -> torch.Tensor:
    """Differentiable all-gather of every rank's ``t`` along ``dim``.  Its
    gradient is this rank's slice of the incoming one: summed over the
    group first with ``sum_grads`` (the consumer differs by rank, or the
    axis's losses are terms of a mean: data, sp), as it is (every rank
    computes the consumer alike: model, pp)."""
    if shard.group is None:
        return t
    return _Gather.apply(t, shard, dim % t.dim(), sum_grads)


def halo_rows(x: torch.Tensor, shard: Shard, above: int,
              below: int) -> torch.Tensor:
    """x (..., H, W, C), this rank's rows of the sp axis, with ``above``
    rows of the previous rank's before them and ``below`` rows of the
    next's after them (zeros past the global edges), differentiable."""
    if shard.group is None or not (above or below):
        return F.pad(x, (0, 0, 0, 0, above, below)) if above or below else x
    return _Halo.apply(x, shard, above, below)


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
