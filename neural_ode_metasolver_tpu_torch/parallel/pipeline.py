"""Pipeline parallelism (pp): microbatched GPipe over a stack of same-shape
stages, point-to-point sends between the ranks of a mesh axis (port of
parallel/pipeline.py).

For the deep end of the registry (stacks of same-shape ODE blocks, a chain
of MetaODEBlocks at constant width) a ``pp`` mesh axis of S ranks lets
each rank compute 1/S of the blocks while activations flow stage to stage.

Schedule: GPipe fill-drain.  With S stages and M microbatches, stage i
runs microbatch m once stage i-1 has sent it: tick t of the T = M + S - 1
ticks finds stage i at microbatch t - i.  Rank i of the ``pp`` group
computes only stage i; it receives each activation from rank i-1 and
sends its output to rank i+1.  The last stage's outputs are summed over
the axis with zeros from the other ranks (JAX's masked ``psum``), so
every rank of the axis returns them.

Training: ``pipeline_apply`` is one ``torch.autograd.Function``.  Its
forward runs the fill and keeps each microbatch's local graph; its
backward runs the drain in reverse: the last stage takes its share of the
incoming output gradient, every other stage receives its microbatch's from
rank i+1, backpropagates the stored graph and sends the input's gradient
to rank i-1.  It returns the stacked params' gradient (stage i's slot from
rank i, the slots summed over the axis, so every rank holds all of them)
and the input's gradient summed over the axis, of which only stage 0's is
nonzero.  The whole model's params stay on every rank, as JAX's do (its
stage tree is built inside the forward from replicated params, and
``shard_map`` hands each device its stage); without a gradient to take
(eval, ``torch.no_grad``) the same schedule runs with no graph kept.

Constraints (raised): every stage maps activations of one shape to the
same shape (ODE blocks integrate, never reshape), the stacked params'
leading dim is the axis size and the batch divides into
``n_microbatches``.  ``batch_axis`` names the mesh axis the batch is
sharded over: each rank of the port already holds its rows of it, so the
pipeline runs within its data coordinate and needs nothing more.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Optional

import torch
import torch.distributed as dist
from torch.utils import _pytree as pytree

from .mesh import Mesh, Shard, recv_from, send_to

__all__ = ["PipelineConfig", "pipeline_apply", "stack_stage_params"]


@dataclass(frozen=True)
class PipelineConfig:
    """How a model should pipeline its same-shape ODE-block stacks.

    Passed to ``make_cifar_model(cfg, pipeline=...)``: each MetaLayer
    whose ODE-block count is a positive multiple of the ``axis`` size
    routes those blocks through :func:`pipeline_apply` (consecutive blocks
    grouped per stage); other layers fall back to the sequential loop.
    ``n_microbatches=0`` means "= axis size".  ``batch_axis`` is the axis
    the batch is sharded over (pp composed with data parallelism)."""

    mesh: Mesh
    axis: str = "pp"
    n_microbatches: int = 0
    batch_axis: Optional[str] = None

    @property
    def stages(self) -> int:
        return self.mesh.shape[self.axis]

    @property
    def microbatches(self) -> int:
        return self.n_microbatches or self.stages


def stack_stage_params(params_list):
    """Stack per-stage param trees along a new leading 'stage' axis."""
    leaves = [pytree.tree_flatten(p) for p in params_list]
    spec = leaves[0][1]
    stacked = [torch.stack(ls) for ls in zip(*(lv for lv, _ in leaves))]
    return pytree.tree_unflatten(stacked, spec)


def _stage_forward(body, params, x, shard: Shard, M: int, keep: bool,
                   needs_x: bool):
    """Stage ``shard.index``'s share of the fill over x's M microbatches:
    (its outputs, or None off the last stage; the stored graphs)."""
    i, S = shard.index, shard.size
    mbs = x.chunk(M)
    outs: List[torch.Tensor] = []
    saved = []
    works = []
    y = None
    for m in range(M):
        inp = mbs[m] if i == 0 else recv_from(
            mbs[m] if y is None else y, shard, i - 1)
        if keep:
            with torch.enable_grad():
                inp = inp.detach().requires_grad_(needs_x or i > 0)
                y = body(params, inp)
            saved.append((inp, y))
        else:
            y = body(params, inp)
        if i < S - 1:
            works.append(send_to(y, shard, i + 1))
        else:
            outs.append(y.detach())
    for w, _ in works:
        w.wait()
    return (torch.cat(outs) if outs else None), saved


def _broadcast_last(out: Optional[torch.Tensor], like: torch.Tensor,
                    shard: Shard) -> torch.Tensor:
    """The last stage's output on every rank of the axis: a sum over the
    axis of it and the other ranks' zeros (JAX's masked psum)."""
    if out is None:
        out = torch.zeros_like(like)
    out = out.contiguous()
    dist.all_reduce(out, group=shard.group)
    return out


class _Pipeline(torch.autograd.Function):

    @staticmethod
    def forward(ctx, body, spec, shard, M, x, *leaves):
        i = shard.index
        needs_p = [bool(ctx.needs_input_grad[5 + k])
                   for k in range(len(leaves))]
        with torch.enable_grad():
            local = [l[i].detach().requires_grad_(n)
                     for l, n in zip(leaves, needs_p)]
        params = pytree.tree_unflatten(local, spec)
        out, saved = _stage_forward(body, params, x, shard, M, True,
                                    bool(ctx.needs_input_grad[4]))
        ctx.shard, ctx.M, ctx.saved = shard, M, saved
        ctx.local, ctx.needs_p = local, needs_p
        ctx.leaf_shapes = [tuple(l.shape) for l in leaves]
        ctx.x_meta = (x.shape, x.dtype, x.device)
        y_like = saved[-1][1] if saved else x
        return _broadcast_last(out, torch.empty(
            x.shape, dtype=y_like.dtype, device=x.device), shard)

    @staticmethod
    def backward(ctx, g_out):
        shard, M = ctx.shard, ctx.M
        i, S = shard.index, shard.size
        g_mbs = g_out.contiguous().chunk(M)
        want = [p for p, n in zip(ctx.local, ctx.needs_p) if n]
        p_grads = [torch.zeros_like(p) for p in want]
        g_x: List[Optional[torch.Tensor]] = [None] * M
        works = []
        for m in reversed(range(M)):
            inp, y = ctx.saved[m]
            g = g_mbs[m] if i == S - 1 else recv_from(y, shard, i + 1)
            targets = ([inp] if inp.requires_grad else []) + want
            with torch.enable_grad():
                grads = torch.autograd.grad(y, targets, g,
                                            allow_unused=True)
            if inp.requires_grad:
                gi, grads = grads[0], grads[1:]
                if gi is None:
                    gi = torch.zeros_like(inp)
                if i > 0:
                    works.append(send_to(gi, shard, i - 1))
                else:
                    g_x[m] = gi
            for acc, gp in zip(p_grads, grads):
                if gp is not None:
                    acc.add_(gp)
        for w, _ in works:
            w.wait()
        ctx.saved = None
        # one bucket: x's gradient (stage 0's) and every stage's slot of
        # the stacked params' gradient, summed over the axis
        shape, dtype, device = ctx.x_meta
        parts = []
        if ctx.needs_input_grad[4]:
            parts.append(torch.cat(g_x).float() if i == 0 else
                         torch.zeros(shape, dtype=torch.float32,
                                     device=device))
        it = iter(p_grads)
        for shp, n in zip(ctx.leaf_shapes, ctx.needs_p):
            if n:
                full = torch.zeros(shp, dtype=torch.float32, device=device)
                full[i] = next(it)
                parts.append(full)
        flat = torch.cat([p.reshape(-1) for p in parts]) if parts else None
        if flat is not None:
            dist.all_reduce(flat, group=shard.group)
        out, at = [], 0
        for p in parts:
            out.append(flat[at:at + p.numel()].view(p.shape))
            at += p.numel()
        it = iter(out)
        gx = next(it).to(dtype) if ctx.needs_input_grad[4] else None
        leaf_grads = [next(it).to(ctx.local[k].dtype) if n else None
                      for k, n in enumerate(ctx.needs_p)]
        return (None, None, None, None, gx, *leaf_grads)


def pipeline_apply(body: Callable, stacked_params, x: torch.Tensor,
                   mesh: Mesh, *, axis: str = "pp", n_microbatches: int,
                   batch_axis: Optional[str] = None) -> torch.Tensor:
    """Run ``y = body(params_S-1, ... body(params_1, body(params_0, x)))``
    pipelined over the ``axis`` ranks of ``mesh``.

    ``body(stage_params, x_mb) -> y_mb`` must be shape-preserving;
    ``stacked_params`` leaves have leading dim S == mesh.shape[axis]; x's
    batch dim must divide into ``n_microbatches``.  Every rank of the axis
    passes the same x and params and returns the same result as the
    sequential composition over the microbatches, differentiable in x and
    the stacked params.  ``batch_axis`` (module docstring) changes
    nothing in the port."""
    del batch_axis
    shard = mesh.shard(axis)
    S, M = shard.size, n_microbatches
    leaves, spec = pytree.tree_flatten(stacked_params)
    leading = {int(l.shape[0]) for l in leaves}
    if leading != {S}:
        raise ValueError(
            f"stacked_params leading dims {leading} != pp axis size {S}")
    if x.shape[0] % M:
        raise ValueError(f"batch {x.shape[0]} not divisible by {M} "
                         "microbatches")
    if shard.group is None:  # one stage: the microbatches in turn
        params = pytree.tree_unflatten([l[0] for l in leaves], spec)
        return torch.cat([body(params, mb) for mb in x.chunk(M)])
    grad = torch.is_grad_enabled() and (
        x.requires_grad or any(l.requires_grad for l in leaves))
    if not grad:
        params = pytree.tree_unflatten([l[shard.index] for l in leaves],
                                       spec)
        out, _ = _stage_forward(body, params, x, shard, M, False, False)
        return _broadcast_last(out, x, shard)
    return _Pipeline.apply(body, spec, shard, M, x, *leaves)
