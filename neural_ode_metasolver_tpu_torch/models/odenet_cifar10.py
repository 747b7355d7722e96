"""CIFAR-10 MetaNODE family: metanode4..34 / premetanode4..34 (port of
models/odenet_cifar10.py).

Architecture (reference odenet_cifar10/layers.py:317-426):

  conv1 (3 -> in_planes, k3 s1 p1, no bias, param-normed) -> act(bn1) -> up
  to 4 MetaLayers (strides 1,2,2,2; widths x1,2,4,8; each = res blocks then
  meta-ODE blocks) -> global average pool -> Linear

  BasicBlock     conv-norm-act, conv-norm, + shortcut (conv-norm), act
  PreBasicBlock  norm-act-conv x2 + conv shortcut
  BasicBlock2    (ODE RHS) conv-norm-act x2; ignores t
  PreBasicBlock2 (ODE RHS) norm-act-conv x2; ignores t

Norms BN/GN/LN/IN/NF, param norms SN/WN/PNF and activations are set per
slot (resblock, odeblock, bn1), as in JAX.  ``is_odenet=False`` takes the
registry's ResNet block counts.  ``faithful_preact_bug=True`` (the default,
every published checkpoint) runs act(bn1(conv1(x))) up front; False gives
the prebasic family the intended pre-activation order: bn1, sized for the
final width, and its act after the last layer (JAX ``:405-410``,
``:458-491``).

The model state (BN running statistics, SN power-iteration vectors) is a
tree beside the parameters, with the JAX state tree's names and its None
leaves left out.  ``apply_cifar`` reads it and, in train mode, returns the
new one (``aux["model_state"]``) and mutates nothing: the train step
commits it.  Eval mode reads the running statistics and iterates no SN
vector.  BN inside the ODE RHS normalizes with the batch's statistics and
updates no state; SN materializes once per block forward, not once per
RHS call (JAX ``:196-219``).

Dispatch (``use_kernels=True``):
  * every stride-1 3x3 conv, inside the ODE RHS and out, goes to kernel B1
    (``ops.conv3x3.conv3x3_same``, whose backward is B1's dgrad and the
    wgrad kernel); other convs use ``F.conv2d``;
  * every GN, LN and IN goes to kernel B3 (``ops.group_norm``), with the
    activation after it fused where B3 has it, its backward B3's backward
    kernel; BN is plain arithmetic;
  * every GeLUpoly activation B3 does not fuse, in f32 or bf16, goes to the
    GeLUpoly kernels (``ops.gelu_poly``), one launch each way;
  * an ODE block goes to kernel B2 (``ops.ode_block.ode_block_rk2_forward``)
    when its RHS is the NF/PNF/exact-GeLU PreBasicBlock2 (B2 computes the
    pre-activation RHS; the basic family's RHS activates after its convs),
    the solver list is one rk2 solver with n_steps set, in standalone
    mode, no ss-loss is asked for, and no gradient can flow: B2, like the
    Pallas kernel, has no backward.  Otherwise it takes the generic
    ``meta_integrate`` over the torch RHS; with ``integration_method=
    "adjoint"`` its gradient is the continuous adjoint's over the block's
    materialized params ``p_eff`` (SN/WN's take it back to the raw params
    through autograd), whose forward stores the grid states and so does not
    run on B2.
``use_kernels=False`` takes the generic path with the plain versions
everywhere: the plain path the kernels are checked against on the card.

A fleet (``training/fleet.py``) runs S members in one forward: params and
model state with a leading member axis, x (S, N, 32, 32, 3), stacked
solvers (u (S,)), logits (S, N, classes).  Every layer takes its members'
path (``models/nn.py``): B1 and B3 member-batched, other convs grouped,
BN's statistics per member, SN/WN per member's kernel.  B2 has no member
axis: a fleet's no-grad standalone forward launches it once per member.
Under switch and ensemble ``generator`` is a list of the members' CPU
generators, each member drawing once per ODE block from its own, and the
ss-loss pass replays each member's draws (``ops/regimes.py``).

The ss-loss (JAX ``:372-385``): each ODE block's output re-integrated over
t in [1, 2], replaying the forward's regime draws, the batch mean of the L2
norm of the difference reduced in f32.  GPipe over a mesh (``pipeline``)
runs through ``parallel/pipeline.py`` (below).

Parallel axes (``parallel/mesh.py``):
  * ``model`` (tp): the convs and the head run on the kernel's local
    output channels between the conjugate operators of ``models/nn.py``.
    B2 takes whole kernels: the no-grad forward gathers each ODE block's
    two kernels (no gradient) and runs B2 once a block on the replicated
    activations, so it launches what one process does (B1 for the convs
    outside the blocks, on the local channels; B2 once a block).
  * ``sp``: the activations hold this rank's rows of the height; the convs
    take halos (B1 on ``H_local + 2`` rows), GN gathers the rows for B3,
    the pool sums over the axis.  A stride-2 layer whose rows do not halve
    on every rank gathers the rows first, and the net runs whole images
    from there.  B2 has no halo: the no-grad forward gathers a block's
    rows, runs B2 on the whole height and keeps this rank's rows, as GN
    does for B3, so it launches B2 once a block as one process does.
  * ``pp`` (``pipeline``, a ``parallel.PipelineConfig``): a layer whose
    ODE blocks are more than one and a multiple of the stage count runs
    them through GPipe (``_pipeline_ode_blocks``), consecutive blocks
    grouped ``len // S`` a stage; it falls back to the sequential loop,
    as JAX's does, for a single block or an indivisible stack, under the
    ss-loss, under the adjoint, for a batch that does not split into
    microbatches each divisible by the ``batch_axis``, and (the port's
    own) for a fleet, a tp-sharded stack or a trainable solver.  The
    switch and ensemble draws of the pipelined blocks are made up front
    in the sequential loop's order (``ops/regimes.py::draw_regime``) and
    replayed, so a regime chooses the same solvers with and without pp.
    A no-grad exact-GELU NF stack runs B2 per microbatch.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import torch
from torch.utils import _pytree as pytree

from ..ops.ode_block import ode_block_rk2_forward
from ..ops.regimes import SolverOptions, draw_regime, meta_integrate
from ..ops.tableau import validity_eps
from ..parallel.mesh import (active_data_shard, active_spatial, gather,
                             run_spatial, spatial_rows, tp_sharding_of)
from ..parallel.pipeline import pipeline_apply, stack_stage_params
from . import nn as fnn
from .nn import (NormDef, ParamNormDef, batch_norm, make_norm_def,
                 make_param_norm_def)

Params = Dict[str, Any]
State = Dict[str, Any]

__all__ = ["CifarConfig", "init_cifar", "apply_cifar", "MODEL_REGISTRY"]


@dataclass(frozen=True)
class CifarConfig:
    """Architecture configuration (slot order: resblock, odeblock, bn1)."""

    num_blocks: Tuple[Tuple[int, int], ...] = ((1, 1), (1, 1))
    block_type: str = "prebasic"  # 'basic' | 'prebasic'
    num_classes: int = 10
    in_planes: int = 64
    norms: Tuple[str, str, str] = ("NF", "NF", "NF")
    num_gn_groups: int = 32
    param_norms: Tuple[str, str, str] = ("PNF", "PNF", "PNF")
    acts: Tuple[str, str, str] = ("GeLU", "GeLU", "GeLU")
    faithful_preact_bug: bool = True
    is_odenet: bool = True

    def norm_def(self, slot: int) -> NormDef:
        return make_norm_def(self.norms[slot], self.num_gn_groups)

    def pn_def(self, slot: int) -> ParamNormDef:
        return make_param_norm_def(self.param_norms[slot])


def _check_cfg(cfg: CifarConfig) -> None:
    """Raise early on an unknown block type or registry name."""
    if cfg.block_type not in ("basic", "prebasic"):
        raise ValueError(f"unknown block_type {cfg.block_type!r}")
    for slot in range(3):
        cfg.norm_def(slot)
        cfg.pn_def(slot)
        fnn.get_activation(cfg.acts[slot])


def _put(p: Params, s: State, name: str, pair) -> None:
    """Store a layer's (params, state) under ``name``, leaving out None."""
    if pair[0] is not None:
        p[name] = pair[0]
    if pair[1] is not None:
        s[name] = pair[1]


def _get(p, name: str):
    """A layer's params, or None where the layer has none (``p`` a dict or
    the model's ``ModuleDict``)."""
    return p[name] if name in p else None


def _set(s: State, name: str, value) -> None:
    if value is not None:
        s[name] = value


# ------------------------------------------------------- param-norm convs --


def _pn_conv_init(gen: torch.Generator, pn: ParamNormDef, in_ch: int,
                  out_ch: int, k: int):
    return pn.wrap_init(gen, fnn.conv2d_init(gen, in_ch, out_ch, k,
                                             use_bias=False))


def _conv(p_eff: Params, x: torch.Tensor, stride: int, padding: int,
          use_kernels: bool) -> torch.Tensor:
    """A materialized conv: kernel B1 for a stride-1 SAME 3x3 conv without
    bias when ``use_kernels``, else ``F.conv2d``."""
    kernel = p_eff["kernel"]
    if (use_kernels and stride == 1 and padding == 1
            and tuple(kernel.shape[-4:-2]) == (3, 3)
            and "bias" not in p_eff):
        return fnn.conv3x3_b1(x, kernel)  # kernel B1
    return fnn.conv2d(p_eff, x, stride=stride, padding=padding)


def _pn_conv(pn: ParamNormDef, params: Params, st, x: torch.Tensor,
             stride: int, padding: int, train: bool, use_kernels: bool):
    p_eff, st = pn.materialize(params, st, train)
    return _conv(p_eff, x, stride, padding, use_kernels), st


# ------------------------------------------------------------- res blocks --


def _basic_block_init(gen, cfg, in_planes, planes, stride):
    nd, pnd = cfg.norm_def(0), cfg.pn_def(0)
    p: Params = {}
    s: State = {}
    _put(p, s, "conv1", _pn_conv_init(gen, pnd, in_planes, planes, 3))
    _put(p, s, "bn1", nd.init(planes))
    _put(p, s, "conv2", _pn_conv_init(gen, pnd, planes, planes, 3))
    _put(p, s, "bn2", nd.init(planes))
    if stride != 1 or in_planes != planes:
        _put(p, s, "sc_conv", _pn_conv_init(gen, pnd, in_planes, planes, 1))
        _put(p, s, "sc_bn", nd.init(planes))
    return p, s


def _basic_block_apply(cfg, p, s, x, stride, train, use_kernels):
    """BasicBlock (layers.py:46-51): post-activation residual block; the
    shortcut conv has its own norm."""
    nd, pnd, act = cfg.norm_def(0), cfg.pn_def(0), cfg.acts[0]
    s = dict(s)
    out, st = _pn_conv(pnd, p["conv1"], s.get("conv1"), x, stride, 1, train,
                       use_kernels)
    _set(s, "conv1", st)
    out, st = nd.apply(_get(p, "bn1"), s.get("bn1"), out, train, act,
                       use_kernels)
    _set(s, "bn1", st)
    out, st = _pn_conv(pnd, p["conv2"], s.get("conv2"), out, 1, 1, train,
                       use_kernels)
    _set(s, "conv2", st)
    out, st = nd.apply(_get(p, "bn2"), s.get("bn2"), out, train, None,
                       use_kernels)
    _set(s, "bn2", st)
    shortcut = x
    if "sc_conv" in p:
        shortcut, st = _pn_conv(pnd, p["sc_conv"], s.get("sc_conv"), x,
                                stride, 0, train, use_kernels)
        _set(s, "sc_conv", st)
        shortcut, st = nd.apply(_get(p, "sc_bn"), s.get("sc_bn"), shortcut,
                                train, None, use_kernels)
        _set(s, "sc_bn", st)
    return fnn.get_activation(act, use_kernels)(out + shortcut), s


def _pre_block_init(gen, cfg, in_planes, planes, stride):
    nd, pnd = cfg.norm_def(0), cfg.pn_def(0)
    p: Params = {}
    s: State = {}
    _put(p, s, "bn1", nd.init(in_planes))
    _put(p, s, "conv1", _pn_conv_init(gen, pnd, in_planes, planes, 3))
    _put(p, s, "bn2", nd.init(planes))
    _put(p, s, "conv2", _pn_conv_init(gen, pnd, planes, planes, 3))
    if stride != 1 or in_planes != planes:
        _put(p, s, "sc_conv", _pn_conv_init(gen, pnd, in_planes, planes, 1))
    return p, s


def _pre_block_apply(cfg, p, s, x, stride, train, use_kernels):
    """PreBasicBlock (layers.py:77-81): pre-activation residual block."""
    nd, pnd, act = cfg.norm_def(0), cfg.pn_def(0), cfg.acts[0]
    s = dict(s)
    out, st = nd.apply(_get(p, "bn1"), s.get("bn1"), x, train, act,
                       use_kernels)
    _set(s, "bn1", st)
    out, st = _pn_conv(pnd, p["conv1"], s.get("conv1"), out, stride, 1,
                       train, use_kernels)
    _set(s, "conv1", st)
    out, st = nd.apply(_get(p, "bn2"), s.get("bn2"), out, train, act,
                       use_kernels)
    _set(s, "bn2", st)
    out, st = _pn_conv(pnd, p["conv2"], s.get("conv2"), out, 1, 1, train,
                       use_kernels)
    _set(s, "conv2", st)
    shortcut = x
    if "sc_conv" in p:
        shortcut, st = _pn_conv(pnd, p["sc_conv"], s.get("sc_conv"), x,
                                stride, 0, train, use_kernels)
        _set(s, "sc_conv", st)
    return out + shortcut, s


def _resblock_init(gen, cfg, in_planes, planes, stride):
    if cfg.block_type == "basic":
        return _basic_block_init(gen, cfg, in_planes, planes, stride)
    return _pre_block_init(gen, cfg, in_planes, planes, stride)


def _resblock_apply(cfg, p, s, x, stride, train, use_kernels):
    if cfg.block_type == "basic":
        return _basic_block_apply(cfg, p, s, x, stride, train, use_kernels)
    return _pre_block_apply(cfg, p, s, x, stride, train, use_kernels)


# --------------------------------------------------------------- ODE RHS --


def _odefunc_init(gen, cfg, dim):
    nd, pnd = cfg.norm_def(1), cfg.pn_def(1)
    p: Params = {}
    s: State = {}
    _put(p, s, "conv1", _pn_conv_init(gen, pnd, dim, dim, 3))
    _put(p, s, "bn1", nd.init(dim))
    _put(p, s, "conv2", _pn_conv_init(gen, pnd, dim, dim, 3))
    _put(p, s, "bn2", nd.init(dim))
    return p, s


def _rhs_norm(nd: NormDef, params, x, act, use_kernels):
    """A norm (then ``act``) inside the RHS, stateless: BN normalizes with
    the batch's statistics."""
    if nd.kind == "BN":
        return fnn.get_activation(act, use_kernels)(
            batch_norm(params, None, x, True)[0])
    return nd.apply(params, None, x, False, act, use_kernels)[0]


def _materialize_odefunc(cfg, p, s, train):
    """Apply the param-norm once per solve: the effective RHS params and
    the block's new state."""
    pnd = cfg.pn_def(1)
    s = dict(s)
    c1, st = pnd.materialize(p["conv1"], s.get("conv1"), train)
    _set(s, "conv1", st)
    c2, st = pnd.materialize(p["conv2"], s.get("conv2"), train)
    _set(s, "conv2", st)
    return {**p, "conv1": c1, "conv2": c2}, s


def _odefunc_apply(cfg, p_eff, t, x, use_kernels=False, ss_abs=False):
    """The RHS (t is unused: BasicBlock2 and PreBasicBlock2 are
    autonomous); ``ss_abs`` returns |RHS| (the ss-loss's
    ``ss_loss_abs``)."""
    del t
    nd, act = cfg.norm_def(1), cfg.acts[1]
    if cfg.block_type == "basic":  # BasicBlock2 (layers.py:108-121)
        out = _conv(p_eff["conv1"], x, 1, 1, use_kernels)
        out = _rhs_norm(nd, _get(p_eff, "bn1"), out, act, use_kernels)
        out = _conv(p_eff["conv2"], out, 1, 1, use_kernels)
        out = _rhs_norm(nd, _get(p_eff, "bn2"), out, act, use_kernels)
    else:  # PreBasicBlock2 (layers.py:148-161)
        out = _rhs_norm(nd, _get(p_eff, "bn1"), x, act, use_kernels)
        out = _conv(p_eff["conv1"], out, 1, 1, use_kernels)
        out = _rhs_norm(nd, _get(p_eff, "bn2"), out, act, use_kernels)
        out = _conv(p_eff["conv2"], out, 1, 1, use_kernels)
    return out.abs() if ss_abs else out


def _ode_kernel_u(cfg: CifarConfig, solvers, options: SolverOptions
                  ) -> Optional[Union[float, List[float]]]:
    """The clamped u~ when an ODE block of this config goes to kernel B2,
    else None; a fleet's stacked solver gives one per member.  B2 computes
    conv2(gelu(conv1(gelu(y)))): the prebasic RHS with NF, PNF and the
    exact GeLU, and no other."""
    if cfg.block_type != "prebasic" or (
            cfg.norms[1], cfg.param_norms[1], cfg.acts[1]) != (
                "NF", "PNF", "GeLU"):
        return None
    if options.solver_mode != "standalone" or len(solvers) != 1:
        return None
    s = solvers[0]
    # B2 runs n_steps uniform steps; a custom grid takes precedence over them
    if (s.method != "rk2" or s.custom_grid is not None or s.n_steps is None
            or s.step_size is not None):
        return None
    if s.u is None or s.u.dim() > 1:
        return None
    # u~ = clip(u, eps, 1), the tableau's c2, from u's values on the host:
    # tolist() runs no aten op, so torch.export reads a number where the
    # tableau's c would be a traced tensor; a fleet's (S,) u gives a list
    eps = validity_eps(s.u.dtype)
    clip = lambda v: min(max(v, eps), 1.0)  # noqa: E731
    u = s.u.tolist()
    return [clip(v) for v in u] if s.u.dim() == 1 else clip(u)


# -------------------------------------------------------------- MetaLayer --


def _meta_layer_init(gen, cfg, planes, num_blocks, stride, in_planes):
    num_res, num_ode = num_blocks
    strides = [stride] + [1] * (num_res + num_ode - 1)
    p: Params = {"res": [], "ode": []}
    s: State = {"res": [], "ode": []}
    cur = in_planes
    for st in strides[:num_res]:
        bp, bs = _resblock_init(gen, cfg, cur, planes, st)
        p["res"].append(bp)
        s["res"].append(bs)
        cur = planes
    for _ in range(num_ode):
        bp, bs = _odefunc_init(gen, cfg, cur)
        p["ode"].append(bp)
        s["ode"].append(bs)
    return p, s, cur


def _grad_can_flow(x: torch.Tensor, p_eff: Params, solvers) -> bool:
    """Whether a gradient can reach x, the block's params or a solver's
    (unfrozen) u/v."""
    return torch.is_grad_enabled() and (
        x.requires_grad
        or any(t.requires_grad for p in p_eff.values() for t in p.values())
        or any(not s.frozen and t is not None and t.requires_grad
               for s in solvers for t in (s.u, s.v)))


def _whole_kernel(kernel: torch.Tensor) -> torch.Tensor:
    """A conv kernel whole: all-gathered (no gradient) where it holds this
    rank's output channels of a ``model`` axis."""
    rule = tp_sharding_of(kernel)
    return kernel if rule is None else rule.gather(kernel)


def _ode_block(cfg, p_eff, x, solvers, options, use_kernels, u_k, remat,
               generator=None, aux_in=None, integration_method="backprop"):
    """One ODE block's solve of x: ``(y, aux)``, kernel B2 where it can
    run (``u_k``, the clamped u~, given and no gradient can flow), else
    ``meta_integrate`` over the torch RHS.  B2 takes whole images and
    whole kernels: under a ``model`` axis the kernels are gathered (the
    activations are whole already), under ``spatial_rows`` the rows are
    gathered and this rank's rows of the result kept."""
    sp = active_spatial()
    if u_k is not None and not _grad_can_flow(x, p_eff, solvers):
        w1 = _whole_kernel(p_eff["conv1"]["kernel"]).to(x.dtype)
        w2 = _whole_kernel(p_eff["conv2"]["kernel"]).to(x.dtype)
        n = solvers[0].n_steps
        xs = x if sp is None else gather(x, sp, -3, sum_grads=False)
        if isinstance(u_k, list):  # a fleet: B2 once per member
            y = torch.stack([ode_block_rk2_forward(xs[m], w1[m], w2[m], u, n)
                             for m, u in enumerate(u_k)])
        else:
            y = ode_block_rk2_forward(xs, w1, w2, u_k, n)  # kernel B2
        if sp is not None:
            y = y[..., sp.rows(y.shape[-3]), :, :].contiguous()
        return y, {}
    rhs = run_spatial(sp, lambda t, y: _odefunc_apply(cfg, p_eff, t, y,
                                                      use_kernels))
    return meta_integrate(
        solvers, rhs, x, options, generator, aux_in=aux_in, remat=remat,
        adjoint=integration_method == "adjoint", rhs_params=p_eff,
        rhs_with_params=run_spatial(sp, lambda pp, t, y: _odefunc_apply(
            cfg, pp, t, y, use_kernels)))


def _pipeline_ode_blocks(cfg, p_effs, auxes, x, solvers, options,
                         use_kernels, u_k, remat, pipeline):
    """Route a layer's same-shape ODE-block stack through GPipe
    (``parallel/pipeline.py``): consecutive blocks grouped ``len(p_effs) //
    stages`` a stage, each block replaying its regime draw ``auxes[j]``,
    so the result equals the sequential loop's up to reduction order."""
    S = pipeline.stages
    per = len(p_effs) // S
    stage = pipeline.mesh.shard(pipeline.axis).index
    grouped = pytree.tree_map(lambda t: t.reshape((S, per) + t.shape[1:]),
                              stack_stage_params(p_effs))
    sp = active_spatial()

    def body(stage_p, x_mb):
        for j in range(per):
            pj = pytree.tree_map(lambda t: t[j], stage_p)  # noqa: B023
            with spatial_rows(sp):
                x_mb, _ = _ode_block(cfg, pj, x_mb, solvers, options,
                                     use_kernels, u_k, remat,
                                     aux_in=auxes[stage * per + j])
        return x_mb

    return pipeline_apply(body, grouped, x, pipeline.mesh,
                          axis=pipeline.axis,
                          n_microbatches=pipeline.microbatches,
                          batch_axis=pipeline.batch_axis)


def _use_pipeline(pipeline, p, x, solvers, ss_loss, integration_method
                  ) -> bool:
    """JAX's ``use_pp`` rule (``odenet_cifar10.py:290-306``), plus the
    port's fleet, tp-sharded stacks and trainable solvers (whose gradient
    would not leave the pipeline's stages), which take the sequential
    loop.  Inside a parallel step x is this rank's rows of the data axis,
    so its microbatches are already a split of the global ones."""
    num_ode = len(p["ode"])
    if (pipeline is None or num_ode <= 1 or num_ode % pipeline.stages
            or ss_loss or integration_method != "backprop" or x.dim() != 4
            or any(tp_sharding_of(bp["conv1"]["kernel"]) is not None
                   for bp in p["ode"])
            or any(not s.frozen and t is not None and t.requires_grad
                   for s in solvers for t in (s.u, s.v))):
        return False
    b, m = x.shape[0], pipeline.microbatches
    if b % m:
        return False
    return (pipeline.batch_axis is None or active_data_shard() is not None
            or (b // m) % pipeline.mesh.shape[pipeline.batch_axis] == 0)


def _meta_layer_apply(cfg, p, s, x, strides, solvers, options, train,
                      use_kernels, remat=False, generator=None,
                      ss_loss=False, ss_loss_abs=False,
                      integration_method="backprop", pipeline=None):
    """The layer's output, new state and ss-loss (0 without
    ``ss_loss``)."""
    s = {k: list(s.get(k) or [{}] * len(p[k])) for k in ("res", "ode")}
    for i, bp in enumerate(p["res"]):
        x, s["res"][i] = _resblock_apply(cfg, bp, s["res"][i], x,
                                         strides[i], train, use_kernels)
    ss_total = torch.zeros((), dtype=x.dtype, device=x.device)
    u_k = (_ode_kernel_u(cfg, solvers, options)
           if use_kernels and not ss_loss else None)
    if _use_pipeline(pipeline, p, x, solvers, ss_loss, integration_method):
        p_effs = []
        for i, bp in enumerate(p["ode"]):
            p_eff, s["ode"][i] = _materialize_odefunc(cfg, bp, s["ode"][i],
                                                      train)
            p_effs.append({k: dict(v) for k, v in p_eff.items()})
        auxes = [draw_regime(solvers, options, generator) for _ in p_effs]
        x = _pipeline_ode_blocks(cfg, p_effs, auxes, x, solvers, options,
                                 use_kernels, u_k, remat, pipeline)
        return x, s, ss_total
    for i, bp in enumerate(p["ode"]):
        p_eff, s["ode"][i] = _materialize_odefunc(cfg, bp, s["ode"][i],
                                                  train)
        x, aux = _ode_block(cfg, p_eff, x, solvers, options, use_kernels,
                            u_k, remat, generator,
                            integration_method=integration_method)
        if ss_loss:
            rhs_ss = run_spatial(active_spatial(), lambda t, y, _p=p_eff:
                                 _odefunc_apply(cfg, _p, t, y, use_kernels,
                                                ss_abs=ss_loss_abs))
            z, _ = meta_integrate(solvers, rhs_ss, x, options, t0=1.0,
                                  t1=2.0, aux_in=aux, remat=remat)
            # f32 reduction: the squared sum over HW*C elements loses
            # mantissa in bf16 (the torch reference reduces in f32)
            # a fleet's x (S, N, ...) gives each member's mean, (S,)
            diff = (z - x).reshape(x.shape[:x.dim() - 3] + (-1,)).float()
            ss_total = ss_total + fnn.row_norm(diff).mean(-1).to(
                ss_total.dtype)
    return x, s, ss_total


# ----------------------------------------------------------------- model --


def _preact(cfg: CifarConfig) -> bool:
    return cfg.block_type == "prebasic" and not cfg.faithful_preact_bug


def init_cifar(cfg: CifarConfig, generator: torch.Generator
               ) -> Tuple[Params, State]:
    """``(params, state)``: nested dicts/lists of tensors with the JAX
    trees' names and layouts, their None leaves left out."""
    _check_cfg(cfg)
    p: Params = {}
    s: State = {}
    _put(p, s, "conv1", _pn_conv_init(generator, cfg.pn_def(2), 3,
                                      cfg.in_planes, 3))
    # the pre-activation order runs bn1 on the final feature map
    bn1_ch = (cfg.in_planes * 2 ** max(len(cfg.num_blocks) - 1, 0)
              if _preact(cfg) else cfg.in_planes)
    _put(p, s, "bn1", cfg.norm_def(2).init(bn1_ch))
    in_planes = cfg.in_planes
    n_features = cfg.in_planes
    for li in range(len(cfg.num_blocks)):
        planes = cfg.in_planes * (2 ** li)
        stride = 1 if li == 0 else 2
        lp, ls, in_planes = _meta_layer_init(
            generator, cfg, planes, cfg.num_blocks[li], stride, in_planes)
        p[f"layer{li + 1}"], s[f"layer{li + 1}"] = lp, ls
        if li >= 1:
            n_features *= 2
    p["fc"] = fnn.linear_init(generator, n_features, cfg.num_classes)
    return p, s


def _layer_strides(cfg: CifarConfig, li: int) -> List[int]:
    num_res, num_ode = cfg.num_blocks[li]
    stride = 1 if li == 0 else 2
    return [stride] + [1] * (num_res + num_ode - 1)


def apply_cifar(
    params: Params,
    x: torch.Tensor,
    solvers: Optional[Sequence] = None,
    solver_options: SolverOptions = SolverOptions(),
    *,
    cfg: CifarConfig = CifarConfig(),
    state: Optional[State] = None,
    use_kernels: bool = True,
    train: bool = False,
    remat: bool = False,
    generator: Optional[torch.Generator] = None,
    ss_loss: bool = False,
    ss_loss_abs: bool = False,
    integration_method: str = "backprop",
    return_aux: bool = False,
    pipeline=None,
) -> Union[torch.Tensor, Tuple[torch.Tensor, Dict[str, Any]]]:
    """Forward of NHWC ``x``; returns the logits in x's dtype, and with
    ``return_aux`` also ``{"ss_loss": ..., "model_state": ...}`` (the
    ss-loss a 0-dim tensor in x's dtype, 0 unless ``ss_loss``; the new
    state, ``state`` itself in eval mode).  ``state`` is the model state
    tree (None: the config has none).  ``train`` selects train mode (BN's
    batch statistics, SN's power iteration); ``remat`` checkpoints each RK
    step of the generic ODE-block path; ``generator`` (a CPU generator; a
    fleet's list of them, one a member) serves the switch and ensemble
    draws; ``integration_method``
    ("backprop" or "adjoint") picks how the ODE blocks are
    differentiated; ``pipeline`` (a ``parallel.PipelineConfig``) runs the
    ODE-block stacks that divide into its stages through GPipe.  Under
    ``spatial_rows`` x is this rank's rows of the height (module
    docstring)."""
    _check_cfg(cfg)
    if integration_method not in ("backprop", "adjoint"):
        raise ValueError(f"unknown integration_method "
                         f"{integration_method!r}")
    if solvers is None and any(n_ode for _, n_ode in cfg.num_blocks):
        raise ValueError("this config integrates ODE blocks: pass "
                         "solvers=[create_solver('rk2', 'u', n_steps=8)]")
    state = {} if state is None else state
    new_state: State = dict(state)
    nd_bn1, pnd_bn1, act_bn1 = cfg.norm_def(2), cfg.pn_def(2), cfg.acts[2]
    preact = _preact(cfg)

    out, st = _pn_conv(pnd_bn1, params["conv1"], state.get("conv1"), x, 1,
                       1, train, use_kernels)
    _set(new_state, "conv1", st)
    if not preact:
        out, st = nd_bn1.apply(_get(params, "bn1"), state.get("bn1"), out,
                               train, act_bn1, use_kernels)
        _set(new_state, "bn1", st)
    ss_total = torch.zeros((), dtype=x.dtype, device=x.device)
    sp = active_spatial()
    for li in range(len(cfg.num_blocks)):
        name = f"layer{li + 1}"
        strides = _layer_strides(cfg, li)
        h = out.shape[-3]
        if sp is not None and strides[0] == 2 and (h % 2 or h < 2):
            # the rows no longer halve on every rank: whole images on
            # (the net's depth) from here
            out = gather(out, sp, -3, sum_grads=True)
            sp = None
        with spatial_rows(sp):
            out, new_state[name], ss = _meta_layer_apply(
                cfg, params[name], state.get(name, {}), out, strides,
                solvers, solver_options, train, use_kernels, remat,
                generator, ss_loss, ss_loss_abs, integration_method,
                pipeline)
        ss_total = ss_total + ss
    with spatial_rows(sp):
        if preact:
            out, st = nd_bn1.apply(_get(params, "bn1"), state.get("bn1"),
                                   out, train, act_bn1, use_kernels)
            _set(new_state, "bn1", st)
        logits = fnn.linear(params["fc"], fnn.global_avg_pool(out))
    if return_aux:
        return logits, {"ss_loss": ss_total, "model_state": new_state}
    return logits


# ------------------------------------------------------------- registry --


def _make_ctor(block_type, ode_blocks, res_blocks):
    def ctor(is_odenet: bool = True, **kw) -> CifarConfig:
        # an explicit num_blocks override replaces the registry counts
        nb = kw.pop("num_blocks", None)
        if nb is None:
            nb = ode_blocks if is_odenet else res_blocks
        return CifarConfig(num_blocks=tuple(tuple(b) for b in nb),
                           block_type=block_type, is_odenet=is_odenet, **kw)

    return ctor


# (res, ode) per stage — odenet_cifar10/layers.py:429-556
_ODE34 = [(1, 2), (1, 3), (1, 5), (1, 2)]
_RES34 = [(3, 0), (4, 0), (6, 0), (3, 0)]
metanode4 = _make_ctor("basic", [(0, 1)], [(1, 0)])
metanode6 = _make_ctor("basic", [(1, 1)], [(2, 0)])
metanode10 = _make_ctor("basic", [(1, 1)] * 2, [(2, 0)] * 2)
metanode18 = _make_ctor("basic", [(1, 1)] * 4, [(2, 0)] * 4)
metanode34 = _make_ctor("basic", _ODE34, _RES34)
premetanode4 = _make_ctor("prebasic", [(0, 1)], [(1, 0)])
premetanode6 = _make_ctor("prebasic", [(1, 1)], [(2, 0)])
premetanode10 = _make_ctor("prebasic", [(1, 1)] * 2, [(2, 0)] * 2)
premetanode18 = _make_ctor("prebasic", [(1, 1)] * 4, [(2, 0)] * 4)
premetanode34 = _make_ctor("prebasic", _ODE34, _RES34)

MODEL_REGISTRY = {
    "metanode4": metanode4,
    "metanode6": metanode6,
    "metanode10": metanode10,
    "metanode18": metanode18,
    "metanode34": metanode34,
    "premetanode4": premetanode4,
    "premetanode6": premetanode6,
    "premetanode10": premetanode10,
    "premetanode18": premetanode18,
    "premetanode34": premetanode34,
}
