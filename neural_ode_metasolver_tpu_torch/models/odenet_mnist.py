"""MNIST MetaNODE (port of models/odenet_mnist.py): forward, with the
training options of the JAX ``apply_mnist``.

Architecture (reference odenet_mnist/layers.py:96-209):

  downsampling 'conv': Conv(in,dim,k3,s1) -> GN -> ReLU -> Conv(dim,dim,k4,
                       s2,p1) -> GN -> ReLU -> Conv(dim,dim,k4,s2,p1)
  downsampling 'res':  Conv(in,dim,k3,s1) -> ResBlock(s2) -> ResBlock(s2)
  ODE RHS (ODEfunc):   GN -> act -> ConcatConv2d(t) -> GN -> act ->
                       ConcatConv2d(t) -> GN
  head:                GN -> ReLU -> AvgPool(1,1) -> Flatten -> Linear

GroupNorm takes min(32, C) groups.  ``is_odenet=False`` runs six stride-1
ResBlocks in place of the ODE block.  The ODEfunc's act is ReLU unless
``use_activation_type=True``: the reference builds the requested activation
and runs ReLU anyway (layers.py:139-166), and the default keeps that.

Dispatch (``use_kernels=True``):
  * every GroupNorm goes to kernel B3 (``ops.group_norm``) with the
    activation that follows it fused into the same launch (softplus, which
    B3 does not compute, runs after it);
  * every stride-1 SAME 3x3 conv (the ConcatConv2ds, every ResBlock's conv2,
    the stride-1 ResBlocks' conv1) goes to kernel B1, its bias added after,
    as the Pallas B1 has no bias either;
  * the 3x3 VALID stem, the stride-2 convs and the 1x1 shortcuts use
    ``F.conv2d``, as the JAX package left them to XLA.
``use_kernels=False`` takes the plain versions everywhere.  The ODE block
integrates with the generic ``meta_integrate``: B2 computes the CIFAR
block's RHS, not this one.

Training options (JAX ``apply_mnist``, ``odenet_mnist.py:192-252``):
``train`` is accepted and changes nothing (GroupNorm has no train mode);
``ss_loss`` re-integrates t in [1, 2] from each ODE block's output (with
``|RHS|`` under ``ss_loss_abs``) and adds the batch mean of the f32 L2 norm
of z - x; ``remat`` checkpoints each RK step; ``unroll`` is accepted and
ignored, as the step loop is a Python loop.  With ``return_aux=True`` the
result is ``(logits, {"ss_loss": ...})``, the JAX function's aux (0 when
``ss_loss`` is off).  ``integration_method="adjoint"`` differentiates each
ODE block by the continuous adjoint (``ops/adjoint.py``) over the block's
params; the ss-loss pass backpropagates, as in JAX.

Parallel axes (``parallel/mesh.py``): under a ``model`` axis every conv,
the ConcatConv2ds and the head run on their kernels' local output channels
and GroupNorm's affine is gathered (``models/nn.py``); under
``spatial_rows`` (an ``sp`` axis) the downsampling runs on whole images
(the rows gathered: its VALID stem and 4x4 strided convs do not keep an
even split of the rows), each rank keeps its rows of the 6x6 map where
they split evenly (else whole images on from there), and the ODE block
and the head run on them with halos, B3 on the gathered rows.  The
net has one ODE block, so it has no pipeline.

A fleet (``training/fleet.py``) runs S members in one forward: params
with a leading member axis, x (S, N, 28, 28, C), stacked solvers (u of
shape (S,)), logits (S, N, classes), the ss-loss (S,).  Every layer then
takes its members' path (``models/nn.py``): B1 and B3 member-batched, one
launch for all members; the stem and the strided convs as grouped
``F.conv2d``; the head as ``torch.bmm``; the time channel t per member.
Under switch and ensemble ``generator`` is then a list of the members' CPU
generators: member m draws its switch id or ensemble coin from its own, and
the ss-loss pass replays each member's draw (``ops/regimes.py``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F

from ..ops.regimes import SolverOptions, meta_integrate
from ..parallel.mesh import active_spatial, gather, run_spatial, spatial_rows
from . import nn as fnn

Params = Dict[str, Any]

__all__ = ["MnistConfig", "init_mnist", "apply_mnist"]

_ACT_TYPES = ("tanh", "softplus", "softsign", "relu")


@dataclass(frozen=True)
class MnistConfig:
    downsampling_method: str = "conv"  # 'conv' | 'res'
    is_odenet: bool = True
    activation_type: str = "relu"
    use_activation_type: bool = False  # False = faithful (ReLU always)
    in_channels: int = 1
    dim: int = 64
    num_classes: int = 10


def _check_cfg(cfg: MnistConfig) -> None:
    if cfg.downsampling_method not in ("conv", "res"):
        raise ValueError(f"unknown downsampling_method "
                         f"{cfg.downsampling_method!r}")
    if cfg.use_activation_type and cfg.activation_type not in _ACT_TYPES:
        raise ValueError(f"unknown activation_type {cfg.activation_type!r}")


def _norm_groups(dim: int) -> int:
    return min(32, dim)  # reference norm() (layers.py:208)


def _act(cfg: MnistConfig) -> str:
    return cfg.activation_type if cfg.use_activation_type else "relu"


def _gn_act(params: Params, x: torch.Tensor, act: Optional[str],
            use_kernels: bool) -> torch.Tensor:
    """GroupNorm, then ``act``: one B3 launch."""
    g = _norm_groups(x.shape[-1])
    if act == "softplus":
        return F.softplus(fnn.group_norm(params, x, g,
                                         use_kernels=use_kernels))
    return fnn.group_norm(params, x, g, act=act, use_kernels=use_kernels)


def _conv(params: Params, x: torch.Tensor, stride: int, padding: int,
          use_kernels: bool) -> torch.Tensor:
    kernel = params["kernel"]
    if (use_kernels and stride == 1 and padding == 1
            and tuple(kernel.shape[-4:-2]) == (3, 3)):
        return fnn.conv3x3_b1(x, kernel, params.get("bias"))  # kernel B1
    return fnn.conv2d(params, x, stride=stride, padding=padding)


# ----------------------------------------------------------- sub-modules --


def _odefunc_init(gen: torch.Generator, dim: int) -> Params:
    return {
        "norm1": fnn.group_norm_init(dim),
        "conv1": fnn.conv2d_init(gen, dim + 1, dim, 3),  # ConcatConv2d
        "norm2": fnn.group_norm_init(dim),
        "conv2": fnn.conv2d_init(gen, dim + 1, dim, 3),
        "norm3": fnn.group_norm_init(dim),
    }


def _concat_conv(params: Params, t, x: torch.Tensor,
                 use_kernels: bool) -> torch.Tensor:
    """ConcatConv2d (layers.py:240-253): a constant-t channel first, then
    x, then a 3x3 SAME conv.  A Python float or a host tensor ``t`` is a
    fill on x's device, with no copy of a tensor; a ``t`` that carries a
    gradient (a trainable solver's stage time, u's path through c) or lives
    on the card is broadcast, so neither the gradient nor the host waits.
    A fleet's t (S,) fills member m's channel with t[m].  Under
    ``torch.export`` a host t is a traced value, not a number: the fill
    takes it as a host scalar tensor."""
    shape = x.shape[:-1] + (1,)
    if (isinstance(t, torch.Tensor) and t.dim() == 0
            and t.device.type == "cpu" and torch.compiler.is_exporting()):
        # a traced t is no host number: fill with the host scalar (no
        # copy to the card, no wait for it)
        tt = x.new_empty(shape).fill_(t.to(x.dtype))
    elif isinstance(t, torch.Tensor) and (
            t.requires_grad or t.device.type != "cpu" or t.dim() > 0):
        t = t.reshape(t.shape + (1,) * (len(shape) - t.dim()))
        tt = x.new_zeros(shape) + t.to(device=x.device, dtype=x.dtype)
    else:
        tt = torch.full(shape, float(t), dtype=x.dtype, device=x.device)
    return _conv(params, torch.cat([tt, x], dim=-1), 1, 1, use_kernels)


def _odefunc_apply(params: Params, t, x: torch.Tensor, act: str,
                   use_kernels: bool = True, ss_abs: bool = False
                   ) -> torch.Tensor:
    out = _gn_act(params["norm1"], x, act, use_kernels)
    out = _concat_conv(params["conv1"], t, out, use_kernels)
    out = _gn_act(params["norm2"], out, act, use_kernels)
    out = _concat_conv(params["conv2"], t, out, use_kernels)
    out = _gn_act(params["norm3"], out, None, use_kernels)
    return out.abs() if ss_abs else out


def _resblock_init(gen: torch.Generator, inplanes: int, planes: int,
                   downsample: bool) -> Params:
    p: Params = {
        "norm1": fnn.group_norm_init(inplanes),
        "conv1": fnn.conv2d_init(gen, inplanes, planes, 3, use_bias=False),
        "norm2": fnn.group_norm_init(planes),
        "conv2": fnn.conv2d_init(gen, planes, planes, 3, use_bias=False),
    }
    if downsample:
        p["downsample"] = fnn.conv2d_init(gen, inplanes, planes, 1,
                                          use_bias=False)
    return p


def _resblock_apply(params: Params, x: torch.Tensor, stride: int,
                    use_kernels: bool) -> torch.Tensor:
    """MNIST ResBlock (layers.py:212-237): pre-activation, the shortcut
    conv on the activated tensor."""
    out = _gn_act(params["norm1"], x, "relu", use_kernels)
    shortcut = x
    if "downsample" in params:
        shortcut = fnn.conv2d(params["downsample"], out, stride=stride)
    out = _conv(params["conv1"], out, stride, 1, use_kernels)
    out = _gn_act(params["norm2"], out, "relu", use_kernels)
    out = _conv(params["conv2"], out, 1, 1, use_kernels)
    return out + shortcut


# ----------------------------------------------------------------- model --


def init_mnist(cfg: MnistConfig, generator: torch.Generator) -> Params:
    """Parameters as nested dicts/lists of tensors, with the JAX tree's
    names and layouts."""
    _check_cfg(cfg)
    dim = cfg.dim
    params: Params = {"down": {
        "conv0": fnn.conv2d_init(generator, cfg.in_channels, dim, 3)}}
    if cfg.downsampling_method == "conv":
        params["down"].update({
            "norm0": fnn.group_norm_init(dim),
            "conv1": fnn.conv2d_init(generator, dim, dim, 4),
            "norm1": fnn.group_norm_init(dim),
            "conv2": fnn.conv2d_init(generator, dim, dim, 4),
        })
    else:
        params["down"]["res1"] = _resblock_init(generator, dim, dim, True)
        params["down"]["res2"] = _resblock_init(generator, dim, dim, True)
    if cfg.is_odenet:
        params["blocks"] = [_odefunc_init(generator, dim)]
    else:
        params["blocks"] = [_resblock_init(generator, dim, dim, False)
                            for _ in range(6)]
    params["head"] = {
        "norm": fnn.group_norm_init(dim),
        "fc": fnn.linear_init(generator, dim, cfg.num_classes),
    }
    return params


def _downsample(params: Params, x: torch.Tensor, cfg: MnistConfig,
                use_kernels: bool) -> torch.Tensor:
    d = params["down"]
    x = fnn.conv2d(d["conv0"], x, stride=1, padding=0)
    if cfg.downsampling_method == "conv":
        x = _gn_act(d["norm0"], x, "relu", use_kernels)
        x = fnn.conv2d(d["conv1"], x, stride=2, padding=1)
        x = _gn_act(d["norm1"], x, "relu", use_kernels)
        return fnn.conv2d(d["conv2"], x, stride=2, padding=1)
    x = _resblock_apply(d["res1"], x, 2, use_kernels)
    return _resblock_apply(d["res2"], x, 2, use_kernels)


def apply_mnist(
    params: Params,
    x: torch.Tensor,
    solvers: Optional[Sequence] = None,
    solver_options: SolverOptions = SolverOptions(),
    *,
    cfg: MnistConfig = MnistConfig(),
    use_kernels: bool = True,
    train: bool = False,
    ss_loss: bool = False,
    ss_loss_abs: bool = False,
    remat: bool = False,
    unroll: int = 1,
    integration_method: str = "backprop",
    return_aux: bool = False,
    generator: Optional[torch.Generator] = None,
    state: Optional[Dict[str, Any]] = None,
) -> Union[torch.Tensor, Tuple[torch.Tensor, Dict[str, Any]]]:
    """Forward of NHWC ``x`` (a fleet's (S, N, H, W, C) with members'
    params and solvers); returns the logits in x's dtype, and with
    ``return_aux`` also ``{"ss_loss": ..., "model_state": {}}`` (the
    ss-loss a 0-dim tensor in x's dtype; the net keeps no model state, so
    ``state`` is ignored, as JAX's adapter threads an empty one).
    ``generator`` (a CPU generator; a fleet's list of them, one a member)
    serves the switch and ensemble regimes one draw per ODE block."""
    del train, unroll, state
    _check_cfg(cfg)
    if integration_method not in ("backprop", "adjoint"):
        raise ValueError(f"unknown integration_method "
                         f"{integration_method!r}")
    if cfg.is_odenet and solvers is None:
        raise ValueError("this config integrates an ODE block: pass "
                         "solvers=[create_solver('rk2', 'u', n_steps=8)]")
    act = _act(cfg)
    sp = active_spatial()
    if sp is not None:
        # the downsampling runs on whole images (its 3x3 VALID stem and
        # 4x4 strided convs do not keep the rows' split), then this rank
        # keeps its rows of the 6x6 map where they split evenly
        x = gather(x, sp, -3, sum_grads=True)
    with spatial_rows(None):
        x = _downsample(params, x, cfg, use_kernels)
    if sp is not None:
        h = x.shape[-3]
        if h % sp.size:
            sp = None
        else:
            x = x[:, sp.rows(h)].contiguous()
    ss_total = torch.zeros((), dtype=x.dtype, device=x.device)
    with spatial_rows(sp):
        for block in params["blocks"]:
            if not cfg.is_odenet:
                x = _resblock_apply(block, x, 1, use_kernels)
                continue
            rhs = run_spatial(sp, lambda t, y, _p=block: _odefunc_apply(
                _p, t, y, act, use_kernels))
            x, aux = meta_integrate(
                solvers, rhs, x, solver_options, generator, remat=remat,
                adjoint=integration_method == "adjoint", rhs_params=block,
                rhs_with_params=run_spatial(sp, lambda p, t, y:
                                            _odefunc_apply(p, t, y, act,
                                                           use_kernels)))
            if ss_loss:
                # re-integrate t in [1, 2] from the block output, replaying
                # the forward's regime draws (layers.py:53-93)
                rhs_ss = run_spatial(sp, lambda t, y, _p=block:
                                     _odefunc_apply(_p, t, y, act,
                                                    use_kernels,
                                                    ss_abs=ss_loss_abs))
                z, _ = meta_integrate(solvers, rhs_ss, x, solver_options,
                                      t0=1.0, t1=2.0, aux_in=aux,
                                      remat=remat)
                # a fleet's x (S, N, ...) gives each member's mean, (S,)
                diff = (z - x).reshape(x.shape[:x.dim() - 3] + (-1,)) \
                    .float()
                ss_total = ss_total + fnn.row_norm(diff).mean(-1).to(
                    ss_total.dtype)
        h = params["head"]
        x = _gn_act(h["norm"], x, "relu", use_kernels)
        logits = fnn.linear(h["fc"], fnn.global_avg_pool(x))
    if return_aux:
        return logits, {"ss_loss": ss_total, "model_state": {}}
    return logits
