"""CIFAR-10 pre-activation MetaNODEs (port of models/odenet_cifar10.py).

Architecture (reference odenet_cifar10/layers.py:317-426):

  conv1 (3 -> in_planes, k3 s1 p1, no bias) -> act(bn1) -> up to 4
  MetaLayers (strides 1,2,2,2; widths x1,2,4,8; each = PreBasicBlocks then
  meta-ODE blocks) -> global average pool -> Linear

This port covers the forward of the ``prebasic`` ODE-net family
(premetanode4..34) with NF norms and PNF param-norms, in every regime
(a ``generator`` serves switch and ensemble one draw per ODE block), in
eval and train mode (the same function for these norms, as in JAX), with
the ss-loss (JAX ``odenet_cifar10.py:372-385``: each ODE block's output
re-integrated over t in [1, 2], replaying the forward's regime draws, the
batch mean of the L2 norm of the difference reduced in f32), and
differentiable end to end.  It runs act(bn1(conv1(x))) up front, as the
JAX package's default ``faithful_preact_bug=True`` and every published
checkpoint do.  The ``basic`` family, the ResNet block counts
(``is_odenet=False``), the ``faithful_preact_bug=False`` order and other
norms land with ROADMAP A11.

Dispatch (``use_kernels=True``):
  * every stride-1 3x3 conv, inside the ODE RHS and out, goes to kernel B1
    (``ops.conv3x3.conv3x3_same``, whose backward is B1's dgrad and the
    wgrad kernel); other convs use ``F.conv2d``;
  * an ODE block goes to kernel B2 (``ops.ode_block.ode_block_rk2_forward``)
    when its RHS is the NF/PNF/exact-GeLU PreBasicBlock2, the solver list is
    one rk2 solver with n_steps set, in standalone mode, no ss-loss is
    asked for, and no gradient can flow (grad mode off, or neither the
    block's input nor its weights require grad): B2, like the Pallas
    kernel, has no backward.  Otherwise it takes the generic
    ``meta_integrate`` over the torch RHS, the port's counterpart of the
    JAX package's XLA path.
``use_kernels=False`` takes the generic path with ``F.conv2d`` everywhere:
the plain path the kernels are checked against on the card.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import torch

from ..ops.conv3x3 import conv3x3_same
from ..ops.ode_block import ode_block_rk2_forward
from ..ops.regimes import SolverOptions, meta_integrate
from . import nn as fnn
from .nn import NormDef, ParamNormDef, make_norm_def, make_param_norm_def

Params = Dict[str, Any]

__all__ = ["CifarConfig", "init_cifar", "apply_cifar", "MODEL_REGISTRY"]


@dataclass(frozen=True)
class CifarConfig:
    """Architecture configuration (slot order: resblock, odeblock, bn1)."""

    num_blocks: Tuple[Tuple[int, int], ...] = ((1, 1), (1, 1))
    block_type: str = "prebasic"
    num_classes: int = 10
    in_planes: int = 64
    norms: Tuple[str, str, str] = ("NF", "NF", "NF")
    num_gn_groups: int = 32
    param_norms: Tuple[str, str, str] = ("PNF", "PNF", "PNF")
    acts: Tuple[str, str, str] = ("GeLU", "GeLU", "GeLU")

    def norm_def(self, slot: int) -> NormDef:
        return make_norm_def(self.norms[slot], self.num_gn_groups)

    def pn_def(self, slot: int) -> ParamNormDef:
        return make_param_norm_def(self.param_norms[slot])

    def act(self, slot: int):
        return fnn.get_activation(self.acts[slot])


def _check_ported(cfg: CifarConfig) -> None:
    if cfg.block_type != "prebasic":
        raise NotImplementedError(
            f"block_type {cfg.block_type!r} is not ported yet (ROADMAP A11)")
    for slot in range(3):  # raise early on a norm kind not ported yet
        cfg.norm_def(slot)
        cfg.pn_def(slot)
        cfg.act(slot)


# ------------------------------------------------------- param-norm convs --


def _pn_conv_init(gen: torch.Generator, in_ch: int, out_ch: int, k: int
                  ) -> Params:
    return fnn.conv2d_init(gen, in_ch, out_ch, k, use_bias=False)


def _conv(p_eff: Params, x: torch.Tensor, stride: int, padding: int,
          use_kernels: bool) -> torch.Tensor:
    """A materialized conv: kernel B1 for a stride-1 SAME 3x3 conv without
    bias when ``use_kernels``, else ``F.conv2d``."""
    kernel = p_eff["kernel"]
    if (use_kernels and stride == 1 and padding == 1
            and tuple(kernel.shape[:2]) == (3, 3) and "bias" not in p_eff):
        return conv3x3_same(x, kernel.to(x.dtype))  # kernel B1
    return fnn.conv2d(p_eff, x, stride=stride, padding=padding)


def _pn_conv(pn: ParamNormDef, params: Params, x: torch.Tensor, stride: int,
             padding: int, use_kernels: bool) -> torch.Tensor:
    return _conv(pn.materialize(params), x, stride, padding, use_kernels)


# ------------------------------------------------------------- res blocks --


def _pre_block_init(gen, in_planes, planes, stride) -> Params:
    p: Params = {
        "conv1": _pn_conv_init(gen, in_planes, planes, 3),
        "conv2": _pn_conv_init(gen, planes, planes, 3),
    }
    if stride != 1 or in_planes != planes:
        p["sc_conv"] = _pn_conv_init(gen, in_planes, planes, 1)
    return p


def _pre_block_apply(cfg, p, x, stride, use_kernels):
    """PreBasicBlock (layers.py:77-81): pre-activation residual block."""
    nd, pnd, act = cfg.norm_def(0), cfg.pn_def(0), cfg.act(0)
    out = act(nd.apply(x))
    out = _pn_conv(pnd, p["conv1"], out, stride, 1, use_kernels)
    out = act(nd.apply(out))
    out = _pn_conv(pnd, p["conv2"], out, 1, 1, use_kernels)
    shortcut = x
    if "sc_conv" in p:
        shortcut = _pn_conv(pnd, p["sc_conv"], x, stride, 0, use_kernels)
    return out + shortcut


# --------------------------------------------------------------- ODE RHS --


def _odefunc_init(gen, dim) -> Params:
    return {"conv1": _pn_conv_init(gen, dim, dim, 3),
            "conv2": _pn_conv_init(gen, dim, dim, 3)}


def _materialize_odefunc(cfg, p):
    """Apply the param-norm once per solve."""
    pnd = cfg.pn_def(1)
    return {"conv1": pnd.materialize(p["conv1"]),
            "conv2": pnd.materialize(p["conv2"])}


def _odefunc_apply(cfg, p_eff, t, x, use_kernels=False, ss_abs=False):
    """PreBasicBlock2 RHS (layers.py:148-161); t is unused (autonomous).
    Its two convs go to kernel B1 when ``use_kernels``; ``ss_abs`` returns
    |RHS| (the ss-loss's ``ss_loss_abs``)."""
    del t
    nd, act = cfg.norm_def(1), cfg.act(1)
    out = act(nd.apply(x))
    out = _conv(p_eff["conv1"], out, 1, 1, use_kernels)
    out = act(nd.apply(out))
    out = _conv(p_eff["conv2"], out, 1, 1, use_kernels)
    return out.abs() if ss_abs else out


def _ode_kernel_u(cfg: CifarConfig, solvers, options: SolverOptions
                  ) -> Optional[float]:
    """The clamped u~ when an ODE block of this config goes to kernel B2,
    else None."""
    if (cfg.norms[1], cfg.param_norms[1], cfg.acts[1]) != ("NF", "PNF", "GeLU"):
        return None
    if options.solver_mode != "standalone" or len(solvers) != 1:
        return None
    s = solvers[0]
    # B2 runs n_steps uniform steps; a custom grid takes precedence over them
    if (s.method != "rk2" or s.custom_grid is not None or s.n_steps is None
            or s.step_size is not None):
        return None
    if s.u is None or s.u.numel() != 1:
        return None
    return float(s.tableau().c[..., 1])


# -------------------------------------------------------------- MetaLayer --


def _meta_layer_init(gen, planes, num_blocks, stride, in_planes):
    num_res, num_ode = num_blocks
    strides = [stride] + [1] * (num_res + num_ode - 1)
    p: Params = {"res": [], "ode": []}
    cur = in_planes
    for st in strides[:num_res]:
        p["res"].append(_pre_block_init(gen, cur, planes, st))
        cur = planes
    for _ in range(num_ode):
        p["ode"].append(_odefunc_init(gen, cur))
    return p, cur


def _grad_can_flow(x: torch.Tensor, p_eff: Params) -> bool:
    return torch.is_grad_enabled() and (
        x.requires_grad
        or any(p["kernel"].requires_grad for p in p_eff.values()))


def _meta_layer_apply(cfg, p, x, strides, solvers, options, use_kernels,
                      remat=False, generator=None, ss_loss=False,
                      ss_loss_abs=False):
    """The layer's output and its ss-loss (0 without ``ss_loss``)."""
    for i, bp in enumerate(p["res"]):
        x = _pre_block_apply(cfg, bp, x, strides[i], use_kernels)
    ss_total = torch.zeros((), dtype=x.dtype, device=x.device)
    u_k = (_ode_kernel_u(cfg, solvers, options)
           if use_kernels and not ss_loss else None)
    for bp in p["ode"]:
        p_eff = _materialize_odefunc(cfg, bp)
        if u_k is not None and not _grad_can_flow(x, p_eff):  # kernel B2
            x = ode_block_rk2_forward(
                x, p_eff["conv1"]["kernel"].to(x.dtype),
                p_eff["conv2"]["kernel"].to(x.dtype), u_k, solvers[0].n_steps,
            )
            continue
        rhs = lambda t, y, _p=p_eff: _odefunc_apply(cfg, _p, t, y,
                                                    use_kernels)
        x, aux = meta_integrate(solvers, rhs, x, options, generator,
                                remat=remat)
        if ss_loss:
            rhs_ss = lambda t, y, _p=p_eff: _odefunc_apply(
                cfg, _p, t, y, use_kernels, ss_abs=ss_loss_abs)
            z, _ = meta_integrate(solvers, rhs_ss, x, options, t0=1.0,
                                  t1=2.0, aux_in=aux, remat=remat)
            # f32 reduction: the squared sum over HW*C elements loses
            # mantissa in bf16 (the torch reference reduces in f32)
            diff = (z - x).reshape(x.shape[0], -1).float()
            ss_total = ss_total + torch.linalg.vector_norm(
                diff, dim=1).mean().to(ss_total.dtype)
    return x, ss_total


# ----------------------------------------------------------------- model --


def init_cifar(cfg: CifarConfig, generator: torch.Generator) -> Params:
    """Parameters as nested dicts/lists of tensors, with the JAX tree's
    names and layouts (its None norm leaves left out)."""
    _check_ported(cfg)
    p: Params = {"conv1": _pn_conv_init(generator, 3, cfg.in_planes, 3)}
    in_planes = cfg.in_planes
    n_features = cfg.in_planes
    for li in range(len(cfg.num_blocks)):
        planes = cfg.in_planes * (2 ** li)
        stride = 1 if li == 0 else 2
        p[f"layer{li + 1}"], in_planes = _meta_layer_init(
            generator, planes, cfg.num_blocks[li], stride, in_planes)
        if li >= 1:
            n_features *= 2
    p["fc"] = fnn.linear_init(generator, n_features, cfg.num_classes)
    return p


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
    use_kernels: bool = True,
    train: bool = False,
    remat: bool = False,
    generator: Optional[torch.Generator] = None,
    ss_loss: bool = False,
    ss_loss_abs: bool = False,
    return_aux: bool = False,
) -> Union[torch.Tensor, Tuple[torch.Tensor, Dict[str, torch.Tensor]]]:
    """Forward of NHWC ``x``; returns the logits in x's dtype, and with
    ``return_aux`` also ``{"ss_loss": ...}`` (a 0-dim tensor in x's dtype,
    0 unless ``ss_loss``).  ``train`` selects train mode, the same function
    for the ported NF/PNF norms (as in JAX, where train mode only changes
    BN/SN, ROADMAP A11); ``remat`` checkpoints each RK step of the generic
    ODE-block path; ``generator`` (a CPU generator) serves the switch and
    ensemble draws."""
    del train
    _check_ported(cfg)
    if solvers is None and any(n_ode for _, n_ode in cfg.num_blocks):
        raise ValueError("this config integrates ODE blocks: pass "
                         "solvers=[create_solver('rk2', 'u', n_steps=8)]")
    nd_bn1, pnd_bn1, act_bn1 = cfg.norm_def(2), cfg.pn_def(2), cfg.act(2)

    out = _pn_conv(pnd_bn1, params["conv1"], x, 1, 1, use_kernels)
    out = act_bn1(nd_bn1.apply(out))
    ss_total = torch.zeros((), dtype=x.dtype, device=x.device)
    for li in range(len(cfg.num_blocks)):
        out, ss = _meta_layer_apply(
            cfg, params[f"layer{li + 1}"], out, _layer_strides(cfg, li),
            solvers, solver_options, use_kernels, remat, generator,
            ss_loss, ss_loss_abs,
        )
        ss_total = ss_total + ss
    logits = fnn.linear(params["fc"], fnn.global_avg_pool(out))
    return (logits, {"ss_loss": ss_total}) if return_aux else logits


# ------------------------------------------------------------- registry --


def _make_ctor(ode_blocks):
    def ctor(**kw) -> CifarConfig:
        # an explicit num_blocks override replaces the registry counts
        nb = kw.pop("num_blocks", ode_blocks)
        return CifarConfig(num_blocks=tuple(tuple(b) for b in nb),
                           block_type="prebasic", **kw)

    return ctor


# (res, ode) per stage of the ODE nets — odenet_cifar10/layers.py:429-556
premetanode4 = _make_ctor([(0, 1)])
premetanode6 = _make_ctor([(1, 1)])
premetanode10 = _make_ctor([(1, 1), (1, 1)])
premetanode18 = _make_ctor([(1, 1)] * 4)
premetanode34 = _make_ctor([(1, 2), (1, 3), (1, 5), (1, 2)])

MODEL_REGISTRY = {
    "premetanode4": premetanode4,
    "premetanode6": premetanode6,
    "premetanode10": premetanode10,
    "premetanode18": premetanode18,
    "premetanode34": premetanode34,
}
