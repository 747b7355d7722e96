"""Functional layers of the port (port of models/nn.py), NHWC / HWIO.

A layer is a pair of plain functions on tensors: ``*_init(generator, ...)``
makes its parameters (a dict of tensors, torch-default kaiming-uniform
init drawn from an explicit ``torch.Generator``) and ``f(params, x)``
applies them.  Activations are NHWC and conv kernels HWIO, as in the JAX
package; ``F.conv2d`` gets permuted NCHW / OIHW views (channels_last
strides) and its result is permuted back.  Under mixed precision the
kernel is cast to the activation dtype at each call (JAX ``nn.py:113``).

Norms (JAX ``nn.py:253-343``): ``group_norm`` is kernel B3 (the MNIST
MetaNODE's GN, and the CIFAR ``NormDef`` kinds GN, LN and IN, each with
the activation after it fused where B3 computes it); ``batch_norm`` is
plain arithmetic, as JAX computes it outside any Pallas kernel.  Stateful
layers (BN's running statistics, SN's power-iteration vector) take their
state as an argument and return the new one; nothing here mutates a
tensor.  Param norms SN and WN (``ParamNormDef``, JAX ``nn.py:435-511``)
and the ``--init`` schemes (``apply_init_scheme``, ``nn.py:144-225``)
follow JAX's walk and formulas; their random draws come from a
``torch.Generator``, so they match JAX in distribution, not in value.

**Members** (a fleet of S runs, ``training/fleet.py``): a layer whose
params carry a leading member axis (a conv kernel (S, kh, kw, I, O), a
linear kernel (S, I, O), a norm's scale (S, C)) takes activations with the
same leading axis, (S, N, H, W, C) or (S, N, F), and applies member m's
params to member m's slice: ``F.conv2d`` with ``groups=S``, ``torch.bmm``,
kernel B3 member-batched, BN's statistics over each member's own batch.
Params without that axis take the single-run path unchanged.

**The tensor-parallel seam** (a ``model`` mesh axis, ``parallel/mesh.py``):
a conv (``conv2d``, kernel B1's route ``conv3x3_b1``) or ``linear`` whose
kernel holds this rank's output channels (``tp_sharding_of``) runs on them
between two conjugate operators: before it ``replicate_grad`` (identity
forward, the input's gradient all-reduced over the axis backward), after
it an all-gather of the channels (this rank's slice of the gradient
backward).  Everything between convs runs replicated on full channels, so
a 1-D channel param that a replicated layer reads (GN's and BN's
``scale``/``bias`` where the name rule shards them) is all-gathered first,
its gradient sliced back.  SN and WN (``ParamNormDef.materialize``)
gather the whole kernel (the gradient summed over the axis and sliced),
normalize it, and keep this rank's columns.

**The spatial seam** (an ``sp`` axis, ``parallel/mesh.py::spatial_rows``):
activations hold this rank's rows of the height.  Every conv takes a halo
of its neighbours' rows (``halo_rows``: zeros past the global edges; its
backward sends the halo rows' gradients back): kernel B1 runs SAME on
``H_local + 2`` rows and drops the outer output rows, so B1, its dgrad and
its wgrad stay on the path; ``F.conv2d`` runs with the height's padding
taken by the halo (one row above for a strided 3x3, none for a strided
1x1).  GroupNorm (B3) gathers the rows, normalizes the whole height with
its statistics inside the kernel, and keeps this rank's rows (the
gradient summed over the axis and sliced): B3 still runs, on the full
height, at the cost of one all-gather of the activation.  BatchNorm's
statistics reduce over data x sp (``data_shard`` is that group in a
step); ``global_avg_pool`` sums over the axis.
"""
from __future__ import annotations

import math
from functools import partial
from typing import Any, Callable, Dict, Optional

import torch
import torch.nn.functional as F

from ..ops.conv3x3 import conv3x3_same
from ..ops.gelu_poly import fused_gelu_poly, gelu_poly_reference
from ..ops.group_norm import fused_group_norm_act, group_norm_reference
from ..parallel.mesh import (active_data_shard, active_spatial, all_sum,
                             gather, halo_rows, mark_tp, replicate_grad,
                             tp_sharding_of)

Params = Dict[str, Any]

__all__ = [
    "conv2d_init",
    "conv2d",
    "conv3x3_b1",
    "linear_init",
    "linear",
    "gelu_poly",
    "get_activation",
    "group_norm_init",
    "group_norm",
    "batch_norm_init",
    "batch_norm",
    "NormDef",
    "make_norm_def",
    "ParamNormDef",
    "make_param_norm_def",
    "orthogonal_conv_init",
    "xavier_conv_init",
    "orthogonal_fc_init",
    "apply_init_scheme",
    "global_avg_pool",
    "row_norm",
    "add_bias",
]


def _uniform(generator: torch.Generator, shape, bound: float,
             dtype: torch.dtype) -> torch.Tensor:
    """U(-bound, bound) drawn on the generator's device."""
    r = torch.rand(shape, generator=generator, dtype=dtype,
                   device=generator.device)
    return (r * 2.0 - 1.0) * bound


def _kaiming_uniform(generator, shape, fan_in, a=math.sqrt(5.0),
                     dtype=torch.float32):
    """kaiming_uniform_ with a=sqrt(5): U(-1/sqrt(fan_in), 1/sqrt(fan_in)),
    the torch Conv2d/Linear default."""
    gain = math.sqrt(2.0 / (1.0 + a * a))
    return _uniform(generator, shape, gain * math.sqrt(3.0 / fan_in), dtype)


def conv2d_init(generator: torch.Generator, in_ch: int, out_ch: int,
                ksize: int, use_bias: bool = True,
                dtype: torch.dtype = torch.float32) -> Params:
    """Conv kernel (H, W, I, O) + optional bias, torch-default init."""
    fan_in = in_ch * ksize * ksize
    params: Params = {
        "kernel": _kaiming_uniform(generator, (ksize, ksize, in_ch, out_ch),
                                   fan_in, dtype=dtype)
    }
    if use_bias:
        params["bias"] = _uniform(generator, (out_ch,),
                                  1.0 / math.sqrt(fan_in), dtype)
    return params


def add_bias(y: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """y + bias over the last axis; a members' (S, C) bias adds row m to
    y's member m (y (S, ..., C))."""
    bias = bias.to(y.dtype)
    if bias.dim() == 2:
        bias = bias.reshape(bias.shape[:1] + (1,) * (y.dim() - 2)
                            + bias.shape[1:])
    return y + bias


def _member_conv2d(kernel: torch.Tensor, x: torch.Tensor, stride: int,
                   padding: int) -> torch.Tensor:
    """Members' conv: x (S, N, H, W, I) and kernel (S, kh, kw, I, O) as
    one ``F.conv2d`` with ``groups=S`` on the image-major copy (N, H, W,
    S*I), handed to cuDNN as a channels_last NCHW view (so it transposes
    nothing) -> (S, N, H', W', O), contiguous."""
    s, n, h, w, ci = x.shape
    kh, kw, co = kernel.shape[1], kernel.shape[2], kernel.shape[4]
    xi = x.permute(1, 2, 3, 0, 4).reshape(n, h, w, s * ci).permute(0, 3, 1, 2)
    wk = kernel.permute(0, 4, 1, 2, 3).reshape(s * co, kh, kw, ci) \
        .permute(0, 3, 1, 2)
    if x.device.type == "cpu" and stride != 1:
        # as ``conv2d``: the CPU build's strided backward on channels_last
        xi = xi.contiguous()
    y = F.conv2d(xi, wk, stride=stride, padding=padding, groups=s)
    ho, wo = y.shape[2], y.shape[3]
    return y.permute(0, 2, 3, 1).reshape(n, ho, wo, s, co) \
        .permute(3, 0, 1, 2, 4).contiguous()


def _column_parallel(kernel: torch.Tensor, x: torch.Tensor,
                     f: Callable[[torch.Tensor], torch.Tensor]
                     ) -> torch.Tensor:
    """``f(x)``, a layer on ``kernel``'s output channels: where the kernel
    holds this rank's channels of a ``model`` axis, between
    ``replicate_grad`` and an all-gather of the channels."""
    rule = tp_sharding_of(kernel)
    if rule is None or rule.shard.group is None:
        return f(x)
    y = f(replicate_grad(x, rule.shard))
    return gather(y, rule.shard, -1, sum_grads=False)


def _full(t: torch.Tensor) -> torch.Tensor:
    """A 1-D channel param as a replicated layer reads it: all-gathered
    where it holds this rank's slice of a ``model`` axis."""
    rule = tp_sharding_of(t)
    if rule is None or rule.shard.group is None:
        return t
    return gather(t, rule.shard, 0, sum_grads=False)


def _spatial_halo(x: torch.Tensor, kh: int, stride: int, padding: int
                  ) -> torch.Tensor:
    """x's rows of the sp axis with the halo a conv of height ``kh``,
    ``stride`` and ``padding`` needs (``padding`` rows above, ``kh -
    stride - padding`` below), so that the conv without height padding
    gives exactly this rank's rows of the output; raises where the
    output's rows do not split as the input's do."""
    sp = active_spatial()
    above, below = padding, max(0, kh - stride - padding)
    h = x.shape[-3]
    if h % stride or (h + above + below - kh) // stride + 1 != h // stride:
        raise ValueError(
            f"a {kh}-row conv of stride {stride} and padding {padding} does "
            f"not keep {h} rows a rank split over the {sp.axis} axis")
    return halo_rows(x, sp, above, below)


def conv2d(params: Params, x: torch.Tensor, stride: int = 1,
           padding: int = 0) -> torch.Tensor:
    """2-D convolution, NHWC x HWIO -> NHWC (contiguous), symmetric integer
    padding; the kernel is cast to x's dtype.  Members (kernel (S, kh, kw,
    I, O), x (S, N, H, W, I)) run as one grouped conv.  Under a ``model``
    axis a marked kernel runs on its channels, under ``spatial_rows`` on
    this rank's rows with a halo (module docstring)."""
    kernel = params["kernel"]
    if kernel.dim() == 5:
        y = _member_conv2d(kernel.to(x.dtype), x, stride, padding)
        return add_bias(y, params["bias"]) if "bias" in params else y

    def local(xi: torch.Tensor) -> torch.Tensor:
        pad_h = padding
        if active_spatial() is not None:
            xi = _spatial_halo(xi, kernel.shape[0], stride, padding)
            pad_h = 0
        xi = xi.permute(0, 3, 1, 2)
        if xi.device.type == "cpu" and stride != 1:
            # torch 2.13's CPU build (oneDNN 3.12) corrupts its heap in the
            # backward of a strided 1x1 conv on a channels-last input
            xi = xi.contiguous()
        y = F.conv2d(xi, kernel.to(xi.dtype).permute(3, 2, 0, 1),
                     stride=stride, padding=(pad_h, padding))
        y = y.permute(0, 2, 3, 1).contiguous()
        return add_bias(y, params["bias"]) if "bias" in params else y

    return _column_parallel(kernel, x, local)


def conv3x3_b1(x: torch.Tensor, kernel: torch.Tensor,
               bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Kernel B1 (a SAME 3x3 conv of stride 1) on x, the kernel cast to
    x's dtype, ``bias`` added after it; members (kernel (S, 3, 3, I, O))
    in one launch; under a ``model`` axis on the kernel's channels, under
    ``spatial_rows`` on this rank's rows plus one halo row each side, the
    outer output rows dropped."""
    if kernel.dim() == 5:
        y = conv3x3_same(x, kernel.to(x.dtype))
        return y if bias is None else add_bias(y, bias)

    def local(xi: torch.Tensor) -> torch.Tensor:
        k = kernel.to(xi.dtype)
        sp = active_spatial()
        if sp is None:
            y = conv3x3_same(xi, k)
        else:
            y = conv3x3_same(halo_rows(xi, sp, 1, 1), k)
            y = y[..., 1:-1, :, :].contiguous()
        return y if bias is None else add_bias(y, bias)

    return _column_parallel(kernel, x, local)


def linear_init(generator: torch.Generator, in_f: int, out_f: int,
                use_bias: bool = True,
                dtype: torch.dtype = torch.float32) -> Params:
    """Linear kernel (in, out) + optional bias, torch-default init."""
    params: Params = {
        "kernel": _kaiming_uniform(generator, (in_f, out_f), in_f,
                                   dtype=dtype)
    }
    if use_bias:
        params["bias"] = _uniform(generator, (out_f,), 1.0 / math.sqrt(in_f),
                                  dtype)
    return params


def linear(params: Params, x: torch.Tensor) -> torch.Tensor:
    """x @ kernel + bias; members (kernel (S, I, O), x (S, N, I)) as one
    ``torch.bmm``."""
    kernel = params["kernel"]
    if kernel.dim() == 3:
        y = torch.bmm(x, kernel.to(x.dtype))
        return add_bias(y, params["bias"]) if "bias" in params else y

    def local(xi: torch.Tensor) -> torch.Tensor:
        y = xi @ kernel.to(xi.dtype)
        return add_bias(y, params["bias"]) if "bias" in params else y

    return _column_parallel(kernel, x, local)


_GELU_POLY_KERNEL_DTYPES = (torch.float32, torch.bfloat16)


def gelu_poly(x: torch.Tensor) -> torch.Tensor:
    """Exact-erf GELU as 0.5*x*(1 + tanh(x*q(x^2))) with |x| clamped at 8
    (JAX ``nn.py::gelu_poly``; max |diff| to the exact form 3.4e-6 in
    f32).  An f32 or bf16 CUDA tensor takes the GeLUpoly kernels
    (``ops.gelu_poly.fused_gelu_poly``: computed in f32, rounded once to
    x's dtype), on a contiguous copy if it is not contiguous; on the CPU or
    in another dtype it is the composition in x's dtype
    (``gelu_poly_reference``)."""
    if x.is_cuda and x.dtype in _GELU_POLY_KERNEL_DTYPES:
        return fused_gelu_poly(x.contiguous())
    return gelu_poly_reference(x)


def get_activation(key: str, use_kernels: bool = True
                   ) -> Callable[[torch.Tensor], torch.Tensor]:
    """String -> activation (reference get_activation, utils.py:57-76).
    'GeLU' is the exact (erf) GELU; 'AF' is leaky_relu with slope 1, the
    identity.  'GeLUpoly' is ``gelu_poly``, its plain composition with
    ``use_kernels=False``."""
    if key == "ReLU":
        return F.relu
    if key == "GeLU":
        return F.gelu
    if key == "GeLUtanh":
        return partial(F.gelu, approximate="tanh")
    if key == "GeLUpoly":
        return gelu_poly if use_kernels else gelu_poly_reference
    if key == "Softsign":
        return F.softsign
    if key == "Tanh":
        return torch.tanh
    if key == "AF":
        return lambda x: x
    raise NameError("Unknown activation type")


def group_norm_init(ch: int) -> Params:
    """Unit scale and zero bias, in f32 (kernel B3 takes its affine in f32
    whatever x's dtype)."""
    return {"scale": torch.ones(ch, dtype=torch.float32),
            "bias": torch.zeros(ch, dtype=torch.float32)}


def group_norm(params: Params, x: torch.Tensor, num_groups: int,
               eps: float = 1e-5, act: Optional[str] = None,
               use_kernels: bool = True) -> torch.Tensor:
    """GroupNorm over NHWC (torch nn.GroupNorm parity: eps 1e-5, affine),
    then ``act`` (None, 'relu', 'gelu', 'tanh', 'softsign'); statistics in
    f32 whatever x's dtype, result in x's dtype.

    This is kernel B3 (``ops.group_norm.fused_group_norm_act``); with
    ``use_kernels=False`` it is B3's plain version, on any device.  With an
    activation the f32 result is activated and then rounded, where the JAX
    model rounds and then activates: identical in f32 and for ReLU, at most
    one rounding apart otherwise."""
    f = fused_group_norm_act if use_kernels else group_norm_reference
    scale, bias = _full(params["scale"]), _full(params["bias"])
    sp = active_spatial()
    if sp is None or x.dim() != 4:
        return f(x, scale, bias, num_groups, eps, act)
    # the whole height's statistics: B3 on the gathered rows
    h = x.shape[-3]
    y = f(gather(x, sp, -3, sum_grads=True), scale, bias, num_groups, eps,
          act)
    return y[:, sp.index * h:(sp.index + 1) * h].contiguous()


def batch_norm_init(ch: int):
    """BatchNorm's (params, state): unit scale, zero bias, running mean 0
    and variance 1, all f32."""
    params = group_norm_init(ch)
    state = {"mean": torch.zeros(ch, dtype=torch.float32),
             "var": torch.ones(ch, dtype=torch.float32)}
    return params, state


def batch_norm(params: Params, state: Optional[Params], x: torch.Tensor,
               train: bool, momentum: float = 0.1, eps: float = 1e-5):
    """BatchNorm2d over NHWC (torch parity: momentum 0.1, unbiased running
    variance), plain arithmetic in f32, the result in x's dtype.  Returns
    ``(y, new_state)``: train mode normalizes with the batch's statistics
    and, given a ``state``, returns the updated running statistics (new
    tensors, detached; ``state`` is not touched); eval mode uses the
    running statistics and returns ``state``.  Members (x (S, N, H, W, C),
    params and state (S, C)) take each member's statistics over its own N,
    H, W.  In train mode under a data-parallel step
    (``parallel.mesh.data_shard``) the statistics and n are the global
    batch's, summed over the data group with a differentiable all-reduce,
    as GSPMD computes them in JAX."""
    xf = x.float()
    dims = tuple(range(x.dim() - 4, x.dim() - 1))  # N, H, W
    per = ((lambda t: t.reshape(t.shape[0], 1, 1, 1, t.shape[1]))
           if x.dim() == 5 else (lambda t: t))
    if train:
        n = x.shape[-4] * x.shape[-3] * x.shape[-2]
        shard = active_data_shard()
        if shard is None:
            mean = xf.mean(dim=dims)
            var = ((xf - per(mean)) ** 2).mean(dim=dims)
        else:
            n *= shard.size
            mean = all_sum(xf.sum(dim=dims), shard) / n
            var = all_sum(((xf - per(mean)) ** 2).sum(dim=dims), shard) / n
        new_state = None
        if state is not None:
            unbiased = var.detach() * (n / max(n - 1, 1))
            new_state = {
                "mean": (1 - momentum) * state["mean"]
                + momentum * mean.detach(),
                "var": (1 - momentum) * state["var"] + momentum * unbiased,
            }
    else:
        mean, var = state["mean"], state["var"]
        new_state = state
    y = (xf - per(mean)) * torch.rsqrt(per(var) + eps)
    y = y * per(_full(params["scale"]).float()) \
        + per(_full(params["bias"]).float())
    return y.to(x.dtype), new_state


# the registry's activations that kernel B3 fuses, by its names
_B3_ACTS = {"ReLU": "relu", "GeLU": "gelu", "Tanh": "tanh",
            "Softsign": "softsign", "AF": None}


def _unit_affine(x: torch.Tensor):
    shape = ((x.shape[0], x.shape[-1]) if x.dim() == 5
             else (x.shape[-1],))
    return {"scale": torch.ones(shape, dtype=torch.float32, device=x.device),
            "bias": torch.zeros(shape, dtype=torch.float32, device=x.device)}


class NormDef:
    """A norm layer kind (reference get_normalization, utils.py:15-38):
    BN, GN, LN, IN or NF.

    ``init(ch) -> (params, state)`` (None where the kind has none);
    ``apply(params, state, x, train, act=None, use_kernels=True) -> (y,
    new_state)`` normalizes and then applies the activation ``act`` (a
    registry name, or None).  GN (``min(num_groups, C)`` groups), LN (one
    group) and IN (C groups, no affine) are kernel B3, with ``act`` fused
    where B3 computes it (ReLU, GeLU, Tanh, Softsign; AF is the identity)
    and applied after it otherwise; ``use_kernels=False`` takes B3's plain
    version.  BN is plain arithmetic (``batch_norm``), ``act`` after it;
    its train mode returns the new running statistics without touching
    ``state``.  NF is the identity."""

    def __init__(self, kind: str, num_groups: int = 32):
        if kind not in ("BN", "LN", "GN", "IN", "NF"):
            raise NameError("Unknown layer normalization type")
        self.kind = kind
        self.num_groups = num_groups

    def init(self, ch: int):
        if self.kind == "BN":
            return batch_norm_init(ch)
        if self.kind in ("GN", "LN"):
            if self.kind == "GN" and ch % min(self.num_groups, ch) != 0:
                raise ValueError(
                    f"num_channels {ch} must be divisible by num_groups "
                    f"{min(self.num_groups, ch)}")
            return group_norm_init(ch), None
        return None, None  # IN, NF

    def apply(self, params: Optional[Params], state: Optional[Params],
              x: torch.Tensor, train: bool, act: Optional[str] = None,
              use_kernels: bool = True):
        if self.kind in ("GN", "LN", "IN"):
            c = x.shape[-1]
            groups = {"GN": min(self.num_groups, c), "LN": 1, "IN": c}[
                self.kind]
            y = group_norm(params if self.kind != "IN" else _unit_affine(x),
                           x, groups, act=_B3_ACTS.get(act),
                           use_kernels=use_kernels)
            if act is not None and act not in _B3_ACTS:
                y = get_activation(act, use_kernels)(y)
            return y, None
        new_state = None
        if self.kind == "BN":
            x, new_state = batch_norm(params, state, x, train)
        if act is not None:
            x = get_activation(act, use_kernels)(x)
        return x, new_state


def make_norm_def(key: str, num_groups: int = 32) -> NormDef:
    return NormDef(key, num_groups)


# ---------------------------------------------- parameter normalization --


def _kernel_as_matrix(kernel: torch.Tensor) -> torch.Tensor:
    """HWIO conv kernel (or (I, O) linear kernel) -> the (O, rest) matrix
    of torch's dim-0-first reshape of the OIHW weight; members' (S, kh,
    kw, I, O) -> (S, O, rest)."""
    if kernel.dim() == 5:
        s, kh, kw, ci, co = kernel.shape
        return kernel.permute(0, 4, 3, 1, 2).reshape(s, co, ci * kh * kw)
    if kernel.dim() == 4:
        kh, kw, ci, co = kernel.shape
        return kernel.permute(3, 2, 0, 1).reshape(co, ci * kh * kw)
    return kernel.T


def _l2(v: torch.Tensor, dim=None) -> torch.Tensor:
    return torch.linalg.vector_norm(v, dim=dim)


class ParamNormDef:
    """A weight-normalization kind: SN (spectral), WN (weight) or PNF
    (none).

    ``wrap_init(generator, params) -> (params, state)`` adds the
    reparametrization: WN a per-output-channel ``wn_g`` (the norms of the
    kernel's rows), SN a unit power-iteration vector ``sn_u`` of the
    state.  ``materialize(params, state, train) -> (params, new_state)``
    gives the effective kernel: WN ``wn_g * v / ||v||`` row by row; SN the
    kernel over its estimated spectral norm, after one power iteration in
    train mode (``u``, ``v`` carry no gradient; the new ``sn_u`` is
    returned, ``state`` is not touched) and none in eval mode."""

    def __init__(self, kind: str):
        if kind not in ("SN", "WN", "PNF"):
            raise NameError("Unknown param normalization type")
        self.kind = kind

    def wrap_init(self, generator: torch.Generator, params: Params):
        if self.kind == "PNF":
            return params, None
        mat = _kernel_as_matrix(params["kernel"])
        if self.kind == "WN":
            return {**params, "wn_g": _l2(mat, 1).to(mat.dtype)}, None
        u = torch.randn(mat.shape[0], generator=generator,
                        dtype=torch.float32, device=generator.device)
        return params, {"sn_u": u / (_l2(u) + 1e-12)}

    def materialize(self, params: Params, state: Optional[Params],
                    train: bool):
        if self.kind == "PNF":
            return params, state
        if params["kernel"].dim() == 5:
            return self._materialize_members(params, state, train)
        rule = tp_sharding_of(params["kernel"])
        if rule is not None and rule.shard.group is not None:
            return self._materialize_tp(params, state, train, rule)
        kernel = params["kernel"]
        mat = _kernel_as_matrix(kernel).float()
        if self.kind == "WN":
            scale = params["wn_g"].float() / (_l2(mat, 1) + 1e-12)
            out = {k: v for k, v in params.items() if k != "wn_g"}
            out["kernel"] = kernel * scale.to(kernel.dtype)
            return out, state
        u = state["sn_u"]
        if train:
            with torch.no_grad():
                m = mat.detach()
                v = m.T @ u
                v = v / (_l2(v) + 1e-12)
                u = m @ v
                u = u / (_l2(u) + 1e-12)
            new_state = {"sn_u": u}
        else:
            v = mat.T @ u
            v = v / (_l2(v) + 1e-12)
            new_state = state
        sigma = u @ (mat @ v)
        return {**params, "kernel": kernel / sigma.to(kernel.dtype)}, \
            new_state


    def _materialize_tp(self, params: Params, state: Optional[Params],
                        train: bool, rule):
        """``materialize`` of a kernel holding this rank's output channels
        of a ``model`` axis: the whole kernel gathered (its gradient summed
        over the axis, then sliced), ``wn_g`` read whole (its gradient
        summed over the axis), normalized, this rank's columns kept."""
        shard = rule.shard
        kernel = params["kernel"]
        full = dict(params)
        full["kernel"] = gather(kernel, shard, -1, sum_grads=True)
        if "wn_g" in full:
            full["wn_g"] = replicate_grad(full["wn_g"], shard)
        out, new_state = self.materialize(full, state, train)
        o = kernel.shape[-1]
        k = out["kernel"].narrow(-1, shard.index * o, o).contiguous()
        return {**out, "kernel": mark_tp(k, rule)}, new_state

    def _materialize_members(self, params: Params, state: Optional[Params],
                             train: bool):
        """``materialize`` of members' conv kernels (S, kh, kw, I, O): the
        same formulas on each member's (O, rest) matrix, batched."""
        kernel = params["kernel"]
        mat = _kernel_as_matrix(kernel).float()  # (S, O, K)
        per = lambda t: t.reshape(t.shape[0], 1, 1, 1, -1)
        if self.kind == "WN":
            scale = params["wn_g"].float() / (_l2(mat, -1) + 1e-12)
            out = {k: v for k, v in params.items() if k != "wn_g"}
            out["kernel"] = kernel * per(scale).to(kernel.dtype)
            return out, state
        mv = lambda m, v: (m @ v.unsqueeze(-1)).squeeze(-1)
        unit = lambda v: v / (_l2(v, -1).unsqueeze(-1) + 1e-12)
        u = state["sn_u"]  # (S, O)
        if train:
            with torch.no_grad():
                m = mat.detach()
                v = unit(mv(m.transpose(1, 2), u))
                u = unit(mv(m, v))
            new_state = {"sn_u": u}
        else:
            v = unit(mv(mat.transpose(1, 2), u))
            new_state = state
        sigma = (u * mv(mat, v)).sum(-1)  # (S,)
        return {**params, "kernel": kernel / per(sigma).to(kernel.dtype)}, \
            new_state


def make_param_norm_def(key: str) -> ParamNormDef:
    return ParamNormDef(key)


# ---------------------------------------------------------- init schemes --


def _orthogonal(generator: torch.Generator, rows: int, cols: int,
                dtype: torch.dtype) -> torch.Tensor:
    """A (rows, cols) matrix with orthonormal rows (rows <= cols) or
    columns: QR of a normal draw, signs fixed by R's diagonal (torch's
    ``orthogonal_``, JAX's ``initializers.orthogonal``)."""
    a = torch.randn(max(rows, cols), min(rows, cols), generator=generator,
                    dtype=torch.float32, device=generator.device)
    q, r = torch.linalg.qr(a)
    q = q * torch.sign(torch.diagonal(r))
    return (q.T if rows < cols else q).to(dtype)


def orthogonal_conv_init(generator: torch.Generator, params: Params
                         ) -> Params:
    """Re-init a conv kernel orthogonally on its (O, I*H*W) matrix
    (odenet_cifar10/utils.py:87-89), bias untouched."""
    kernel = params["kernel"]
    kh, kw, ci, co = kernel.shape
    flat = _orthogonal(generator, co, kh * kw * ci, kernel.dtype)
    new = flat.reshape(co, kh, kw, ci).permute(1, 2, 3, 0).contiguous()
    return {**params, "kernel": new}


def xavier_conv_init(generator: torch.Generator, params: Params) -> Params:
    """Xavier-uniform (gain sqrt 2) conv re-init with zero bias, the
    reference's ``conv_init`` intent (odenet_cifar10/utils.py:78-85)."""
    kernel = params["kernel"]
    kh, kw, ci, co = kernel.shape
    bound = math.sqrt(2.0) * math.sqrt(6.0 / (ci * kh * kw + co * kh * kw))
    out = {**params, "kernel": _uniform(generator, tuple(kernel.shape),
                                        bound, kernel.dtype)}
    if "bias" in out:
        out["bias"] = torch.zeros_like(out["bias"])
    return out


def orthogonal_fc_init(generator: torch.Generator, params: Params) -> Params:
    """Orthogonal linear kernel, bias 1e-3 (odenet_cifar10/utils.py:91-94)."""
    inf, outf = params["kernel"].shape
    out = {**params, "kernel": _orthogonal(generator, outf, inf,
                                           params["kernel"].dtype).T
           .contiguous()}
    if "bias" in out:
        out["bias"] = torch.full_like(out["bias"], 1e-3)
    return out


def apply_init_scheme(generator: torch.Generator, params: Any,
                      scheme: Optional[str]) -> Any:
    """Walk a parameter tree in its order, re-initializing every conv
    kernel (``orthogonal`` or ``xavier``) and, under ``orthogonal``, the
    linear kernel (the runner's ``--init``, train_and_attack.py:439-443).
    Other leaves stay, ``wn_g`` too: it keeps the norms of the first
    init, as in the JAX package."""
    if scheme is None:
        return params
    if scheme not in ("orthogonal", "xavier"):
        raise NameError(f"Unknown init scheme {scheme!r}")

    def walk(node):
        if isinstance(node, dict) and "kernel" in node:
            if node["kernel"].dim() == 4:
                return (orthogonal_conv_init if scheme == "orthogonal"
                        else xavier_conv_init)(generator, node)
            if scheme == "orthogonal":
                return orthogonal_fc_init(generator, node)
            return node
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v) for v in node)
        return node

    return walk(params)


def row_norm(diff: torch.Tensor) -> torch.Tensor:
    """The L2 norm over the last axis of a sample's flattened values (the
    ss-loss's); under ``spatial_rows`` the rows' squares are summed over
    the sp axis first."""
    sp = active_spatial()
    if sp is None:
        return torch.linalg.vector_norm(diff, dim=-1)
    return all_sum(diff.pow(2).sum(-1), sp).sqrt()


def global_avg_pool(x: torch.Tensor) -> torch.Tensor:
    """AdaptiveAvgPool2d((1, 1)) + Flatten for NHWC (members' (S, N, H,
    W, C) -> (S, N, C)); under ``spatial_rows`` the mean over the whole
    height, the rows' f32 sums summed over the sp axis."""
    sp = active_spatial()
    if sp is None:
        return x.mean(dim=(-3, -2))
    n = x.shape[-3] * sp.size * x.shape[-2]
    return (all_sum(x.float().sum(dim=(-3, -2)), sp) / n).to(x.dtype)
