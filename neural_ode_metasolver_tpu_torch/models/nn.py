"""Functional layers of the port (port of models/nn.py), NHWC / HWIO.

A layer is a pair of plain functions on tensors: ``*_init(generator, ...)``
makes its parameters (a dict of tensors, torch-default kaiming-uniform
init drawn from an explicit ``torch.Generator``) and ``f(params, x)``
applies them.  Activations are NHWC and conv kernels HWIO, as in the JAX
package; ``F.conv2d`` gets permuted NCHW / OIHW views (channels_last
strides) and its result is permuted back.  Under mixed precision the
kernel is cast to the activation dtype at each call (JAX ``nn.py:113``).

Norms: ``group_norm`` (the MNIST MetaNODE's GN, kernel B3 underneath) and,
as ``NormDef`` kinds, NF (identity) and param-norm PNF (none) are ported;
the CIFAR ``NormDef`` kinds BN, GN, LN, IN and SN/WN land with ROADMAP A11
and raise ``NotImplementedError`` here.
"""
from __future__ import annotations

import math
from functools import partial
from typing import Any, Callable, Dict, Optional

import torch
import torch.nn.functional as F

from ..ops.group_norm import fused_group_norm_act, group_norm_reference

Params = Dict[str, Any]

__all__ = [
    "conv2d_init",
    "conv2d",
    "linear_init",
    "linear",
    "gelu_poly",
    "get_activation",
    "group_norm_init",
    "group_norm",
    "NormDef",
    "make_norm_def",
    "ParamNormDef",
    "make_param_norm_def",
    "global_avg_pool",
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


def conv2d(params: Params, x: torch.Tensor, stride: int = 1,
           padding: int = 0) -> torch.Tensor:
    """2-D convolution, NHWC x HWIO -> NHWC (contiguous), symmetric integer
    padding; the kernel is cast to x's dtype."""
    kernel = params["kernel"].to(x.dtype)
    xi = x.permute(0, 3, 1, 2)
    if x.device.type == "cpu" and stride != 1:
        # torch 2.13's CPU build (oneDNN 3.12) corrupts its heap in the
        # backward of a strided 1x1 conv on a channels-last input
        xi = xi.contiguous()
    y = F.conv2d(xi, kernel.permute(3, 2, 0, 1), stride=stride,
                 padding=padding)
    y = y.permute(0, 2, 3, 1).contiguous()
    if "bias" in params:
        y = y + params["bias"].to(y.dtype)
    return y


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
    y = x @ params["kernel"].to(x.dtype)
    if "bias" in params:
        y = y + params["bias"].to(y.dtype)
    return y


# erf(x/sqrt2) ~= tanh(x * q(x^2)), q of degree 4 (JAX nn.py:353-368)
_GELU_TANH_KERNEL_COEFFS = (
    0.7978281363504355, 0.036468789125448826, -0.0001248603561668213,
    -3.058127220985254e-05, 1.119098134045954e-06,
)


def gelu_poly(x: torch.Tensor) -> torch.Tensor:
    """Exact-erf GELU as 0.5*x*(1 + tanh(x*q(x^2))), computed in x's dtype
    with |x| clamped at 8 (JAX ``nn.py::gelu_poly``; max |diff| to the
    exact form 3.4e-6 in f32)."""
    t = torch.clamp(x, -8.0, 8.0)
    t2 = t * t
    cs = _GELU_TANH_KERNEL_COEFFS
    q = torch.full_like(x, cs[-1])
    for c in cs[-2::-1]:
        q = q * t2 + c
    phi = 0.5 * torch.tanh(t * q) + 0.5
    return (x * phi).to(x.dtype)


def get_activation(key: str) -> Callable[[torch.Tensor], torch.Tensor]:
    """String -> activation (reference get_activation, utils.py:57-76).
    'GeLU' is the exact (erf) GELU; 'AF' is leaky_relu with slope 1, the
    identity."""
    if key == "ReLU":
        return F.relu
    if key == "GeLU":
        return F.gelu
    if key == "GeLUtanh":
        return partial(F.gelu, approximate="tanh")
    if key == "GeLUpoly":
        return gelu_poly
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
    return f(x, params["scale"], params["bias"], num_groups, eps, act)


class NormDef:
    """A norm layer kind; only NF (identity) is ported."""

    def __init__(self, kind: str, num_groups: int = 32):
        if kind not in ("BN", "LN", "GN", "IN", "NF"):
            raise NameError("Unknown layer normalization type")
        if kind != "NF":
            raise NotImplementedError(
                f"norm {kind!r} is not ported yet (ROADMAP A11)")
        self.kind = kind
        self.num_groups = num_groups

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        return x


def make_norm_def(key: str, num_groups: int = 32) -> NormDef:
    return NormDef(key, num_groups)


class ParamNormDef:
    """A weight-normalization kind; only PNF (none) is ported."""

    def __init__(self, kind: str):
        if kind not in ("SN", "WN", "PNF"):
            raise NameError("Unknown param normalization type")
        if kind != "PNF":
            raise NotImplementedError(
                f"param norm {kind!r} is not ported yet (ROADMAP A11)")
        self.kind = kind

    def materialize(self, params: Params) -> Params:
        return params


def make_param_norm_def(key: str) -> ParamNormDef:
    return ParamNormDef(key)


def global_avg_pool(x: torch.Tensor) -> torch.Tensor:
    """AdaptiveAvgPool2d((1, 1)) + Flatten for NHWC."""
    return x.mean(dim=(1, 2))
