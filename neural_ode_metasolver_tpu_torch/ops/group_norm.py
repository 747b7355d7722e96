"""Kernel B3: GroupNorm (+ activation) over NHWC, forward.

Port of ``ops/pallas_kernels.py::fused_group_norm_act``: torch
``nn.GroupNorm(num_groups, C)`` parity (eps 1e-5, affine with f32 scale and
bias) followed by an activation, in one read of x.  The CUDA kernel
(``csrc/group_norm_act.cu``) runs one block per sample, stages the sample in
shared memory where it fits and takes two-pass f32 statistics; the Pallas
kernel's one-pass E[x^2] - E[x]^2 is the same function, less well
conditioned.  The activation is applied in f32 and the result rounded once
to x's dtype.

``fused_group_norm_act`` launches the kernel for CUDA tensors and takes the
plain version, ``group_norm_reference``, only for CPU tensors.  The backward
(the JAX package's custom VJP) comes with MNIST training.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from .. import _build, backend

__all__ = ["fused_group_norm_act", "group_norm_reference"]

KERNEL_NAME = "group_norm_act"

_ACTS = {
    None: lambda y: y,
    "relu": F.relu,
    "gelu": F.gelu,  # exact (erf)
    "tanh": torch.tanh,
    "softsign": F.softsign,
}
# activation codes of csrc/group_norm_act.cu
_ACT_CODES = {None: 0, "relu": 1, "gelu": 2, "tanh": 3, "softsign": 4}
_MAX_CHANNELS = 1024  # one thread per channel at least, in one block


def _check_args(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                num_groups: int, act: Optional[str]) -> None:
    if x.dim() != 4:
        raise ValueError(f"group norm: x {tuple(x.shape)} is not (N,H,W,C)")
    c = x.shape[-1]
    if c % num_groups:
        raise ValueError(f"channels ({c}) must be divisible by num_groups "
                         f"({num_groups})")
    if tuple(scale.shape) != (c,) or tuple(bias.shape) != (c,):
        raise ValueError(f"group norm: scale {tuple(scale.shape)} and bias "
                         f"{tuple(bias.shape)} are not ({c},)")
    if act not in _ACTS:
        raise ValueError(f"unknown activation {act!r}")


def group_norm_reference(x: torch.Tensor, scale: torch.Tensor,
                         bias: torch.Tensor, num_groups: int,
                         eps: float = 1e-5, act: Optional[str] = None
                         ) -> torch.Tensor:
    """Plain version: two-pass f32 GroupNorm(+act) on NHWC, cast to x's
    dtype (the JAX ``group_norm_reference``)."""
    _check_args(x, scale, bias, num_groups, act)
    n, h, w, c = x.shape
    xf = x.float().reshape(n, h * w, num_groups, c // num_groups)
    mean = xf.mean(dim=(1, 3), keepdim=True)
    var = ((xf - mean) ** 2).mean(dim=(1, 3), keepdim=True)
    y = ((xf - mean) * torch.rsqrt(var + eps)).reshape(n, h, w, c)
    y = y * scale.float() + bias.float()
    return _ACTS[act](y).to(x.dtype)


def fused_group_norm_act(x: torch.Tensor, scale: torch.Tensor,
                         bias: torch.Tensor, num_groups: int,
                         eps: float = 1e-5, act: Optional[str] = None
                         ) -> torch.Tensor:
    """GroupNorm + activation (None | 'relu' | 'gelu' | 'tanh' |
    'softsign').  x (N, H, W, C) f32 or bf16; scale, bias (C,) f32;
    ``C % num_groups`` must be 0.  Returns x's shape and dtype."""
    _check_args(x, scale, bias, num_groups, act)
    if all(t.device.type == "cpu" for t in (x, scale, bias)):
        return group_norm_reference(x, scale, bias, num_groups, eps, act)
    _build.check_cuda_tensors("fused_group_norm_act", x.dtype, x=x)
    _build.check_cuda_tensors("fused_group_norm_act", torch.float32,
                              scale=scale, bias=bias)
    if scale.device != x.device:
        raise ValueError(f"fused_group_norm_act: x on {x.device}, scale "
                         f"and bias on {scale.device}")
    n, h, w, c = x.shape
    if c > _MAX_CHANNELS:
        raise ValueError(f"fused_group_norm_act: {c} channels, the kernel "
                         f"takes at most {_MAX_CHANNELS}")
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    lib = _build.load("group_norm_act")
    err = lib.group_norm_act_launch(
        _build.DTYPE_CODES[x.dtype], _ACT_CODES[act], x.data_ptr(),
        scale.data_ptr(), bias.data_ptr(), out.data_ptr(), n, h * w, c,
        num_groups, float(eps), x.device.index, _build.stream_handle(x),
    )
    _build.check(lib, err, "group_norm_act launch")
    backend.count_launch(KERNEL_NAME)
    return out
