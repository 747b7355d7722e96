"""Kernel B1: stride-1 SAME 3x3 convolution, NHWC x HWIO -> NHWC.

Port of ``ops/pallas_im2col.py::conv3x3_im2col_gemm``.  The CUDA kernel
(``csrc/conv3x3.cu`` over ``csrc/conv3x3.cuh``) runs the TPU kernel's GEMM,
(N*H*W, 9*Cin) x (9*Cin, Cout), as an implicit GEMM: each K step's patch
rows are gathered straight into shared memory, so the 9x im2col matrix is
never formed.  bf16 products run on the tensor cores (``mma.sync``), f32
ones as full-f32 FMAs; sums are f32 and the output is rounded once.

``conv3x3_same`` launches the kernel for CUDA tensors and takes the plain
version, ``reference_conv3x3``, only for CPU tensors.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import _build, backend

__all__ = ["conv3x3_same", "reference_conv3x3", "conv3x3_f32"]

KERNEL_NAME = "conv3x3_same"


def conv3x3_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """3x3 SAME conv of f32-upcast inputs, NHWC x HWIO -> NHWC f32."""
    y = F.conv2d(x.float().permute(0, 3, 1, 2), w.float().permute(3, 2, 0, 1),
                 padding=1)
    return y.permute(0, 2, 3, 1)


def reference_conv3x3(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain version: f32-accumulated conv cast to x's dtype (mirrors the
    JAX ``reference_conv3x3`` with ``preferred_element_type=f32``)."""
    return conv3x3_f32(x, w).to(x.dtype).contiguous()


def conv3x3_same(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (N, H, W, Cin), w (3, 3, Cin, Cout) of x's dtype -> (N, H, W, Cout)."""
    if x.dim() != 4 or w.dim() != 4 or w.shape[:2] != (3, 3) \
            or w.shape[2] != x.shape[3]:
        raise ValueError(f"conv3x3_same: x {tuple(x.shape)} and w "
                         f"{tuple(w.shape)} are not (N,H,W,C) and (3,3,C,Co)")
    if x.device.type == "cpu" and w.device.type == "cpu":
        return reference_conv3x3(x, w)
    _build.check_cuda_tensors("conv3x3_same", x.dtype, x=x, w=w)
    n, h, wd, cin = x.shape
    cout = w.shape[3]
    out = torch.empty((n, h, wd, cout), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    lib = _build.load("conv3x3")
    err = lib.conv3x3_same_launch(
        _build.DTYPE_CODES[x.dtype], x.data_ptr(), w.data_ptr(),
        out.data_ptr(), n, h, wd, cin, cout, x.device.index,
        _build.stream_handle(x),
    )
    _build.check(lib, err, "conv3x3_same launch")
    backend.count_launch(KERNEL_NAME)
    return out
