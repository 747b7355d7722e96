"""Kernel B1: stride-1 SAME 3x3 convolution, NHWC x HWIO -> NHWC, with its
backward.

Port of ``ops/pallas_im2col.py::conv3x3_im2col_gemm``.  The CUDA kernel
(``csrc/conv3x3.cu`` over ``csrc/conv3x3.cuh``) runs the TPU kernel's GEMM,
(N*H*W, 9*Cin) x (9*Cin, Cout), as an implicit GEMM: each K step's patch
rows are gathered straight into shared memory, so the 9x im2col matrix is
never formed.  bf16 products run on the tensor cores (``wgmma``), f32 ones
as full-f32 FMAs; sums are f32 and the output is rounded once.

``conv3x3_same`` is differentiable.  When a gradient can flow it is the
apply of an ``autograd.Function`` whose backward runs only what
``ctx.needs_input_grad`` asks for, on hand-written kernels too:
  * dgrad, dx = conv3x3_same(dy, w') with w'[a, b, co, ci] = w[2-a, 2-b, ci,
    co]: kernel B1 itself with Cin and Cout swapped, counted as
    ``conv3x3_dgrad``;
  * wgrad, dW[kh, kw, ci, co] = sum over (n, h, w) of x[n, h+kh-1, w+kw-1,
    ci] * dy[n, h, w, co], zero-padded: ``csrc/conv3x3_wgrad.cu``, counted
    as ``conv3x3_wgrad``.
The Pallas kernel has no VJP (JAX differentiates XLA's conv); these are the
backward the port's training path needs.

Every wrapper launches its kernel for CUDA tensors and takes the plain
version (``reference_conv3x3``, ``reference_conv3x3_wgrad``) only for CPU
tensors; there is no fallback.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from .. import _build, backend

__all__ = ["conv3x3_same", "conv3x3_dgrad", "conv3x3_wgrad",
           "reference_conv3x3", "reference_conv3x3_wgrad", "flip_weights",
           "wgrad_splits", "conv3x3_f32"]

KERNEL_NAME = "conv3x3_same"
DGRAD_NAME = "conv3x3_dgrad"
WGRAD_NAME = "conv3x3_wgrad"

# pixels per K step of the wgrad kernel, by dtype (csrc/conv3x3_wgrad.cu)
WGRAD_BK = {torch.float32: 64, torch.bfloat16: 128}


def _wide(t: torch.Tensor) -> torch.Tensor:
    """``t`` in its promotion with float32 (bf16 -> f32, f64 stays)."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


def conv3x3_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """3x3 SAME conv of inputs upcast to at least f32, NHWC x HWIO -> NHWC
    in that type."""
    y = F.conv2d(_wide(x).permute(0, 3, 1, 2), _wide(w).permute(3, 2, 0, 1),
                 padding=1)
    return y.permute(0, 2, 3, 1)


def reference_conv3x3(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain version: f32-accumulated conv cast to x's dtype (mirrors the
    JAX ``reference_conv3x3`` with ``preferred_element_type=f32``)."""
    return conv3x3_f32(x, w).to(x.dtype).contiguous()


def flip_weights(w: torch.Tensor) -> torch.Tensor:
    """w' of the dgrad: (3, 3, Cin, Cout) -> (3, 3, Cout, Cin), taps
    reversed, contiguous."""
    return w.flip(0, 1).transpose(2, 3).contiguous()


def reference_conv3x3_wgrad(x: torch.Tensor, dy: torch.Tensor
                            ) -> torch.Tensor:
    """Plain wgrad: nine (Cin, P) x (P, Cout) products of the zero-padded,
    shifted x and dy, P = N*H*W, in at least f32, rounded once to x's
    dtype.  x (N, H, W, Cin), dy (N, H, W, Cout) -> (3, 3, Cin, Cout)."""
    n, h, wd, cin = x.shape
    cout = dy.shape[3]
    xp = F.pad(_wide(x), (0, 0, 1, 1, 1, 1))
    d = _wide(dy).reshape(-1, cout)
    taps = [xp[:, a:a + h, b:b + wd].reshape(-1, cin).t() @ d
            for a in range(3) for b in range(3)]
    return torch.stack(taps).reshape(3, 3, cin, cout).to(x.dtype)


def _check_shapes(what: str, x: torch.Tensor, w: torch.Tensor) -> None:
    if x.dim() != 4 or w.dim() != 4 or w.shape[:2] != (3, 3) \
            or w.shape[2] != x.shape[3]:
        raise ValueError(f"{what}: x {tuple(x.shape)} and w "
                         f"{tuple(w.shape)} are not (N,H,W,C) and (3,3,C,Co)")


def _launch_conv(x: torch.Tensor, w: torch.Tensor, name: str
                 ) -> torch.Tensor:
    """Kernel B1 on CUDA tensors (counted under ``name``), the plain version
    on CPU tensors."""
    if x.device.type == "cpu" and w.device.type == "cpu":
        return reference_conv3x3(x, w)
    _build.check_cuda_tensors(name, x.dtype, x=x, w=w)
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
    _build.check(lib, err, f"{name} launch")
    backend.count_launch(name)
    return out


def conv3x3_dgrad(dy: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """dx of y = conv3x3_same(x, w): kernel B1 on (dy, flip_weights(w)).
    dy (N, H, W, Cout), w (3, 3, Cin, Cout) -> (N, H, W, Cin)."""
    if w.dim() != 4 or dy.dim() != 4 or w.shape[3] != dy.shape[3]:
        raise ValueError(f"conv3x3_dgrad: dy {tuple(dy.shape)} and w "
                         f"{tuple(w.shape)} are not (N,H,W,Co), (3,3,C,Co)")
    return _launch_conv(dy, flip_weights(w), DGRAD_NAME)


def wgrad_splits(n: int, h: int, w: int, cin: int, cout: int,
                 dtype: torch.dtype, sm_count: int) -> int:
    """How many K ranges the wgrad kernel sums separately: about one block
    per SM over the (Cin, Cout) tiles, at most one per K step.  It depends
    on shapes and the SM count only, so a launch repeats its bits."""
    bk = WGRAD_BK[dtype]
    ch = 128 // (torch.finfo(dtype).bits // 8)  # channels per 128-byte row
    tiles = math.ceil(cin / ch) * math.ceil(cout / ch)
    steps = math.ceil(n * h * w / bk)
    return max(1, min(steps, math.ceil(sm_count / tiles)))


def conv3x3_wgrad(x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """dW of y = conv3x3_same(x, w), in x's dtype: f32 sums rounded once.
    x (N, H, W, Cin), dy (N, H, W, Cout) -> (3, 3, Cin, Cout).

    The CUDA kernel splits K = N*H*W over ``wgrad_splits`` ranges, writes
    each range's f32 partial sums to a workspace and adds them in range
    order in a second launch: no float atomics, so two calls give the same
    bits.  One count per call.  A block holds three K steps' input halos
    (BK + 2 W + 2 pixel rows each), so images wider than about 170 pixels
    (bf16; 230 in f32) do not fit its shared memory and the launch
    raises."""
    if x.dim() != 4 or dy.dim() != 4 or x.shape[:3] != dy.shape[:3]:
        raise ValueError(f"conv3x3_wgrad: x {tuple(x.shape)} and dy "
                         f"{tuple(dy.shape)} are not (N,H,W,C), (N,H,W,Co)")
    if x.device.type == "cpu" and dy.device.type == "cpu":
        return reference_conv3x3_wgrad(x, dy)
    _build.check_cuda_tensors(WGRAD_NAME, x.dtype, x=x, dy=dy)
    n, h, wd, cin = x.shape
    cout = dy.shape[3]
    out = torch.empty((3, 3, cin, cout), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    if n * h * wd == 0:
        return out.zero_()
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    splits = wgrad_splits(n, h, wd, cin, cout, x.dtype, sms)
    ws = torch.empty((splits, 9, cin, cout), dtype=torch.float32,
                     device=x.device)
    lib = _build.load("conv3x3_wgrad")
    err = lib.conv3x3_wgrad_launch(
        _build.DTYPE_CODES[x.dtype], x.data_ptr(), dy.data_ptr(),
        ws.data_ptr(), out.data_ptr(), n, h, wd, cin, cout, splits,
        x.device.index, _build.stream_handle(x),
    )
    _build.check(lib, err, "conv3x3_wgrad launch")
    backend.count_launch(WGRAD_NAME)
    return out


class _Conv3x3(torch.autograd.Function):
    """Forward B1; backward B1 dgrad and the wgrad kernel, each only when
    asked for."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return _launch_conv(x, w, KERNEL_NAME)

    @staticmethod
    @once_differentiable
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dy = dy.contiguous()
        dx = conv3x3_dgrad(dy, w) if ctx.needs_input_grad[0] else None
        dw = conv3x3_wgrad(x, dy) if ctx.needs_input_grad[1] else None
        return dx, dw


def conv3x3_same(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (N, H, W, Cin), w (3, 3, Cin, Cout) of x's dtype -> (N, H, W,
    Cout); differentiable in x and w."""
    _check_shapes("conv3x3_same", x, w)
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return _Conv3x3.apply(x, w)
    return _launch_conv(x, w, KERNEL_NAME)
