"""GeLUpoly, the flagship's activation, as one CUDA kernel each way.

GeLUpoly is the exact-erf GELU written as ``0.5 * x * (1 + tanh(t *
q(t^2)))`` with ``t = clamp(x, -8, 8)`` and q of degree 4 (JAX
``nn.py::gelu_poly``; max |diff| to the exact form 3.4e-6 in f32).  On the
TPU, XLA fused it into the code around it; in eager PyTorch the
composition, ``gelu_poly_reference``, is about 15 aten kernels forward and
22 backward, and autograd keeps about nine intermediates a call.  The
kernels of ``csrc/gelu_poly.cu`` do it in one pass each way: the forward
reads x and writes y, the backward reads x and the output gradient and
writes dx, recomputing everything from x.  Both compute in f32 and round
once to x's dtype (f32 or bf16), as kernel B3 does for its activation.

``fused_gelu_poly`` launches the forward kernel for a CUDA tensor, inside an
``autograd.Function`` that saves x alone and whose backward is the
backward kernel; each launch is counted (``gelu_poly``, ``gelu_poly_bwd``).
A CUDA tensor must be contiguous, f32 or bf16, or it raises.  A CPU tensor
takes the composition unchanged, with autograd through it, so CPU runs
compute what the JAX package computes.  The ``autograd.Function`` takes the
plain versions in the kernels' places for CPU tensors: the composition
forward and ``gelu_poly_backward_reference``, the analytic derivative
(``gelu_poly_backward`` picks the backward by device).

Without a gradient the forward kernel launches directly; while
``torch.export`` traces, such a call is the custom op ``nodems::gelu_poly``
(``ops/library.py``).  Under ``torch.func.vmap`` (``parallel/ensemble.py``
runs a user's RHS so) a second Function with the same forward and backward
applies itself to the unbatched tensor, since the kernels are elementwise.
"""
from __future__ import annotations

import torch

from torch.autograd.function import once_differentiable

from .. import _build, backend

__all__ = ["GELU_TANH_KERNEL_COEFFS", "fused_gelu_poly",
           "gelu_poly_backward", "gelu_poly_reference",
           "gelu_poly_backward_reference"]

KERNEL_NAME = "gelu_poly"
BWD_KERNEL_NAME = "gelu_poly_bwd"

# erf(x/sqrt2) ~= tanh(x * q(x^2)), q of degree 4 (JAX nn.py:353-368);
# csrc/gelu_poly.cu holds the same five numbers
GELU_TANH_KERNEL_COEFFS = (
    0.7978281363504355, 0.036468789125448826, -0.0001248603561668213,
    -3.058127220985254e-05, 1.119098134045954e-06,
)
CLAMP = 8.0


def gelu_poly_reference(x: torch.Tensor) -> torch.Tensor:
    """GeLUpoly composed of aten ops in x's dtype, with |x| clamped at 8:
    what the JAX package computes, and the CPU path."""
    t = torch.clamp(x, -CLAMP, CLAMP)
    t2 = t * t
    cs = GELU_TANH_KERNEL_COEFFS
    q = torch.full_like(x, cs[-1])
    for c in cs[-2::-1]:
        q = q * t2 + c
    phi = 0.5 * torch.tanh(t * q) + 0.5
    return (x * phi).to(x.dtype)


def gelu_poly_backward_reference(x: torch.Tensor, g: torch.Tensor
                                 ) -> torch.Tensor:
    """dx of ``gelu_poly`` at x for the output gradient g: ``g * (phi + x
    * 0.5 * (1 - tanh(z)^2) * (q + 2 t^2 q'(t^2)) * [-8 <= x <= 8])`` with
    ``z = t * q(t^2)``, computed in f32 (f64 for f64 x) and rounded once
    to x's dtype: the backward kernel's arithmetic.  The clamp's mask is
    inclusive, as ``torch.clamp``'s backward is."""
    xf = x.to(torch.promote_types(x.dtype, torch.float32))
    t = torch.clamp(xf, -CLAMP, CLAMP)
    s = t * t
    cs = GELU_TANH_KERNEL_COEFFS
    q = torch.full_like(xf, cs[-1])
    for c in cs[-2::-1]:
        q = q * s + c
    dq = torch.full_like(xf, 4 * cs[4])
    for k in (3, 2, 1):
        dq = dq * s + k * cs[k]
    th = torch.tanh(t * q)
    inside = (xf >= -CLAMP) & (xf <= CLAMP)
    slope = xf * 0.5 * (1.0 - th * th) * (q + 2.0 * s * dq)
    d = (0.5 * th + 0.5) + torch.where(inside, slope, torch.zeros_like(xf))
    return (g.to(xf.dtype) * d).to(x.dtype)


_FNS = []  # [forward launch, backward launch, library], once loaded


def _entry_points():
    if not _FNS:
        lib = _build.load("gelu_poly")
        _FNS.extend((lib.gelu_poly_launch, lib.gelu_poly_bwd_launch, lib))
    return _FNS


def _code(what: str, x: torch.Tensor) -> int:
    """x's dtype code, or raise unless x is a contiguous f32 or bf16 CUDA
    tensor (the caller has checked the device)."""
    code = _build.DTYPE_CODES.get(x.dtype)
    if code is None or not x.is_contiguous():
        raise ValueError(f"{what}: x must be a contiguous float32 or "
                         f"bfloat16 CUDA tensor, got {x.dtype}, contiguous "
                         f"{x.is_contiguous()}")
    return code


def _forward(x: torch.Tensor) -> torch.Tensor:
    """The forward kernel for a CUDA tensor, the composition for a CPU
    tensor."""
    if not x.is_cuda:
        return gelu_poly_reference(x)
    code = _code(KERNEL_NAME, x)
    y = torch.empty_like(x)
    n = y.numel()
    if n:
        fwd, _, lib = _entry_points()
        device = x.get_device()
        err = fwd(code, x.data_ptr(), y.data_ptr(), n, device,
                  _build.stream_handle(x))
        if err:
            _build.check(lib, err, "gelu_poly launch")
        backend.count_launch(KERNEL_NAME)
    return y


def gelu_poly_backward(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """dx of GeLUpoly at x for the output gradient g (of x's shape and
    dtype): the backward kernel for CUDA tensors (x as the forward takes
    it, g of any strides), the analytic derivative
    ``gelu_poly_backward_reference`` for CPU tensors."""
    if not x.is_cuda:
        return gelu_poly_backward_reference(x, g)
    code = _code(BWD_KERNEL_NAME, x)
    if g.dtype != x.dtype or g.device != x.device or g.shape != x.shape:
        raise ValueError(f"{BWD_KERNEL_NAME}: g {g.dtype} {tuple(g.shape)} "
                         f"on {g.device}, x {x.dtype} {tuple(x.shape)} on "
                         f"{x.device}")
    g = g.contiguous()
    dx = torch.empty_like(x)
    n = dx.numel()
    if n:
        _, bwd, lib = _entry_points()
        err = bwd(code, x.data_ptr(), g.data_ptr(), dx.data_ptr(), n,
                  x.get_device(), _build.stream_handle(x))
        if err:
            _build.check(lib, err, "gelu_poly_bwd launch")
        backend.count_launch(BWD_KERNEL_NAME)
    return dx


@once_differentiable
def _vjp(ctx, g):
    """Both Functions' backward: the backward kernel from the saved x."""
    if not ctx.needs_input_grad[0]:
        return None
    x, = ctx.saved_tensors
    return gelu_poly_backward(x, g)


class _GeluPoly(torch.autograd.Function):
    """Forward kernel; backward kernel, from the saved x alone.  A
    ``forward(ctx, x)`` Function, for eager autograd: the ``apply`` of one
    with ``setup_context`` binds its arguments by ``inspect.signature`` on
    every call, and with ``_GeluPolyT`` alone the flagship train step (138
    calls with a gradient) trained 14-22% fewer images a second (H100,
    torch 2.11)."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return _forward(x)

    backward = staticmethod(_vjp)


class _GeluPolyT(torch.autograd.Function):
    """``_GeluPoly`` for torch.func's transforms, which need
    ``setup_context``: under ``vmap`` it applies itself to the unbatched
    tensor, since the kernels are elementwise."""

    @staticmethod
    def forward(x):
        return _forward(x)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(inputs[0])

    backward = staticmethod(_vjp)

    @staticmethod
    def vmap(info, in_dims, x):
        return _GeluPolyT.apply(x.contiguous()), in_dims[0]


def fused_gelu_poly(x: torch.Tensor) -> torch.Tensor:
    """GeLUpoly of x, in x's shape and dtype; differentiable.  The kernels
    for a CUDA tensor (contiguous, f32 or bf16, else it raises), the
    composition ``gelu_poly_reference`` for a CPU tensor."""
    if not x.is_cuda:
        return gelu_poly_reference(x)
    if torch._C._are_functorch_transforms_active():  # torch.func.vmap, ...
        return _GeluPolyT.apply(x)
    if torch.is_grad_enabled() and x.requires_grad:
        return _GeluPoly.apply(x)
    if backend.kernel_ops():
        return torch.ops.nodems.gelu_poly(x)  # ops/library.py
    return _forward(x)
