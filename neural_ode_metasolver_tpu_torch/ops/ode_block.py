"""Kernel B2: the RK2(u) solve of the flagship ODE block, forward only.

Port of ``ops/pallas_ode_block.py::ode_block_rk2_forward``.  It solves
``dy/dt = f(y) = conv2(gelu(conv1(gelu(y))))`` (PreBasicBlock2 with NF norms
and exact GELU) over [0, 1] in ``n_steps`` uniform RK2 steps, with
b2 = 1/(2u), b1 = 1 - b2, dt = 1/n_steps.  The Pallas kernel kept the whole
solve of a batch tile in VMEM; on the H100 one image's state does not fit
in a block's shared memory, so the solve runs as a schedule of launches
(``launch_schedule``): one elementwise GELU of y0, then four launches per
step of the implicit-GEMM conv of ``csrc/ode_block_rk2.cu`` (f32: the
core of ``csrc/conv3x3_f32.cuh`` on ``conv3x3_f32_plan``'s tile), each with
an epilogue that writes the GELU'd value its consumer needs.  A solve of n
steps is 4 n + 1 launches, each counted.

Rounding points are the Pallas kernel's, in the kernel and in the plain
version alike: h1 = conv1(gelu(y)) is rounded to the compute dtype; k1, k2
and the RK combine stay in f32; the stage input and the new y are rounded
to the compute dtype.  (The model's generic path keeps k in the carry dtype
instead, which is why bf16 results of the two differ by more.)

``ode_block_rk2_forward`` runs the schedule on the kernel for CUDA tensors
and takes the plain version, ``reference_ode_block_rk2``, only for CPU
tensors.  Like the Pallas kernel it has no backward: on CUDA tensors it
raises when a gradient could flow (``backend.check_forward_only``), and the
model takes it only where none can.  ``plain_launch`` is the plain version of one launch, so a CPU test
can run the schedule itself.  Each call is one span ``ode.solve`` (``path``
``b2``, ``steps`` n_steps; ``backend.span``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List

import torch
import torch.nn.functional as F

from .. import _build, backend
from .conv3x3 import _plan_args, conv3x3_f32

__all__ = ["ode_block_rk2_forward", "reference_ode_block_rk2",
           "launch_schedule", "run_schedule", "plain_launch", "Launch"]

KERNEL_NAME = "ode_block_rk2"

# epilogue codes of csrc/conv3x3.cuh
GELU, STAGE1, STAGE2 = 1, 2, 3


@dataclass(frozen=True)
class Launch:
    """One launch of a solve, over named buffers: ``y0`` (the caller's,
    only read), ``y`` (the state), ``g`` (the GELU'd conv input), ``h`` (the
    GELU'd hidden activation), ``k1`` (f32).  ``op`` "gelu" writes
    ``out = gelu(x)``; "conv" convolves ``x`` with weight ``w`` and runs
    epilogue ``epilogue`` with coefficient ``a``: STAGE1 reads ``y`` and
    writes k1, STAGE2 reads ``y`` and k1 and also writes the gelu of the new
    state to ``aux`` unless it is empty."""
    op: str
    x: str
    out: str
    w: str = ""
    epilogue: int = 0
    y: str = ""
    aux: str = ""
    a: float = 0.0


def _rk2_coeffs(u: float, n_steps: int):
    if not u > 0:
        raise ValueError(f"u must be > 0 (pass the clamped u~), got {u}")
    if int(n_steps) < 1:
        raise ValueError(f"n_steps must be >= 1, got {n_steps}")
    b2 = 1.0 / (2.0 * u)
    return 1.0 - b2, b2, 1.0 / int(n_steps)


def _gelu_rounded(x: torch.Tensor) -> torch.Tensor:
    """Exact GELU computed in f32, rounded to x's dtype (Pallas ``_gelu``)."""
    return F.gelu(x.float()).to(x.dtype)


def reference_ode_block_rk2(y0: torch.Tensor, w1: torch.Tensor,
                            w2: torch.Tensor, u: float, n_steps: int
                            ) -> torch.Tensor:
    """Plain version with the kernel's rounding points; convs are f32
    ``F.conv2d`` on upcast inputs.  y0 (N, H, W, C); w1, w2 (3, 3, C, C)."""
    b1, b2, dt = _rk2_coeffs(u, n_steps)
    cd = y0.dtype
    w1, w2 = w1.to(cd), w2.to(cd)

    def f(y):
        h1 = conv3x3_f32(_gelu_rounded(y), w1).to(cd)
        return conv3x3_f32(_gelu_rounded(h1), w2)  # f32

    y = y0
    for _ in range(int(n_steps)):
        k1 = f(y)
        k2 = f((y.float() + (u * dt) * k1).to(cd))
        y = (y.float() + dt * (b1 * k1 + b2 * k2)).to(cd)
    return y.contiguous()


def launch_schedule(u: float, n_steps: int) -> List[Launch]:
    """The launches of one solve, in order (see ``csrc/ode_block_rk2.cu``):
    ``g = gelu(y0)``, then per step gh = gelu(conv1(g)); k1 = conv2(gh),
    g = gelu(y + u dt k1); gh = gelu(conv1(g)); y = y + dt (b1 k1 + b2
    conv2(gh)) in place (from y0 on the first step), g = gelu(y) unless it
    is the last step.  No launch writes y0, and a conv never writes the
    buffer it reads (its blocks read each other's halo)."""
    _, _, dt = _rk2_coeffs(u, n_steps)
    sched = [Launch("gelu", x="y0", out="g")]
    for i in range(int(n_steps)):
        y_prev = "y0" if i == 0 else "y"
        last = i == int(n_steps) - 1
        sched += [
            Launch("conv", x="g", out="h", w="w1", epilogue=GELU),
            Launch("conv", x="h", out="g", w="w2", epilogue=STAGE1,
                   y=y_prev, a=u * dt),
            Launch("conv", x="g", out="h", w="w1", epilogue=GELU),
            Launch("conv", x="h", out="y", w="w2", epilogue=STAGE2,
                   y=y_prev, aux="" if last else "g", a=dt),
        ]
    return sched


LaunchFn = Callable[[Launch, Dict[str, torch.Tensor],
                     Dict[str, torch.Tensor], float, float], None]


def run_schedule(y0: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor,
                 u: float, n_steps: int, launch: LaunchFn) -> torch.Tensor:
    """Run ``launch_schedule(u, n_steps)`` through ``launch(l, buffers,
    weights, b1, b2)`` and return the final state."""
    b1, b2, _ = _rk2_coeffs(u, n_steps)
    bufs = {"y0": y0, "y": torch.empty_like(y0), "g": torch.empty_like(y0),
            "h": torch.empty_like(y0),
            "k1": torch.empty(y0.shape, dtype=torch.float32,
                              device=y0.device)}
    weights = {"w1": w1, "w2": w2}
    for l in launch_schedule(u, n_steps):
        launch(l, bufs, weights, b1, b2)
    return bufs["y"]


def plain_launch(l: Launch, bufs: Dict[str, torch.Tensor],
                 weights: Dict[str, torch.Tensor], b1: float,
                 b2: float) -> None:
    """The plain version of one launch: an f32 conv and the epilogue's
    arithmetic in torch, in the kernel's order."""
    if l.op == "gelu":
        bufs[l.out].copy_(_gelu_rounded(bufs[l.x]))
        return
    cd = bufs[l.x].dtype
    s = conv3x3_f32(bufs[l.x], weights[l.w])
    if l.epilogue == GELU:
        val = _gelu_rounded(s.to(cd))
    elif l.epilogue == STAGE1:
        bufs["k1"].copy_(s)
        val = _gelu_rounded((bufs[l.y].float() + l.a * s).to(cd))
    elif l.epilogue == STAGE2:
        val = (bufs[l.y].float()
               + l.a * (b1 * bufs["k1"] + b2 * s)).to(cd)
        if l.aux:
            bufs[l.aux].copy_(_gelu_rounded(val))
    else:
        raise ValueError(f"unknown epilogue {l.epilogue}")
    bufs[l.out].copy_(val)


def _cuda_launcher(y0: torch.Tensor) -> LaunchFn:
    lib = _build.load("ode_block_rk2")
    code = _build.DTYPE_CODES[y0.dtype]
    dev = y0.device.index
    stream = _build.stream_handle(y0)
    n, h, wd, c = y0.shape
    plan = _plan_args(y0.dtype, n, h, wd, c, c, y0.device)  # f32's plan

    def launch(l, bufs, weights, b1, b2):
        if l.op == "gelu":
            x = bufs[l.x]
            err = lib.ode_block_rk2_gelu_launch(
                code, x.data_ptr(), bufs[l.out].data_ptr(), x.numel(), dev,
                stream)
        else:
            err = lib.ode_block_rk2_conv_launch(
                code, l.epilogue, bufs[l.x].data_ptr(),
                weights[l.w].data_ptr(), bufs[l.out].data_ptr(),
                bufs[l.y].data_ptr() if l.y else None,
                bufs["k1"].data_ptr(),
                bufs[l.aux].data_ptr() if l.aux else None,
                n, h, wd, c, l.a, b1, b2, *plan, dev, stream)
        _build.check(lib, err, f"ode_block_rk2 {l.op} launch")
        backend.count_launch(KERNEL_NAME)

    return launch


def ode_block_rk2_forward(y0: torch.Tensor, w1: torch.Tensor,
                          w2: torch.Tensor, u: float, n_steps: int
                          ) -> torch.Tensor:
    """RK2 solve of the NF/GELU double-conv RHS.

    y0 (N, H, W, C) f32 or bf16; w1, w2 (3, 3, C, C) of y0's dtype; ``u`` is
    the clamped RK2 parameter u~ as a Python float; ``n_steps`` >= 1.
    """
    c = y0.shape[-1]
    if y0.dim() != 4 or tuple(w1.shape) != (3, 3, c, c) \
            or tuple(w2.shape) != (3, 3, c, c):
        raise ValueError(f"ode_block_rk2_forward: y0 {tuple(y0.shape)}, w1 "
                         f"{tuple(w1.shape)}, w2 {tuple(w2.shape)} are not "
                         "(N,H,W,C), (3,3,C,C), (3,3,C,C)")
    u = float(u)
    with backend.span("ode.solve", path="b2", steps=n_steps):
        if backend.kernel_ops():
            return torch.ops.nodems.ode_block_rk2(  # ops/library.py
                y0, w1, w2, u, int(n_steps))
        return _solve(y0, w1, w2, u, n_steps)


def _solve(y0: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor, u: float,
           n_steps: int) -> torch.Tensor:
    """The solve on checked shapes: the kernel's schedule for CUDA
    tensors, the plain version for CPU tensors."""
    if all(t.device.type == "cpu" for t in (y0, w1, w2)):
        return reference_ode_block_rk2(y0, w1, w2, u, n_steps)
    backend.check_forward_only("ode_block_rk2_forward", y0=y0, w1=w1, w2=w2)
    _build.check_cuda_tensors("ode_block_rk2_forward", y0.dtype,
                              y0=y0, w1=w1, w2=w2)
    _rk2_coeffs(u, n_steps)
    if y0.numel() == 0:
        return torch.empty_like(y0)
    return run_schedule(y0, w1, w2, u, n_steps, _cuda_launcher(y0))
