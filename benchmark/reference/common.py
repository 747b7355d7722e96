"""Plain float32 PyTorch pieces the references share: the RK2(u) tableau
and its fixed-grid solve, the activations, the precision of held tensors
and operands, cross-entropy, FGSM with a random start, SGD with momentum
and RMSprop, the cyclic learning rate, and the solver-smoothing draw.

Nothing here imports the program under test.  Every function works on
NCHW float32 tensors and reads its weights from a flat dict named as the
benchmark names them (``params.<path>``, conv kernels HWIO).

``precision`` selects the arithmetic, every reference computation running
under ``precision_flags``: ``"f32"`` (full float32, TF32 off), ``"tf32"``
(TF32 on, the control of a float32 configuration) and ``"fp8"`` (the
control of a bfloat16 configuration: every tensor a layer holds where the
program holds bfloat16 (the input, each conv's and activation's output,
the residual sums, the RK stage inputs and state), and every conv and
matmul operand, rounded to float8 e4m3 with a per-tensor scale).
"""
from __future__ import annotations

import contextlib
import math
from typing import Dict, Iterator, List, Sequence

import numpy as np
import torch
import torch.nn.functional as F

PRECISIONS = ("f32", "tf32", "fp8")
_E4M3_MAX = 448.0


@contextlib.contextmanager
def precision_flags(precision: str) -> Iterator[None]:
    """TF32 on for ``"tf32"``, off otherwise, for the duration."""
    if precision not in PRECISIONS:
        raise ValueError(f"unknown precision {precision!r}")
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = cudnn.allow_tf32, matmul.allow_tf32
    cudnn.allow_tf32 = matmul.allow_tf32 = precision == "tf32"
    try:
        yield
    finally:
        cudnn.allow_tf32, matmul.allow_tf32 = saved


def rounded(t: torch.Tensor, precision: str) -> torch.Tensor:
    """``t`` as held or fed in the given precision; under ``"fp8"`` the
    rounding is passed straight through to the gradient."""
    if precision != "fp8":
        return t
    scale = t.detach().abs().amax().clamp_min(1e-30) / _E4M3_MAX
    q = (t.detach() / scale).to(torch.float8_e4m3fn).to(t.dtype) * scale
    return t + (q - t.detach())


def conv(x: torch.Tensor, kernel_hwio: torch.Tensor, stride: int,
         padding: int, bias=None, precision: str = "f32") -> torch.Tensor:
    """A conv of NCHW ``x`` (contiguous, as every layer keeps it) with an
    HWIO kernel."""
    w = kernel_hwio.permute(3, 2, 0, 1).contiguous()
    return F.conv2d(rounded(x, precision), rounded(w, precision), bias,
                    stride=stride, padding=padding)


def linear(x: torch.Tensor, kernel_io: torch.Tensor, bias,
           precision: str = "f32") -> torch.Tensor:
    y = rounded(x, precision) @ rounded(kernel_io, precision)
    return y if bias is None else y + bias


# erf(x/sqrt2) ~= tanh(x * q(x^2)), q of degree 4: the recipe's GeLUpoly
_GELU_POLY = (0.7978281363504355, 0.036468789125448826,
              -0.0001248603561668213, -3.058127220985254e-05,
              1.119098134045954e-06)


def gelu_poly(x: torch.Tensor) -> torch.Tensor:
    t = torch.clamp(x, -8.0, 8.0)
    t2 = t * t
    q = torch.full_like(x, _GELU_POLY[-1])
    for c in _GELU_POLY[-2::-1]:
        q = q * t2 + c
    return x * (0.5 * torch.tanh(t * q) + 0.5)


ACTIVATIONS = {"GeLU": F.gelu, "GeLUpoly": gelu_poly, "ReLU": F.relu}


def group_norm(x: torch.Tensor, scale, bias, groups: int,
               eps: float = 1e-5) -> torch.Tensor:
    return F.group_norm(x, groups, scale, bias, eps)


# ------------------------------------------------------------- solver --


def rk2_tableau(u: float):
    """(a21, b1, b2) of the RK2(u) family, u clipped to [eps16, 1]."""
    eps = float(np.finfo(np.float16).eps)
    u_ = min(max(float(np.float32(u)), eps), 1.0)
    b2 = 1.0 / (2.0 * u_)
    return u_, 1.0 - b2, b2


def rk2_solve(rhs, y: torch.Tensor, u: float, n_steps: int,
              t0: float = 0.0, t1: float = 1.0, hold=None) -> torch.Tensor:
    """y(t1) by ``n_steps`` uniform RK2(u) steps; ``rhs(t, y)``; ``hold``
    rounds the stage input and the new state as the solve holds them."""
    hold = hold or (lambda v: v)
    a21, b1, b2 = rk2_tableau(u)
    grid = torch.linspace(t0, t1, n_steps + 1, dtype=torch.float32).tolist()
    for k in range(n_steps):
        t, dt = grid[k], grid[k + 1] - grid[k]
        k1 = rhs(t, y)
        k2 = rhs(t + a21 * dt, hold(y + (a21 * dt) * k1))
        y = hold(y + dt * (b1 * k1 + b2 * k2))
    return y


# ----------------------------------------------------------- training --


def cross_entropy(logits: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return F.cross_entropy(logits, y)


def step_seeds(generator: torch.Generator, n: int = 3) -> List[int]:
    """A step's seeds (smoothing draw, attack start, data noise), drawn
    from the run's CPU step generator as the step under test draws them."""
    return torch.randint(0, 2 ** 62, (n,), generator=generator).tolist()


def smoothed_u(seed: int, mean_u: float, sigma: float, prob: float,
               kind: str = "normal") -> float:
    """The smoothing draw: with probability ``prob`` u ~ kind(mean_u,
    sigma), set back to mean_u outside mean_u +- 2 sigma."""
    g = torch.Generator().manual_seed(seed)
    mean = torch.tensor(mean_u, dtype=torch.float32)
    gate = bool(torch.rand((), generator=g) < prob)
    std = torch.tensor(sigma, dtype=torch.float32).abs()
    if kind == "normal":
        z = torch.randn((), generator=g, dtype=torch.float32)
    else:
        z = torch.empty((), dtype=torch.float32).cauchy_(generator=g)
    u = mean + std * z
    if not gate or u <= mean - 2.0 * std or u >= mean + 2.0 * std:
        u = mean
    return float(u)


def fgsm_random(loss_of, x: torch.Tensor, seed: int, eps: float,
                alpha: float, mean: Sequence[float], std: Sequence[float]
                ) -> torch.Tensor:
    """FGSM with a uniform random start in normalized NHWC space; the start
    U[0, 1) is drawn on x's device from a generator seeded ``seed``."""
    m = torch.tensor(mean, dtype=x.dtype, device=x.device)
    s = torch.tensor(std, dtype=x.dtype, device=x.device)
    lo, hi = (0.0 - m) / s - x, (1.0 - m) / s - x
    eps_c, alpha_c = eps / s, alpha / s
    g = torch.Generator(device=x.device).manual_seed(seed)
    u = torch.rand(x.shape, generator=g, dtype=x.dtype, device=x.device)
    delta = torch.clamp(eps_c - (2.0 * eps_c) * u, lo, hi).requires_grad_()
    (grad,) = torch.autograd.grad(loss_of(x + delta), delta)
    delta = torch.clamp(delta.detach() + alpha_c * torch.sign(grad),
                        -eps_c, eps_c)
    return x + torch.clamp(delta, lo, hi)


def cyclic_lr(base: float, top: float, step_size_up: int, step: int) -> float:
    """The triangular2 cyclic learning rate at update ``step``."""
    s = float(step_size_up)
    cycle = math.floor(1.0 + step / (2.0 * s))
    x = abs(step / s - 2.0 * cycle + 1.0)
    return base + (top - base) * max(0.0, 1.0 - x) / 2.0 ** (cycle - 1.0)


def learning_rate(opt: dict, step: int) -> float:
    lr = opt["lr"]
    if isinstance(lr, dict):
        return cyclic_lr(lr["base"], lr["max"], lr["step_size_up"], step)
    return float(lr)


@torch.no_grad()
def optimizer_step(opt: dict, params: Dict[str, torch.Tensor],
                   grads: Dict[str, torch.Tensor], state: dict,
                   step: int) -> Dict[str, torch.Tensor]:
    """One SGD (momentum trace) or RMSprop (0.99, eps 1e-8 outside the
    root) update in place, weight decay coupled into the gradient.
    Returns the gradient as the rule received it, decay included."""
    wd = float(opt.get("weight_decay", 0.0))
    lr = learning_rate(opt, step)
    got = {}
    for k, p in params.items():
        g = grads[k] + wd * p
        got[k] = g
        if opt["name"] == "sgd":
            buf = state.setdefault(k, torch.zeros_like(p))
            buf.mul_(float(opt["momentum"])).add_(g)
            p.add_(buf, alpha=-lr)
        elif opt["name"] == "rmsprop":
            nu = state.setdefault(k, torch.zeros_like(p))
            nu.mul_(0.99).addcmul_(g, g, value=0.01)
            p.add_(g / (nu.sqrt() + 1e-8), alpha=-lr)
        else:
            raise ValueError(f"unknown optimizer {opt['name']!r}")
    return got
