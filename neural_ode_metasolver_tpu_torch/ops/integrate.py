"""Fixed-grid explicit Runge-Kutta integration (port of ops/integrate.py).

The JAX package runs the steps as one ``lax.scan``; PyTorch runs eagerly, so
here the step loop is a Python loop over the grid.  The stage loop unrolls
the s stages of any :class:`ButcherTableau` (Euler/RK2/RK3/RK4).

Grid construction follows the reference exactly:
  * from ``n_steps``: ``linspace(t0, t1, n+1)`` (rk_parametric.py:38-47);
  * from ``step_size``: ``arange(ceil(|t1-t0|/h + 1)) * h + t0`` with the
    last point clamped to ``t1`` (rk_parametric.py:23-35), so the final
    interval may be shorter than ``h``.

Carry-dtype rule (JAX ``integrate.py:140-142`` and ``:164-172``): the stage
input is cast to the carry dtype before each RHS call, and the step combines
in at least float32 before the new carry is cast back, so bf16 activations
keep a bf16 carry while the tableau arithmetic stays in f32.

``remat=True`` runs each step under ``torch.utils.checkpoint`` (the JAX
``jax.checkpoint`` of the scan body, ``integrate.py:175``): a backward keeps
only the steps' input carries and recomputes each step's stages.
"""
from __future__ import annotations

import math
from typing import Callable, Optional

import torch
from torch.utils.checkpoint import checkpoint

from .tableau import ButcherTableau

__all__ = ["make_time_grid", "rk_step", "odeint_final"]

RHS = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]  # rhs(t, y)


def _wide(x: torch.Tensor) -> torch.Tensor:
    """``x`` in its promotion with float32 (bf16 -> f32, f64 stays)."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def make_time_grid(
    t0: float,
    t1: float,
    n_steps: Optional[int] = None,
    step_size: Optional[float] = None,
    dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Integration grid on the host; exactly one of ``n_steps`` /
    ``step_size`` must be given (rk_parametric.py:9-10)."""
    if (n_steps is None) == (step_size is None):
        raise ValueError("exactly one of n_steps / step_size must be given")
    if n_steps is not None:
        return torch.linspace(float(t0), float(t1), int(n_steps) + 1,
                              dtype=dtype)
    t0, t1 = float(t0), float(t1)
    if step_size <= 0:
        raise ValueError(f"step_size must be positive, got {step_size}")
    # step_size is a magnitude; the direction comes from (t1 - t0), so a
    # backward span builds a descending grid
    direction = 1.0 if t1 >= t0 else -1.0
    n_points = int(math.ceil(abs(t1 - t0) / step_size + 1))
    grid = torch.arange(n_points, dtype=dtype) * (direction * step_size) + t0
    clamped = (torch.clamp(grid[-1], max=t1) if direction > 0
               else torch.clamp(grid[-1], min=t1))
    grid[-1] = clamped  # clamp the final point to t1 (rk_parametric.py:31-32)
    return grid


def rk_step(tableau: ButcherTableau, rhs: RHS, y: torch.Tensor,
            t: torch.Tensor, dt: torch.Tensor) -> torch.Tensor:
    """One explicit RK step; returns ``dy = dt * sum_i b_i k_i`` in the
    promoted (>= f32) dtype."""
    ks = []
    for i in range(tableau.stages):
        yi = y
        for j in range(i):
            yi = _wide(yi) + (tableau.w[..., i, j] * dt) * _wide(ks[j])
        ti = t + tableau.c[..., i] * dt
        # RHS inputs stay in the carry dtype (bf16 under mixed precision)
        ks.append(rhs(ti, yi.to(y.dtype)))
    dy = _wide(ks[0]) * (tableau.b[..., 0] * dt)
    for i in range(1, tableau.stages):
        dy = dy + (tableau.b[..., i] * dt) * _wide(ks[i])
    return dy


def odeint_final(
    tableau: ButcherTableau,
    rhs: RHS,
    y0: torch.Tensor,
    t0: float = 0.0,
    t1: float = 1.0,
    *,
    n_steps: Optional[int] = None,
    step_size: Optional[float] = None,
    time_grid: Optional[torch.Tensor] = None,
    remat: bool = False,
) -> torch.Tensor:
    """Integrate over the grid and return only y(t1), in y0's dtype; with
    ``remat`` each step is checkpointed."""
    if time_grid is None:
        time_grid = make_time_grid(
            t0, t1, n_steps=n_steps, step_size=step_size,
            dtype=torch.promote_types(y0.dtype, torch.float32),
        )

    def step(y, t, dt):
        return (_wide(y) + rk_step(tableau, rhs, y, t, dt)).to(y.dtype)

    y = y0
    for k in range(time_grid.shape[0] - 1):
        t = time_grid[k]
        dt = time_grid[k + 1] - time_grid[k]
        y = (checkpoint(step, y, t, dt, use_reentrant=False) if remat
             else step(y, t, dt))
    return y
