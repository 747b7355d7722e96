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
keep a bf16 carry while the tableau arithmetic stays in f32.  The carry
may be a tree (nested tuples, lists and dicts of tensors, JAX
``integrate.py:122-176``), as the continuous adjoint's augmented state
``(y, a, g)`` is: the rule then holds leaf by leaf, each stage input cast to
its own leaf's dtype.

A stacked tableau (c (S, s), w (S, s, s), b (S, s): a fleet's S solvers,
``training/fleet.py``) gives each stage coefficient a leading member axis
(S,), which scales the leading axis of every carry leaf (S, ...): member m
steps with its own tableau, element by element as a single run does.

``remat=True`` runs each step under ``torch.utils.checkpoint`` (the JAX
``jax.checkpoint`` of the scan body, ``integrate.py:175``): a backward keeps
only the steps' input carries and recomputes each step's stages.

``odeint_grid`` returns the trajectory at every grid point; ``odeint`` (the
reference's ``RKParametricSolver.integrate``, rk_parametric.py:89-123)
integrates on the solver grid and interpolates linearly onto the requested
times, a backward-in-time grid included, with exact values at grid points.
"""
from __future__ import annotations

import math
from typing import Callable, Optional, Sequence, Union

import torch
from torch.utils import _pytree as pytree
from torch.utils.checkpoint import checkpoint

from .tableau import ButcherTableau

__all__ = ["make_time_grid", "rk_step", "odeint_grid", "odeint_final",
           "odeint"]

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


def _members(coeff: torch.Tensor, leaf: torch.Tensor) -> torch.Tensor:
    """A stage coefficient shaped to scale ``leaf``: a scalar as it is, a
    fleet's (S,) along the leaf's leading (member) axis, on the leaf's
    device (a tableau built on the host is copied there)."""
    if coeff.dim() == 0:
        return coeff
    return coeff.reshape(coeff.shape + (1,) * (leaf.dim() - coeff.dim())
                         ).to(leaf.device)


def rk_step(tableau: ButcherTableau, rhs: RHS, y, t: torch.Tensor,
            dt: torch.Tensor):
    """One explicit RK step; returns ``dy = dt * sum_i b_i k_i`` in the
    promoted (>= f32) dtype.  ``y`` is a tensor or a tree of them (a tensor
    is the tree of one leaf), and ``rhs`` returns the same structure.  A
    stacked tableau steps each member's slice with its own coefficients;
    the stage times are then (S,)."""
    leaves, spec = pytree.tree_flatten(y)
    ks = []
    for i in range(tableau.stages):
        yi = leaves
        for j in range(i):
            coeff = tableau.w[..., i, j] * dt
            yi = [_wide(a) + _members(coeff, a) * _wide(k)
                  for a, k in zip(yi, ks[j])]
        ti = t + tableau.c[..., i] * dt
        # RHS inputs stay in the carry dtype (bf16 under mixed precision)
        stage = rhs(ti, pytree.tree_unflatten(
            [a.to(leaf.dtype) for a, leaf in zip(yi, leaves)], spec))
        ks.append(pytree.tree_leaves(stage))
    coeff = tableau.b[..., 0] * dt
    dy = [_wide(k) * _members(coeff, k) for k in ks[0]]
    for i in range(1, tableau.stages):
        coeff = tableau.b[..., i] * dt
        dy = [d + _members(coeff, k) * _wide(k) for d, k in zip(dy, ks[i])]
    return pytree.tree_unflatten(dy, spec)


def _add_step(y, dy):
    """The carry after a step, ``(y + dy)`` in y's dtype, leaf by leaf."""
    return pytree.tree_map(lambda a, d: (_wide(a) + d).to(a.dtype), y, dy)


def _steps(tableau: ButcherTableau, rhs: RHS, y0, time_grid: torch.Tensor,
           remat: bool, trajectory: bool):
    """Step over the grid; returns y(grid[-1]) and, with ``trajectory``,
    the carry after every step."""

    def step(y, t, dt):
        return _add_step(y, rk_step(tableau, rhs, y, t, dt))

    y, ys = y0, []
    for k in range(time_grid.shape[0] - 1):
        t = time_grid[k]
        dt = time_grid[k + 1] - time_grid[k]
        y = (checkpoint(step, y, t, dt, use_reentrant=False) if remat
             else step(y, t, dt))
        if trajectory:
            ys.append(y)
    return y, ys


def odeint_grid(tableau: ButcherTableau, rhs: RHS, y0: torch.Tensor,
                time_grid: torch.Tensor, *, remat: bool = False
                ) -> torch.Tensor:
    """The trajectory at every grid point, shape ``(len(grid),
    *y0.shape)``; row 0 is y0."""
    _, ys = _steps(tableau, rhs, y0, time_grid, remat, True)
    return torch.stack([y0] + ys)


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
    return _steps(tableau, rhs, y0, time_grid, remat, False)[0]


def _check_grid_spans(time_grid: torch.Tensor, t: torch.Tensor) -> None:
    """Refuse requested times outside the grid, which interpolation would
    silently extrapolate (the reference asserts the grid's ends,
    rk_parametric.py:94-95); the grid may run backward in time."""
    lo, hi = sorted((float(time_grid[0]), float(time_grid[-1])))
    t_lo, t_hi = float(t.min()), float(t.max())
    if t_lo < lo or t_hi > hi:
        raise ValueError(
            f"requested times [{t_lo}, {t_hi}] fall outside the "
            f"integration grid [{lo}, {hi}]; interpolation would "
            f"silently extrapolate")


def odeint(
    tableau: ButcherTableau,
    rhs: RHS,
    y0: torch.Tensor,
    t: Union[torch.Tensor, Sequence[float]],
    *,
    n_steps: Optional[int] = None,
    step_size: Optional[float] = None,
    time_grid: Optional[torch.Tensor] = None,
    remat: bool = False,
) -> torch.Tensor:
    """The solution at the requested times ``t``, shape ``(len(t),
    *y0.shape)``: integrate on the solver grid, then interpolate linearly
    (rk_parametric.py:89-123).  With no ``n_steps``, ``step_size`` or
    ``time_grid`` the grid is ``t`` itself (rk_parametric.py:20)."""
    dtype = torch.promote_types(y0.dtype, torch.float32)
    t = torch.as_tensor(t, dtype=dtype)
    if time_grid is None and n_steps is None and step_size is None:
        time_grid = t
    else:
        if time_grid is None:
            time_grid = make_time_grid(t[0], t[-1], n_steps=n_steps,
                                       step_size=step_size, dtype=dtype)
        time_grid = torch.as_tensor(time_grid, dtype=dtype)
        _check_grid_spans(time_grid, t)
    ys = odeint_grid(tableau, rhs, y0, time_grid, remat=remat)
    # searchsorted needs an ascending sequence: a backward grid flips the
    # sign of the grid and the requested times
    sign = 1.0 if float(time_grid[-1]) >= float(time_grid[0]) else -1.0
    idx = torch.searchsorted(sign * time_grid, sign * t, side="left").clamp(
        1, time_grid.shape[0] - 1)
    t_lo, t_hi = time_grid[idx - 1], time_grid[idx]
    frac = (t - t_lo) / (t_hi - t_lo)
    # a requested time on a grid point takes its value with no rounding
    frac = torch.where(t == t_hi, torch.ones_like(frac), frac)
    frac = torch.where(t == t_lo, torch.zeros_like(frac), frac)
    frac = frac.reshape((t.shape[0],) + (1,) * (ys.dim() - 1))
    y_lo, y_hi = ys[idx - 1], ys[idx]
    return (y_lo + (y_hi - y_lo) * frac).to(ys.dtype)
