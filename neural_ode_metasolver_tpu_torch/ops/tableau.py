"""Parametric Butcher tableaus as small tensors (port of ops/tableau.py).

A tableau is immutable data: ``c`` (stage times), ``w`` (strictly lower
triangular coupling matrix) and ``b`` (output weights), built by closed-form
constructor functions from the solver parameters ``u``/``v``.  The
constructors take scalar or batched tensors and clip them into the validity
region exactly as the JAX package does (and as the reference's
``torch.clamp`` does):

  * RK2, 1 param u:    sopa/src/solvers/rk_parametric_order2stage2.py:37-62
  * RK3, 2 params u,v: sopa/src/solvers/rk_parametric_order3stage3.py:25-68
  * RK4, 'u1'/'u2'/'u3'/'uv': sopa/src/solvers/rk_parametric_order4stage4.py
  * Euler:             sopa/src/solvers/euler.py:23-32

The fixed classical tableaus (midpoint, Heun, RK4, Kutta's 3/8) and the
padding and stacking of tableaus of different stage counts along a leading
axis (JAX ``ops/tableau.py:256-328``) are here too: a fleet's solvers
(``training/fleet.py``) are one stacked (S, s, s) tableau.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

__all__ = [
    "ButcherTableau",
    "validity_eps",
    "euler_tableau",
    "rk2_tableau",
    "rk3_tableau",
    "rk4_tableau",
    "midpoint_tableau",
    "heun_tableau",
    "rk4_standard_tableau",
    "rk38_tableau",
    "pad_tableau",
    "stack_tableaus",
]


class ButcherTableau(NamedTuple):
    """Explicit Runge-Kutta tableau: ``c`` (..., s), ``w`` (..., s, s),
    ``b`` (..., s)."""

    c: torch.Tensor
    w: torch.Tensor
    b: torch.Tensor

    @property
    def stages(self) -> int:
        return self.b.shape[-1]


def validity_eps(dtype: torch.dtype) -> float:
    """Dtype-dependent clamp epsilon (rk_parametric_order2stage2.py:56-62):
    float64 parameters clamp with float32 eps, anything narrower with
    float16 eps."""
    if dtype == torch.float64:
        return float(np.finfo(np.float32).eps)
    return float(np.finfo(np.float16).eps)


def _stack_rows(rows):
    """Rows of equally shaped tensors -> (..., s, s) matrix."""
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def euler_tableau(dtype: torch.dtype = torch.float32) -> ButcherTableau:
    """Forward Euler: c=[0], b=[1], w=[[0]]."""
    return ButcherTableau(
        c=torch.zeros((1,), dtype=dtype),
        w=torch.zeros((1, 1), dtype=dtype),
        b=torch.ones((1,), dtype=dtype),
    )


def rk2_tableau(u: torch.Tensor) -> ButcherTableau:
    """Order-2 stage-2 family: c = (0, u~), b2 = 1/(2 u~), b1 = 1 - b2,
    w21 = u~, with u~ = clip(u, eps, 1).  u = 1/2 is Midpoint, u = 1 Heun."""
    u = torch.as_tensor(u)
    eps = validity_eps(u.dtype)
    u_ = torch.clamp(u, eps, 1.0)
    zero = torch.zeros_like(u_)
    b2 = 1.0 / (2.0 * u_)
    b1 = 1.0 - b2
    return ButcherTableau(
        c=torch.stack([zero, u_], dim=-1),
        w=_stack_rows([[zero, zero], [u_, zero]]),
        b=torch.stack([b1, b2], dim=-1),
    )


def _nudge_degenerate(u_, v_, eps):
    """If u~ == v~, nudge one of them by eps (rk3: :64-68, rk4 uv: :152-156)."""
    eq = u_ == v_
    lo = u_ < 1.0 - eps
    v_new = torch.where(eq & lo, u_ + eps, v_)
    u_new = torch.where(eq & ~lo, v_ - eps, u_)
    return u_new, v_new


def rk3_tableau(u: torch.Tensor, v: torch.Tensor) -> ButcherTableau:
    """Order-3 stage-3 two-parameter family ('uv'), with clip-to-[eps, 1]
    validity and the u == v nudge."""
    u = torch.as_tensor(u)
    v = torch.as_tensor(v)
    eps = validity_eps(u.dtype)
    u_ = torch.clamp(u, eps, 1.0)
    v_ = torch.clamp(v, eps, 1.0)
    u_, v_ = _nudge_degenerate(u_, v_, eps)
    zero = torch.zeros_like(u_)

    v_sub_u = v_ - u_
    b2 = (2.0 - 3.0 * v_) / (6.0 * u_ * (-v_sub_u))
    b3 = (2.0 - 3.0 * u_) / (6.0 * v_ * v_sub_u)
    b1 = 1.0 - b2 - b3

    w32 = v_ * (v_ - u_) / (u_ * (2.0 - 3.0 * u_))
    w31 = v_ - w32
    return ButcherTableau(
        c=torch.stack([zero, u_, v_], dim=-1),
        w=_stack_rows([[zero, zero, zero], [u_, zero, zero],
                       [w31, w32, zero]]),
        b=torch.stack([b1, b2, b3], dim=-1),
    )


def rk4_tableau(
    u: torch.Tensor,
    v: Optional[torch.Tensor] = None,
    parameterization: str = "u2",
) -> ButcherTableau:
    """Order-4 stage-4 families (rk_parametric_order4stage4.py:40-156):
    'u1', 'u2', 'u3' clamp u to [eps, 1-eps]; 'uv' clamps u into whichever
    half of (0, 1/2) / (1/2, 1) it falls in (u = 1/2 is a pole of the b
    formulas), clamps v to [eps, 1-eps] and nudges u == v."""
    u = torch.as_tensor(u)
    eps = validity_eps(u.dtype)
    zero = torch.zeros_like(u)
    one = torch.ones_like(u)
    half = 0.5 * one

    if parameterization == "uv":
        if v is None:
            raise ValueError("rk4 'uv' parameterization requires v")
        v = torch.as_tensor(v)
        u_ = torch.where(
            u < 0.5,
            torch.clamp(u, eps, 0.5 - eps),
            torch.clamp(u, 0.5 + eps, 1.0 - eps),
        )
        v_ = torch.clamp(v, eps, 1.0 - eps)
        u_, v_ = _nudge_degenerate(u_, v_, eps)
        c2, c3 = u_, v_
        sub_u = 1.0 - u_
        sub_v = 1.0 - v_
        v_sub_u = v_ - u_
        b2 = (2.0 * v_ - 1.0) / (12.0 * u_ * sub_u * v_sub_u)
        b3 = (1.0 - 2.0 * u_) / (12.0 * v_ * sub_v * v_sub_u)
        b4 = (6.0 * u_ * v_ + 3.0 - 4.0 * u_ - 4.0 * v_) / (
            12.0 * sub_u * sub_v)
        b1 = 1.0 - b2 - b3 - b4
    else:
        u_ = torch.clamp(u, eps, 1.0 - eps)
        if parameterization == "u1":
            c2, c3 = half, zero
            b1, b2, b3, b4 = 1.0 / 6.0 - u_, 2.0 / 3.0 * one, u_, one / 6.0
        elif parameterization == "u2":
            c2, c3 = half, half
            b1, b2, b3, b4 = one / 6.0, 2.0 / 3.0 - u_, u_, one / 6.0
        elif parameterization == "u3":
            c2, c3 = one, half
            b1, b2, b3, b4 = one / 6.0, 1.0 / 6.0 - u_, 2.0 / 3.0 * one, u_
        else:
            raise ValueError(
                f"Unknown parameterization {parameterization!r} for rk4"
            )
    c4 = one

    # Stage couplings (rk_parametric_order4stage4.py:94-124): w43 from the
    # last row, (w32, w42) by Cramer's rule, the rest from row sums = c.
    w43 = b3 * (1.0 - c3) / b4
    A00 = b3 * c3 * c2
    A01 = b4 * c4 * c2
    A10 = b3
    A11 = b4
    B0 = 0.125 - b4 * c4 * c3 * w43
    B1 = b2 * (1.0 - c2)
    detA = A00 * A11 - A01 * A10
    w32 = (B0 * A11 - B1 * A01) / detA
    w42 = (A00 * B1 - A10 * B0) / detA
    w41 = c4 - (w42 + w43)
    w31 = c3 - w32
    w21 = c2
    return ButcherTableau(
        c=torch.stack([zero, c2, c3, c4], dim=-1),
        w=_stack_rows([[zero, zero, zero, zero], [w21, zero, zero, zero],
                       [w31, w32, zero, zero], [w41, w42, w43, zero]]),
        b=torch.stack([b1, b2, b3, b4], dim=-1),
    )


def _const_tableau(c, w_rows, b, dtype) -> ButcherTableau:
    """A fixed tableau from its rows (computed in f64, then cast)."""
    s = len(b)
    w = np.zeros((s, s), dtype=np.float64)
    for i, row in enumerate(w_rows):
        w[i, :len(row)] = row
    return ButcherTableau(
        c=torch.as_tensor(np.asarray(c, dtype=np.float64)).to(dtype),
        w=torch.as_tensor(w).to(dtype),
        b=torch.as_tensor(np.asarray(b, dtype=np.float64)).to(dtype),
    )


def midpoint_tableau(dtype: torch.dtype = torch.float32) -> ButcherTableau:
    """The midpoint method, rk2_tableau(1/2)
    (rk_parametric_order2stage2.py:6)."""
    return _const_tableau([0.0, 0.5], [[], [0.5]], [0.0, 1.0], dtype)


def heun_tableau(dtype: torch.dtype = torch.float32) -> ButcherTableau:
    """Heun's method, rk2_tableau(1) (rk_parametric_order2stage2.py:13)."""
    return _const_tableau([0.0, 1.0], [[], [1.0]], [0.5, 0.5], dtype)


def rk4_standard_tableau(dtype: torch.dtype = torch.float32
                         ) -> ButcherTableau:
    """Classical RK4, rk4_tableau(1/3, 'u2')
    (rk_parametric_order4stage4.py:6)."""
    return _const_tableau(
        [0.0, 0.5, 0.5, 1.0],
        [[], [0.5], [0.0, 0.5], [0.0, 0.0, 1.0]],
        [1 / 6, 1 / 3, 1 / 3, 1 / 6], dtype)


def rk38_tableau(dtype: torch.dtype = torch.float32) -> ButcherTableau:
    """Kutta's 3/8 rule (rk_parametric_order4stage4.py:13)."""
    return _const_tableau(
        [0.0, 1 / 3, 2 / 3, 1.0],
        [[], [1 / 3], [-1 / 3, 1.0], [1.0, -1.0, 1.0]],
        [1 / 8, 3 / 8, 3 / 8, 1 / 8], dtype)


def pad_tableau(tab: ButcherTableau, stages: int) -> ButcherTableau:
    """Zero-pad a tableau to ``stages`` stages: the padded stages have
    b_i = 0 and zero rows of w, so they add nothing to a step (their RHS
    evaluations are at y and are discarded).  Raises for fewer stages."""
    s = tab.stages
    if s == stages:
        return tab
    if s > stages:
        raise ValueError(f"cannot pad {s}-stage tableau to {stages}")
    p = stages - s
    return ButcherTableau(
        c=torch.nn.functional.pad(tab.c, (0, p)),
        w=torch.nn.functional.pad(tab.w, (0, p, 0, p)),
        b=torch.nn.functional.pad(tab.b, (0, p)),
    )


def stack_tableaus(tabs) -> ButcherTableau:
    """Stack tableaus, padded to the largest stage count, along a leading
    axis: c (S, s), w (S, s, s), b (S, s)."""
    smax = max(t.stages for t in tabs)
    tabs = [pad_tableau(t, smax) for t in tabs]
    return ButcherTableau(
        c=torch.stack([t.c for t in tabs]),
        w=torch.stack([t.w for t in tabs]),
        b=torch.stack([t.b for t in tabs]),
    )
