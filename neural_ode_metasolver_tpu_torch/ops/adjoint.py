"""Continuous-adjoint differentiation of the fixed-step RK integrator (port
of ops/adjoint.py).

  forward:   y(t1) by the given tableau over the grid, without a graph;
             with ``checkpoint_states`` the n post-step states are kept
             (O(n_steps) tensors of y's size, against the per-stage
             activations that backpropagation through the steps stores)
  backward:  the augmented system d/ds [y, a, g] = [-f, +aᵀ∂f/∂y,
             +aᵀ∂f/∂θ] in the reversed time s (t = t_hi + t_lo - s),
             integrated with the *same* tableau one forward interval at a
             time from a(t1) = dL/dy(t1), y re-seeded at the interval's
             stored upper state (JAX ``_bwd``, ``adjoint.py:127-175``).

Each backward stage evaluates the RHS once and its VJP once (a
``torch.autograd.grad`` on detached leaves under ``enable_grad``), so on the
card a stage runs B1 forward, then its dgrad, and the wgrad only for the
parameters that want a gradient: the attack's forwards run on detached
weights, so their backward computes none (JAX computes it and drops it).

``checkpoint_states=False`` reconstructs y backward from y1 over the whole
span (the O(1)-state variant; ``n_steps_bwd`` then counts all backward
steps, 0 meaning as many as forward).  With ``checkpoint_states`` it counts
the sub-steps of each forward interval (0 meaning 1).

The tableau is the integration method, not a parameter: u and v get no
gradient under the adjoint, as in JAX and torchdiffeq.  The carry rule of
``integrate.py`` holds leaf by leaf: a has y's dtype, g each parameter's,
the combines run in at least f32.
"""
from __future__ import annotations

from typing import Any, Callable, List

import torch
from torch.utils import _pytree as pytree

from .integrate import _steps
from .tableau import ButcherTableau

__all__ = ["odeint_final_adjoint"]

# rhs(params, t, y) -> dy/dt, with the parameters explicit
ParamRHS = Callable[[Any, torch.Tensor, torch.Tensor], torch.Tensor]


def _plain(tree: Any) -> Any:
    """A parameter tree as nested dicts and lists (the model's
    ``ModuleDict`` / ``ParameterDict`` become dicts), its tensors kept."""
    if isinstance(tree, torch.Tensor):
        return tree
    if hasattr(tree, "items"):
        return {k: _plain(v) for k, v in tree.items()}
    return [_plain(v) for v in tree]


def _aug_rhs(rhs: ParamRHS, params: Any, leaves: List[torch.Tensor],
             want: List[int], t_lo, t_hi):
    """The backward augmented RHS at reversed time s: y is re-evaluated on a
    detached leaf, and ``f``'s VJP with a gives a's and g's rates."""

    def aug(s, state):
        y, a, _g = state
        t = t_hi + t_lo - s
        with torch.enable_grad():
            y_ = y.detach().requires_grad_(True)
            fy = rhs(params, t, y_)
            wrt = [y_] + [leaves[i] for i in want]
            grads = torch.autograd.grad(fy, wrt, grad_outputs=a,
                                        allow_unused=True)
        d_y = grads[0] if grads[0] is not None else torch.zeros_like(y)
        d_p = [g if g is not None else torch.zeros_like(leaves[i])
               for g, i in zip(grads[1:], want)]
        return (-fy.detach(), d_y, d_p)

    return aug


class _Adjoint(torch.autograd.Function):
    """y(t1) with the continuous adjoint's gradients for y0 and the
    parameter leaves."""

    @staticmethod
    def forward(ctx, tableau, rhs, rebuild, time_grid, n_steps_bwd,
                checkpoint_states, y0, *leaves):
        params = rebuild(list(leaves))
        y1, ys = _steps(tableau, lambda t, y: rhs(params, t, y), y0,
                        time_grid, False, checkpoint_states)
        ctx.tableau, ctx.rhs, ctx.rebuild = tableau, rhs, rebuild
        ctx.time_grid, ctx.n_steps_bwd = time_grid, n_steps_bwd
        ctx.checkpoint_states = checkpoint_states
        ctx.n_leaves = len(leaves)
        # the post-step states only: the sweep re-seeds each interval at its
        # upper state, so y0 is never read (JAX :97-105); the last is y1
        states = ys[:-1] if checkpoint_states else []
        ctx.save_for_backward(*states, y1, *leaves)
        return y1

    @staticmethod
    def backward(ctx, a1):
        saved = ctx.saved_tensors
        n_leaves = ctx.n_leaves
        ys = list(saved[:len(saved) - n_leaves])
        leaves = [l.detach() for l in saved[len(saved) - n_leaves:]]
        # only leaves that want a gradient get a VJP (the attack's detached
        # weights take none)
        want = [i for i in range(n_leaves) if ctx.needs_input_grad[7 + i]]
        for i in want:
            leaves[i].requires_grad_(True)
        params = ctx.rebuild(leaves)
        tableau, grid = ctx.tableau, ctx.time_grid
        a = a1
        g = [torch.zeros_like(leaves[i]) for i in want]
        if ctx.checkpoint_states:
            m = ctx.n_steps_bwd or 1  # sub-steps a forward interval
            frac = torch.linspace(0.0, 1.0, m + 1, dtype=grid.dtype)
            for k in range(grid.shape[0] - 2, -1, -1):
                t_lo, t_hi = grid[k], grid[k + 1]
                sub = t_lo + (t_hi - t_lo) * frac
                (_, a, g), _ = _steps(
                    tableau, _aug_rhs(ctx.rhs, params, leaves, want, t_lo,
                                      t_hi),
                    (ys[k], a, g), sub, False, False)
        else:
            t0, t1 = grid[0], grid[-1]
            n_bwd = ctx.n_steps_bwd or (grid.shape[0] - 1)
            frac = torch.linspace(0.0, 1.0, n_bwd + 1, dtype=grid.dtype)
            (_, a, g), _ = _steps(
                tableau, _aug_rhs(ctx.rhs, params, leaves, want, t0, t1),
                (ys[-1], a, g), t0 + (t1 - t0) * frac, False, False)
        grads: List[Any] = [None] * n_leaves
        for i, gi in zip(want, g):
            grads[i] = gi
        a0 = a if ctx.needs_input_grad[6] else None
        return (None, None, None, None, None, None, a0, *grads)


def odeint_final_adjoint(
    tableau: ButcherTableau,
    rhs: ParamRHS,
    params: Any,
    y0: torch.Tensor,
    time_grid: torch.Tensor,
    n_steps_bwd: int = 0,
    checkpoint_states: bool = True,
) -> torch.Tensor:
    """y(t1) with continuous-adjoint gradients for ``y0`` and the tensors of
    ``params`` (nested dicts and lists, or the model's ``ModuleDict``); the
    tableau and the grid get none.  ``rhs(params, t, y)`` takes the
    parameters explicitly: the backward calls it on detached copies.
    ``time_grid`` is the forward grid, on the host."""
    leaves, spec = pytree.tree_flatten(_plain(params))
    rebuild = lambda flat: pytree.tree_unflatten(flat, spec)
    return _Adjoint.apply(tableau, rhs, rebuild, time_grid, n_steps_bwd,
                          checkpoint_states, y0, *leaves)
