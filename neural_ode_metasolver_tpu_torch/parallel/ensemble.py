"""Ensemble parallelism: the members of a solver ensemble on one member axis
(port of parallel/ensemble.py).

The reference builds solver ensembles by deep-copying solver objects and
looping (solvers/utils.py:100-117; odenet layers.py:42-46).  Here the
members' scalar parameters are stacked into (S,) tensors, their tableaus
into one stacked tableau (``ops/tableau.py::stack_tableaus``'s layout, c
(S, s), w (S, s, s), b (S, s)), and one solve steps all members: the
carry has a leading member axis and the RK combine scales member m's slice
by its own coefficients (``ops/integrate.py``).  A user's ``rhs(t, y)`` is
written for one member with a scalar t, as under JAX's ``vmap``; under a
stacked tableau the stage times are (S,), so the rhs runs under
``torch.func.vmap`` over the member axis and each member sees its own t.

With ``mesh`` and an ``ensemble`` axis of k ranks, each rank integrates its
S/k contiguous members; their weighted partial sum is summed over the
axis's process group, one all-reduce (``parallel/mesh.py``).  The gradient
to ``y0`` is whole on every rank; a tensor the rhs closes over gets, on
each rank, the share of that rank's members.  An axis of one rank runs no
collective.

Works for homogeneous ensembles (same method and grid, different u/v, what
ensemble-by-noising produces).  Heterogeneous ones take the switch path of
``ops/regimes.py``.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from ..ops.integrate import make_time_grid, odeint_final
from ..ops.solver import ParametricSolver
from ..ops.tableau import rk2_tableau, rk3_tableau, rk4_tableau
from .mesh import Mesh, all_sum_replicated, replicate_grad

__all__ = ["stack_solver_params", "ensemble_integrate", "member_rows"]


def stack_solver_params(solvers: Sequence[ParametricSolver]):
    """Stack a homogeneous solver list's (u, v) into tensors of shape
    (n,); returns (the first solver, u, v)."""
    ref = solvers[0]
    if ref.u is None:
        # euler has no solver parameters: there is nothing to stack
        raise ValueError(
            f"ensemble_integrate needs a parametric solver family "
            f"(rk2/rk3/rk4); {ref.method!r} members are all identical — "
            "a member-sharded ensemble of them is a no-op"
        )
    for s in solvers[1:]:
        if (
            s.method != ref.method
            or s.parameterization != ref.parameterization
            or s.n_steps != ref.n_steps
            or s.step_size != ref.step_size
            or s.custom_grid != ref.custom_grid
            # frozen detaches every member's tableau (ref.frozen is
            # applied to all), so a mixed list would mis-route gradients
            or s.frozen != ref.frozen
        ):
            raise ValueError(
                "ensemble_integrate needs a homogeneous ensemble; use the "
                "regimes switch path for mixed solvers"
            )
    u = torch.stack([torch.as_tensor(s.u) for s in solvers])
    v = (torch.stack([torch.as_tensor(s.v) for s in solvers])
         if ref.v is not None else None)
    return ref, u, v


def _tableau_from(method, parameterization, u, v):
    if method == "rk2":
        return rk2_tableau(u)
    if method == "rk3":
        return rk3_tableau(u, v)
    if method == "rk4":
        return rk4_tableau(u, v, parameterization)
    raise ValueError(method)


def member_rows(n: int, mesh: Optional[Mesh], member_axis: str):
    """(this rank's contiguous members as a slice, the axis's Shard or
    None) for ``n`` members over ``member_axis`` of ``mesh``."""
    if mesh is None:
        return slice(0, n), None
    shard = mesh.shard(member_axis)
    if n % shard.size:
        raise ValueError(f"{n} members do not split over the "
                         f"{member_axis} axis of {shard.size} ranks")
    return shard.rows(n), shard


def ensemble_integrate(
    solvers: Sequence[ParametricSolver],
    rhs,
    y0: torch.Tensor,
    weights: Optional[Sequence[float]] = None,
    *,
    t0: float = 0.0,
    t1: float = 1.0,
    mesh: Optional[Mesh] = None,
    member_axis: str = "ensemble",
    remat: bool = False,
    unroll: int = 1,
) -> torch.Tensor:
    """Weighted solver-ensemble integration, the members on one axis:
    ``sum_m w_m y_m(t1)`` with y_m solved by member m, weights 1/n by
    default.  With ``mesh``, this rank solves its members of
    ``member_axis`` and the weighted sum is reduced over the axis.
    ``unroll`` is accepted and ignored (the step loop is a Python loop)."""
    del unroll
    ref, u, v = stack_solver_params(solvers)
    n = len(solvers)
    if weights is None:
        weights = [1.0 / n] * n
    w = torch.as_tensor(weights, dtype=y0.dtype, device=y0.device)
    rows, shard = member_rows(n, mesh, member_axis)
    u, v = u[rows].to(y0.device), None if v is None else v[rows].to(
        y0.device)
    tab = _tableau_from(ref.method, ref.parameterization, u, v)
    if ref.frozen:
        tab = type(tab)(*(t.detach() for t in tab))
    # custom_grid overrides n_steps/step_size, as ParametricSolver's grid
    # does; ignoring it would integrate the members on the wrong grid
    dtype = torch.promote_types(y0.dtype, torch.float32)
    if ref.custom_grid is not None:
        grid = torch.tensor(ref.custom_grid, dtype=torch.float32)
    elif ref.n_steps is None and ref.step_size is None:
        grid = torch.tensor([t0, t1], dtype=torch.float32)
    else:
        grid = make_time_grid(t0, t1, n_steps=ref.n_steps,
                              step_size=ref.step_size, dtype=dtype)
    k = u.shape[0]
    if shard is not None:
        y0 = replicate_grad(y0, shard)
    ys0 = y0.unsqueeze(0).expand((k,) + tuple(y0.shape))
    one = torch.func.vmap(rhs)

    def members_rhs(t, y):
        t = t.reshape(-1).expand(k) if t.dim() == 0 or t.numel() == 1 else t
        return one(t.to(y.device), y)

    ys = odeint_final(tab, members_rhs, ys0, t0, t1, time_grid=grid,
                      remat=remat)
    part = torch.tensordot(w[rows], ys, dims=1)
    if shard is not None:
        part = all_sum_replicated(part, shard)
    return part
