"""Parametric RK solvers (port of ops/solver.py).

A solver is a frozen dataclass whose only tensors are ``u``/``v``; the
tableau is rebuilt from them (about 20 scalar operations) at each use, so a
new parameter is ``solver.with_params(u=...)`` (a ``dataclasses.replace``)
and ``reset_params`` restores (u0, v0), the reference's denoise step.  ``create_solver``
and the ``--solvers`` mini-DSL keep CLI parity with the reference
(odenet_mnist/runner.py:31-41; solvers/utils.py:13-57).

A grid comes from ``custom_grid`` (explicit time points, the reference's
custom ``grid_constructor``, rk_parametric.py:17-18) before ``n_steps``
before ``step_size``; ``replace`` regrids a solver, as ``sn_test`` does.

``frozen`` (the default) builds the tableau from ``u.detach()`` /
``v.detach()``, JAX's ``stop_gradient``: no gradient reaches u or v.
``unfreeze()`` lets one flow through the tableau into u and v, which is how
``training/solver_training.py`` trains them; ``freeze()`` stops it again.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import List, Optional

import torch

from .integrate import make_time_grid, odeint, odeint_final
from .tableau import (
    ButcherTableau,
    euler_tableau,
    rk2_tableau,
    rk3_tableau,
    rk4_tableau,
)

__all__ = ["ParametricSolver", "create_solver", "parse_solver_dsl"]

_ORDERS = {"euler": 1, "rk2": 2, "rk3": 3, "rk4": 4}


@dataclass(frozen=True)
class ParametricSolver:
    """A fixed-step parametric RK solver; ``u``/``v`` are scalar tensors or
    None, everything else is static metadata."""

    u: Optional[torch.Tensor]
    v: Optional[torch.Tensor]
    method: str = "rk2"
    parameterization: Optional[str] = "u"
    u0: Optional[float] = None
    v0: Optional[float] = None
    n_steps: Optional[int] = None
    step_size: Optional[float] = None
    custom_grid: Optional[tuple] = None  # explicit time points, if any
    frozen: bool = True

    @property
    def order(self) -> int:
        return _ORDERS[self.method]

    def freeze(self) -> "ParametricSolver":
        return replace(self, frozen=True)

    def unfreeze(self) -> "ParametricSolver":
        return replace(self, frozen=False)

    def replace(self, **changes) -> "ParametricSolver":
        """A copy with ``changes`` to its fields (the JAX pytree's
        ``replace``)."""
        return replace(self, **changes)

    def with_params(self, u=None, v=None) -> "ParametricSolver":
        """A solver with new u/v in the dtypes of the current ones.  Raises
        if a parameter is supplied that this solver does not have (e.g.
        ``v`` on an rk2 solver): dropping it would turn a mistaken update
        into a no-op."""
        new = self
        if u is not None:
            if self.u is None:
                raise ValueError(
                    f"solver {self.method!r}/{self.parameterization!r} has "
                    "no parameter u")
            new = replace(new, u=torch.as_tensor(u, dtype=self.u.dtype))
        if v is not None:
            if self.v is None:
                raise ValueError(
                    f"solver {self.method!r}/{self.parameterization!r} has "
                    "no parameter v")
            new = replace(new, v=torch.as_tensor(v, dtype=self.v.dtype))
        return new

    def reset_params(self) -> "ParametricSolver":
        """Restore u0/v0 (reference 'denoise' step, runner.py:201-204),
        keeping the dtypes the solver was created with."""
        u_dt = torch.float32 if self.u is None else self.u.dtype
        v_dt = torch.float32 if self.v is None else self.v.dtype
        u = None if self.u0 is None else torch.tensor(self.u0, dtype=u_dt)
        v = None if self.v0 is None else torch.tensor(self.v0, dtype=v_dt)
        return replace(self, u=u, v=v)

    def tableau(self) -> ButcherTableau:
        u, v = self.u, self.v
        if self.frozen:
            u = None if u is None else u.detach()
            v = None if v is None else v.detach()
        if self.method == "euler":
            return euler_tableau()
        if self.method == "rk2":
            return rk2_tableau(u)
        if self.method == "rk3":
            return rk3_tableau(u, v)
        if self.method == "rk4":
            return rk4_tableau(u, v, self.parameterization)
        raise ValueError(f"unknown method {self.method!r}")

    def time_grid(self, t0: float = 0.0, t1: float = 1.0
                  ) -> Optional[torch.Tensor]:
        if self.custom_grid is not None:
            return torch.tensor(self.custom_grid, dtype=torch.float32)
        if self.n_steps is None and self.step_size is None:
            return None
        return make_time_grid(t0, t1, n_steps=self.n_steps,
                              step_size=self.step_size)

    def integrate(self, rhs, y0: torch.Tensor, t, *, remat: bool = False
                  ) -> torch.Tensor:
        """The trajectory at the requested times ``t`` (rk_parametric.py:
        89-113), shape ``(len(t), *y0.shape)``."""
        if self.custom_grid is not None:
            return odeint(self.tableau(), rhs, y0, t,
                          time_grid=self.time_grid(), remat=remat)
        return odeint(self.tableau(), rhs, y0, t, n_steps=self.n_steps,
                      step_size=self.step_size, remat=remat)

    def final_grid(self, y0: torch.Tensor, t0: float = 0.0,
                   t1: float = 1.0) -> torch.Tensor:
        """The grid ``integrate_final`` steps over: the custom grid, else
        the ``n_steps`` / ``step_size`` grid in y0's promotion with f32,
        else the single step [t0, t1]."""
        if self.custom_grid is not None:
            return self.time_grid()
        if self.n_steps is None and self.step_size is None:
            return torch.tensor([t0, t1], dtype=torch.float32)
        return make_time_grid(
            t0, t1, n_steps=self.n_steps, step_size=self.step_size,
            dtype=torch.promote_types(y0.dtype, torch.float32))

    def integrate_final(self, rhs, y0: torch.Tensor, t0: float = 0.0,
                        t1: float = 1.0, remat: bool = False
                        ) -> torch.Tensor:
        """Only y(t1): what the ODE blocks consume.  With no grid source
        the grid is the single step [t0, t1]; ``remat`` checkpoints each
        step."""
        return odeint_final(self.tableau(), rhs, y0, t0, t1,
                            time_grid=self.final_grid(y0, t0, t1),
                            remat=remat)


def create_solver(
    method: str,
    parameterization: Optional[str] = "u",
    n_steps: Optional[int] = None,
    step_size: Optional[float] = None,
    u0: Optional[float] = None,
    v0: Optional[float] = None,
    dtype: torch.dtype = torch.float32,
) -> ParametricSolver:
    """Factory with reference semantics (solvers/utils.py:13-57).

    ``-1`` means "not set" for n_steps/step_size only (utils.py:23-27); a
    ``-1`` u0/v0 passes through and is clamped at tableau build.  ``None``
    u0/v0 selects the conventional starting points (rk2 1/2; rk3/rk4 1/3,
    2/3)."""
    if n_steps == -1:
        n_steps = None
    if step_size == -1:
        step_size = None
    if n_steps is not None and n_steps < 1:
        raise ValueError(f"n_steps must be >= 1, got {n_steps}")
    if step_size is not None and not step_size > 0:
        raise ValueError(f"step_size must be > 0, got {step_size}")
    method = method.lower()
    if method not in _ORDERS:
        raise ValueError(f"unknown solver method {method!r}")
    u = v = None
    if method == "euler":
        u0 = v0 = None
        parameterization = None
    elif method == "rk2":
        if parameterization != "u":
            raise ValueError("Unknown parameterization for rk2 solver")
        u0 = 0.5 if u0 is None else u0
        v0 = None
        u = torch.tensor(u0, dtype=dtype)
    elif method == "rk3":
        if parameterization != "uv":
            raise ValueError("Unknown parameterization for rk3 solver")
        u0 = 1 / 3 if u0 is None else u0
        v0 = 2 / 3 if v0 is None else v0
        u = torch.tensor(u0, dtype=dtype)
        v = torch.tensor(v0, dtype=dtype)
    else:  # rk4
        if parameterization not in ("u1", "u2", "u3", "uv"):
            raise ValueError("Unknown parameterization for rk4 solver")
        u0 = 1 / 3 if u0 is None else u0
        u = torch.tensor(u0, dtype=dtype)
        if parameterization == "uv":
            v0 = 2 / 3 if v0 is None else v0
            v = torch.tensor(v0, dtype=dtype)
        else:
            v0 = None
    return ParametricSolver(
        u=u, v=v, method=method, parameterization=parameterization,
        u0=u0, v0=v0, n_steps=n_steps, step_size=step_size,
    )


def parse_solver_dsl(spec: str) -> List[ParametricSolver]:
    """Parse the reference ``--solvers`` DSL (odenet_mnist/runner.py:31-41):
    ``method,parameterization,n_steps,step_size,u0,v0`` tuples joined by
    ``;``, with ``-1`` for an unset numeric field."""
    solvers = []
    for item in spec.strip().split(";"):
        if not item:
            continue
        method, param, n_steps, step_size, u0, v0 = [
            tok.strip() for tok in item.split(",")
        ]
        solvers.append(
            create_solver(
                method,
                param if param != "-1" else None,
                int(n_steps),
                float(step_size),
                float(u0),
                float(v0),
            )
        )
    return solvers
