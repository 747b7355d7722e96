"""Solver smoothing: coefficient noise from an explicit generator (port of
ops/noise.py; reference sopa/src/solvers/utils.py:60-117).

  * ``sample_noise``: a Cauchy or Normal draw; with
    ``minimize_rk2_error=True`` it is recentered at u=2/3 with scale
    ``2/3 * sigma``, ignoring the passed mean (the reference's quirk,
    utils.py:66-70, kept behind the same flag).
  * ``noise_params``: a Bernoulli(p) gate, then u ~ noise(mean_u, std)
    with the reference's rejection to the mean outside ``mean_u +- 2 std``
    (boundaries inclusive, utils.py:87-88), and v ~ noise(mean_v, std) with
    no rejection (utils.py:91-92).  A closed gate gives (mean_u, mean_v).
  * ``noise_solver``: a solver whose u/v are noised around (u0, v0)
    (utils.py:100-110); the base solver is immutable, so the reference's
    denoise step is implicit.

Draws come from an explicit ``torch.Generator`` on the CPU, in the order
gate, u, v; the results are f32 CPU scalars, so the noise adds no work and
no synchronisation on the card (the tableau is built on the host).  The
stream differs from JAX's threefry, so parity tests pin the draws
(``sample_noise`` is looked up from this module at each call) and compare
distributions.  ``solver_ensemble_by_noising`` builds the members of model
ensembling: the original first, then noised copies (utils.py:112-117).
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from .solver import ParametricSolver

__all__ = ["sample_noise", "noise_params", "noise_solver",
           "solver_ensemble_by_noising"]


def sample_noise(generator: torch.Generator, mu, sigma,
                 noise_type: str = "cauchy",
                 minimize_rk2_error: bool = False,
                 shape=()) -> torch.Tensor:
    """Draw ``mu + sigma * z`` in f32, z standard Cauchy or Normal."""
    mu = torch.as_tensor(mu, dtype=torch.float32)
    sigma = torch.as_tensor(sigma, dtype=torch.float32)
    if minimize_rk2_error:
        mu = torch.tensor(2.0 / 3.0, dtype=torch.float32)
        sigma = (2.0 / 3.0) * sigma
    if noise_type == "cauchy":
        z = torch.empty(shape, dtype=torch.float32).cauchy_(
            generator=generator)
    elif noise_type == "normal":
        z = torch.randn(shape, generator=generator, dtype=torch.float32)
    else:
        raise ValueError(f"unknown noise_type {noise_type!r}")
    return mu + sigma * z


def noise_params(generator: torch.Generator, mean_u, mean_v=None,
                 std: float = 0.01, bernoulli_p: float = 1.0,
                 noise_type: str = "cauchy", minimize_rk2_error: bool = False
                 ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Noised (u, v) with probability ``bernoulli_p``, else the means."""
    mean_u = torch.as_tensor(mean_u, dtype=torch.float32)
    gate = bool(torch.rand((), generator=generator) < bernoulli_p)
    std = torch.as_tensor(std, dtype=torch.float32).abs()
    u_s = sample_noise(generator, mean_u, std, noise_type=noise_type,
                       minimize_rk2_error=minimize_rk2_error)
    reject = (u_s <= mean_u - 2.0 * std) | (u_s >= mean_u + 2.0 * std)
    u = torch.where(reject | (not gate), mean_u, u_s)
    v = None
    if mean_v is not None:
        mean_v = torch.as_tensor(mean_v, dtype=torch.float32)
        v_s = sample_noise(generator, mean_v, std, noise_type=noise_type,
                           minimize_rk2_error=minimize_rk2_error)
        v = v_s if gate else mean_v
    return u, v


def noise_solver(solver: ParametricSolver, generator: torch.Generator,
                 std: float = 0.01, bernoulli_p: float = 1.0,
                 noise_type: str = "cauchy",
                 minimize_rk2_error: bool = False) -> ParametricSolver:
    """A solver whose u/v are noised around u0/v0 (euler: unchanged)."""
    if solver.u0 is None:
        return solver
    u, v = noise_params(generator, mean_u=solver.u0, mean_v=solver.v0,
                        std=std, bernoulli_p=bernoulli_p,
                        noise_type=noise_type,
                        minimize_rk2_error=minimize_rk2_error)
    return solver.with_params(u=u, v=v)


def solver_ensemble_by_noising(solver: ParametricSolver,
                               generator: torch.Generator,
                               ensemble_size: int = 1, **noise_kwargs
                               ) -> List[ParametricSolver]:
    """``[original, noised_1, ..., noised_{n-1}]``, each copy drawn in turn
    from ``generator`` with ``noise_solver``'s keyword arguments."""
    return [solver] + [noise_solver(solver, generator, **noise_kwargs)
                       for _ in range(1, ensemble_size)]
