"""Meta-solver regimes (port of ops/regimes.py), standalone mode only.

``standalone`` integrates with ``solvers[0]``.  ``switch`` and ``ensemble``
draw a solver or a coin per call and land with ROADMAP item A10, together
with the options that configure them; until then they raise
``NotImplementedError``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Sequence, Tuple

import torch

from .solver import ParametricSolver

__all__ = ["SolverOptions", "meta_integrate"]


@dataclass(frozen=True)
class SolverOptions:
    """Regime configuration (reference ``solver_options``, runner.py:113-115)."""

    solver_mode: str = "standalone"  # standalone | switch | ensemble


def meta_integrate(
    solvers: Sequence[ParametricSolver],
    rhs,
    y0: torch.Tensor,
    options: SolverOptions,
    *,
    t0: float = 0.0,
    t1: float = 1.0,
    aux_in: Optional[Dict[str, Any]] = None,
    remat: bool = False,
) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Integrate ``y0`` over [t0, t1] under the configured regime; returns
    ``(y(t1), aux)``.  ``aux`` records the regime's draws and ``aux_in``
    replays a previous call's (the ss-loss pass replays the forward's);
    standalone mode draws nothing, so its aux is empty and ``aux_in`` has
    nothing to replay.  ``remat`` checkpoints each RK step."""
    mode = options.solver_mode
    if mode not in ("standalone", "switch", "ensemble"):
        raise ValueError(f"unknown solver_mode {mode!r}")
    if mode != "standalone":
        raise NotImplementedError(
            f"solver_mode {mode!r} is not ported yet (ROADMAP A10)"
        )
    del aux_in
    return solvers[0].integrate_final(rhs, y0, t0, t1, remat=remat), {}
