"""Running meters and NFE accounting (port of training/metrics.py).

The reference counts RHS evaluations with a mutable ``self.nfe`` per forward
(odenet_mnist/layers.py:156-159), read and zeroed around
``loss.backward()`` (runner.py:184-198).  For fixed-step solvers the count
is known before the run, so here NFE is derived: stages x steps per solve,
summed over the ODE blocks, in expectation over the regime's draws.
"""
from __future__ import annotations

from typing import Sequence

from ..ops.integrate import make_time_grid
from ..ops.regimes import SolverOptions, switch_probs
from ..ops.solver import ParametricSolver

__all__ = ["RunningAverageMeter", "nfe_per_solve", "nfe_per_forward"]

_STAGES = {"euler": 1, "rk2": 2, "rk3": 3, "rk4": 4}


class RunningAverageMeter:
    """EMA meter (sopa/src/models/utils.py:17-33; momentum 0.99)."""

    def __init__(self, momentum: float = 0.99):
        self.momentum = momentum
        self.reset()

    def reset(self):
        self.val = None
        self.avg = 0.0

    def update(self, val: float):
        if self.val is None:
            self.avg = val
        else:
            self.avg = self.avg * self.momentum + val * (1.0 - self.momentum)
        self.val = val


def nfe_per_solve(solver: ParametricSolver, t0=0.0, t1=1.0) -> int:
    """RHS evaluations of one ODE solve, on the grid the solve takes
    (``ParametricSolver.time_grid``'s order: custom_grid, n_steps,
    step_size, else one step)."""
    stages = _STAGES[solver.method]
    if solver.custom_grid is not None:
        n = len(solver.custom_grid) - 1
    elif solver.n_steps is not None:
        n = solver.n_steps
    elif solver.step_size is not None:
        n = int(make_time_grid(t0, t1, step_size=solver.step_size
                               ).shape[0]) - 1
    else:
        n = 1
    return stages * n


def nfe_per_forward(solvers: Sequence[ParametricSolver],
                    options: SolverOptions, n_ode_blocks: int) -> float:
    """Expected NFE of one model forward: standalone (or one solver) the
    first solver's; switch the probability-weighted mean; ensemble
    ``p * sum + (1 - p) * first``.  premetanode10 with one 8-step RK2:
    2 blocks x 8 x 2 = 32 (BASELINE.md NFE row)."""
    n = len(solvers)
    nfes = [nfe_per_solve(s) for s in solvers]
    if options.solver_mode == "standalone" or n == 1:
        per_block = nfes[0]
    elif options.solver_mode == "switch":
        per_block = sum(p * f for p, f in zip(switch_probs(options, n),
                                              nfes))
    elif options.solver_mode == "ensemble":
        p = options.ensemble_prob
        per_block = p * sum(nfes) + (1.0 - p) * nfes[0]
    else:
        raise ValueError(options.solver_mode)
    return per_block * n_ode_blocks
