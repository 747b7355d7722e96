"""Meta-solver regimes: standalone, switch and ensemble (port of
ops/regimes.py; reference odenet_mnist/layers.py:16-50,
odenet_cifar10/layers.py:173-207).

  * standalone: integrate with ``solvers[0]``.
  * switch: pick one solver id by ``switch_probs`` (uniformly when they are
    not given) and integrate that branch only.
  * ensemble: flip a Bernoulli(``ensemble_prob``) coin; heads gives the
    weighted sum of every member's output, tails ``solvers[0]``'s output,
    unweighted.

A single-solver switch or ensemble takes the regime path all the same (the
reference does, layers.py:22-48): the draw is recorded and the weight
applied.  The draws come from an explicit CPU ``torch.Generator``, on the
host, so the branch is Python control flow and no value is read back from
the card; the integration itself runs wherever ``y0`` lives.  ``aux``
records the draw (``switch_solver_id``, ``ensemble_coin_flip``) and
``aux_in`` replays it, as the ss-loss pass replays the forward's.  The
stream differs from JAX's threefry: parity tests pin the draws through
``aux_in`` or degenerate probabilities and compare distributions.

Solver smoothing is not a mode: it perturbs u/v before the forward
(``ops/noise.py``) and composes with all three.

``adjoint=True`` integrates every branch with the continuous adjoint
(``ops/adjoint.py``), over the explicit-params RHS ``rhs_with_params(params,
t, y)`` and its ``rhs_params`` (JAX ``regimes.py:49-66``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Sequence, Tuple

import torch

from .adjoint import odeint_final_adjoint
from .solver import ParametricSolver

__all__ = ["SolverOptions", "meta_integrate", "switch_probs"]


@dataclass(frozen=True)
class SolverOptions:
    """Regime configuration (reference ``solver_options``, runner.py:113-115)."""

    solver_mode: str = "standalone"  # standalone | switch | ensemble
    switch_probs: Optional[Sequence[float]] = None
    ensemble_prob: float = 1.0
    ensemble_weights: Optional[Sequence[float]] = None


def switch_probs(options: SolverOptions, n: int) -> Sequence[float]:
    """The switch probabilities of ``n`` solvers: ``options.switch_probs``,
    uniform when they are not given; raises when their count is not ``n``."""
    probs = options.switch_probs
    if probs is None:
        return [1.0 / n] * n
    if len(probs) != n:
        raise ValueError(f"switch_probs has {len(probs)} entries for {n} "
                         "solvers")
    return probs


def _host_uniform(generator: Optional[torch.Generator], mode: str) -> float:
    """One U[0, 1) draw on the host from a CPU generator."""
    if generator is None:
        raise ValueError(f"{mode} mode needs a PRNG key: pass a CPU "
                         "torch.Generator")
    if generator.device.type != "cpu":
        raise ValueError(f"{mode} mode draws on the host: the generator is "
                         f"on {generator.device}, not the CPU")
    return float(torch.rand((), generator=generator, dtype=torch.float64))


def _choose(generator, probs: Sequence[float]) -> int:
    """An index drawn with probabilities ``probs`` (normalized), by the
    inverse CDF of one uniform, as ``jax.random.choice`` does."""
    r = _host_uniform(generator, "switch") * float(sum(probs))
    cum = 0.0
    for i, p in enumerate(probs):
        cum += float(p)
        if r < cum:
            return i
    return max(i for i, p in enumerate(probs) if p > 0)


def meta_integrate(
    solvers: Sequence[ParametricSolver],
    rhs,
    y0: torch.Tensor,
    options: SolverOptions,
    generator: Optional[torch.Generator] = None,
    *,
    t0: float = 0.0,
    t1: float = 1.0,
    aux_in: Optional[Dict[str, Any]] = None,
    remat: bool = False,
    adjoint: bool = False,
    rhs_params: Any = None,
    rhs_with_params=None,
) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Integrate ``y0`` over [t0, t1] under the configured regime; returns
    ``(y(t1), aux)``.  ``generator`` (a CPU generator) serves the switch
    and ensemble draws, one per call; without it, and without ``aux_in`` to
    replay, those modes raise.  ``remat`` checkpoints each RK step of the
    backprop path; ``adjoint`` takes the continuous adjoint instead, which
    needs ``rhs_with_params`` and ``rhs_params`` (``rhs`` is then unused)."""
    n = len(solvers)
    mode = options.solver_mode
    if mode not in ("standalone", "switch", "ensemble"):
        raise ValueError(f"unknown solver_mode {mode!r}")
    if adjoint and rhs_with_params is None:
        raise ValueError("adjoint integration needs an explicit-params RHS "
                         "(rhs_with_params / rhs_params)")

    def integrate(s):
        if adjoint:
            return odeint_final_adjoint(s.tableau(), rhs_with_params,
                                        rhs_params, y0,
                                        s.final_grid(y0, t0, t1))
        return s.integrate_final(rhs, y0, t0, t1, remat=remat)

    if mode == "standalone":
        return integrate(solvers[0]), {}
    if mode == "switch":
        if aux_in is not None and "switch_solver_id" in aux_in:
            solver_id = int(aux_in["switch_solver_id"])
        else:
            solver_id = _choose(generator, switch_probs(options, n))
        return integrate(solvers[solver_id]), {"switch_solver_id": solver_id}
    if aux_in is not None and "ensemble_coin_flip" in aux_in:
        coin = bool(aux_in["ensemble_coin_flip"])
    else:
        coin = _host_uniform(generator, "ensemble") < options.ensemble_prob
    if not coin:
        return integrate(solvers[0]), {"ensemble_coin_flip": False}
    weights = options.ensemble_weights
    if weights is None:
        weights = [1.0 / n] * n
    y = None
    for w, s in zip(weights, solvers):
        yi = w * integrate(s)
        y = yi if y is None else y + yi
    return y, {"ensemble_coin_flip": True}
