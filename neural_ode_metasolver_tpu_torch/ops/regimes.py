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

A fleet (``training/fleet.py``: y0 with a leading member axis S) draws
per member, as JAX's vmap of the regime does: ``generator`` is then a list
of S CPU generators, member m drawing from its own exactly as its single
run draws, and ``aux`` records a list of S draws, which ``aux_in`` replays.
A switch whose members chose one solver integrates it alone.  Where they
chose apart, solvers that share a grid integrate once, on a stacked
tableau whose member m rows are its chosen solver's (padded to the largest
stage count, ``ops/tableau.py``); solvers on different grids integrate
each chosen one over all members, and member m takes its own by
``torch.where`` (vmap of ``lax.switch``), so nothing of an unchosen branch
reaches it, its gradient included.  An ensemble whose coins all fell tails
integrates ``solvers[0]`` alone; otherwise every solver over all members,
and member m takes the weighted sum or ``solvers[0]``'s output by its coin
(vmap of ``lax.cond``).

Solver smoothing is not a mode: it perturbs u/v before the forward
(``ops/noise.py``) and composes with all three.

``adjoint=True`` integrates every branch with the continuous adjoint
(``ops/adjoint.py``), over the explicit-params RHS ``rhs_with_params(params,
t, y)`` and its ``rhs_params`` (JAX ``regimes.py:49-66``).

Spans (``backend.span``): each ``meta_integrate`` call is one ``ode.solve``
(``path`` ``rk`` or ``adjoint``, ``steps`` the first solver's step count),
each ``draw_regime`` one ``regime.draw``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from ..backend import span, spanned
from .adjoint import odeint_final_adjoint
from .integrate import odeint_final
from .solver import ParametricSolver
from .tableau import ButcherTableau, pad_tableau

__all__ = ["SolverOptions", "meta_integrate", "switch_probs", "draw_regime"]


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


@spanned("regime.draw")
def draw_regime(solvers: Sequence[ParametricSolver], options: SolverOptions,
                generator) -> Dict[str, Any]:
    """The draw one ``meta_integrate`` call makes (its ``aux``), made
    without integrating: ``{}`` for standalone, the switch's solver id or
    the ensemble's coin, from ``generator`` (a fleet's list of
    generators, one draw each); ``meta_integrate`` draws through it.
    Passed back as ``aux_in``, it replays that call's choice: the
    pipelined ODE stacks draw every block's in the sequential loop's order
    this way."""
    mode = options.solver_mode
    fleet = isinstance(generator, (list, tuple))
    if mode == "switch":
        probs = switch_probs(options, len(solvers))
        return {"switch_solver_id": ([_choose(g, probs) for g in generator]
                                     if fleet else _choose(generator, probs))}
    if mode == "ensemble":
        draw = lambda g: (_host_uniform(g, "ensemble")  # noqa: E731
                          < options.ensemble_prob)
        return {"ensemble_coin_flip": ([draw(g) for g in generator] if fleet
                                       else draw(generator))}
    return {}


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
    ``(y(t1), aux)``.  ``generator`` (a CPU generator; a fleet's list of
    them, one a member) serves the switch and ensemble draws, one per call;
    without it, and without ``aux_in`` to replay, those modes raise.
    ``remat`` checkpoints each RK step of the backprop path; ``adjoint``
    takes the continuous adjoint instead, which needs ``rhs_with_params``
    and ``rhs_params`` (``rhs`` is then unused)."""
    n = len(solvers)
    mode = options.solver_mode
    if mode not in ("standalone", "switch", "ensemble"):
        raise ValueError(f"unknown solver_mode {mode!r}")
    if adjoint and rhs_with_params is None:
        raise ValueError("adjoint integration needs an explicit-params RHS "
                         "(rhs_with_params / rhs_params)")

    def integrate(s, tableau=None):
        """``s``'s solve of y0, on ``tableau`` in place of s's own."""
        if adjoint:
            return odeint_final_adjoint(
                s.tableau() if tableau is None else tableau,
                rhs_with_params, rhs_params, y0, s.final_grid(y0, t0, t1))
        if tableau is None:
            return s.integrate_final(rhs, y0, t0, t1, remat=remat)
        return odeint_final(tableau, rhs, y0,
                            time_grid=s.final_grid(y0, t0, t1), remat=remat)

    with span("ode.solve", path="adjoint" if adjoint else "rk",
              steps=solvers[0].n_steps if n else None):
        fleet = isinstance(generator, (list, tuple)) or (
            aux_in is not None and any(isinstance(v, (list, tuple))
                                       for v in aux_in.values()))
        if mode == "standalone":
            return integrate(solvers[0]), {}
        key = ("switch_solver_id" if mode == "switch"
               else "ensemble_coin_flip")
        if aux_in is not None and key in aux_in:
            cast = int if mode == "switch" else bool
            drawn = aux_in[key]
            drawn = [cast(v) for v in drawn] if fleet else cast(drawn)
        else:
            drawn = draw_regime(solvers, options, generator)[key]
        aux = {key: drawn}
        if mode == "switch":
            if not fleet or len(set(drawn)) == 1:
                return integrate(solvers[drawn[0] if fleet else drawn]), aux
            return _member_switch(solvers, drawn, y0, integrate), aux
        if not any(drawn if fleet else [drawn]):
            return integrate(solvers[0]), aux
        weights = options.ensemble_weights
        if weights is None:
            weights = [1.0 / n] * n
        y = first = None
        for w, s in zip(weights, solvers):
            out = integrate(s)
            first = out if first is None else first
            yi = w * out
            y = yi if y is None else y + yi
        if fleet and not all(drawn):
            y = torch.where(_member_mask(drawn, y), y, first)
        return y, aux


def _member_mask(values: Sequence[bool], like: torch.Tensor) -> torch.Tensor:
    """A fleet's per-member booleans shaped to select along ``like``'s
    leading (member) axis."""
    return torch.tensor(list(values), device=like.device).reshape(
        (-1,) + (1,) * (like.dim() - 1))


def _grid_key(s: ParametricSolver):
    return (s.n_steps, s.step_size, s.custom_grid)


def _member_tableau(solvers: Sequence[ParametricSolver], ids: List[int],
                    device: torch.device) -> ButcherTableau:
    """The stacked tableau whose member m rows are those of solver ids[m]
    (a stacked solver's row m), padded to the largest stage count."""
    chosen = sorted(set(ids))
    tabs = {j: solvers[j].tableau() for j in chosen}
    smax = max(t.stages for t in tabs.values())
    s_count = len(ids)
    rows = {}
    for name in ("c", "w", "b"):
        stack = []
        for j in chosen:
            t = getattr(pad_tableau(tabs[j], smax), name).to(device)
            lead = 1 if name != "w" else 2
            if t.dim() == lead:  # one solver for every member
                t = t.expand((s_count,) + tuple(t.shape))
            stack.append(t)
        pick = torch.tensor([chosen.index(i) for i in ids], device=device)
        rows[name] = torch.stack(stack)[pick, torch.arange(s_count,
                                                           device=device)]
    return ButcherTableau(c=rows["c"], w=rows["w"], b=rows["b"])


def _member_switch(solvers, ids: List[int], y0: torch.Tensor, integrate):
    """A fleet's switch where members chose apart: one solve on the members'
    tableau where the chosen solvers share a grid, else each chosen solver
    over all members and member m's own output picked by selection."""
    chosen = sorted(set(ids))
    if len({_grid_key(solvers[j]) for j in chosen}) == 1:
        return integrate(solvers[chosen[0]],
                         _member_tableau(solvers, ids, y0.device))
    y = None
    for j in chosen:
        out = integrate(solvers[j])
        y = out if y is None else torch.where(
            _member_mask([i == j for i in ids], out), out, y)
    return y
