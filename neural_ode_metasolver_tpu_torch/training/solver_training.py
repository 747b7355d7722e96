"""Trainable solver parameters: (u, v) optimized jointly with the network
(port of training/solver_training.py; the reference's ``lr_uv`` param
group, odenet_mnist/runner_old.py:184-185).

A :class:`SolverTrainState` is a ``TrainState`` with the solvers' (u, v),
one ``{"u", "v"}`` dict a solver (None where the family has no such
parameter), and the solver optimizer's state.  The step runs the attack
on detached weights and frozen solvers, then the training pass with
unfrozen solvers (``ParametricSolver.unfreeze``), so the loss's gradient
reaches u and v through the tableau: the stage combines and, in the MNIST
RHS, the ConcatConv2d time channel.  Both optimizers update in place; u
and v are then clipped into ``[1e-3, hi]`` (``hi = 1 - 1e-3`` for rk4,
whose tableau clamps there, else 1) and kept a band of 2e-3 off the poles
of rk4 'uv' (u = 1/2) and rk3 (u = 2/3), where the tableau's gradient
vanishes or its coefficients blow up (JAX ``:119-145``).

u and v live on the model's device, so the tableau of a trainable solver
is built there and u's gradient is summed there: a host tableau would send
every coefficient's gradient back to the host, one blocking copy each.
Frozen solvers keep their host tableau.

Solver smoothing is not wired in (no ``NoiseConfig``), by JAX's design:
noise on coefficients that are being optimized feeds their own gradient.
Randomness: ``step(state, x, y, generator)`` draws the attack's and the
data noise's seeds from the CPU generator, then the regime seeds as
``make_train_step`` does; ``step(..., shard=S)`` is one rank's part of a
step over the mesh as there (``StepShards``: data, sp, model), u's and
v's gradients reduced in the model's bucket.  A pipelined stack does not
take a trainable solver (its gradient would not leave the pipeline's
stages): such a step runs the model's ODE stacks in the sequential loop.
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Any, Dict, List, Optional, Sequence

import torch

from ..attacks import attacks
from ..backend import full_f32, phase, span, spanned
from ..ops.regimes import SolverOptions
from ..ops.solver import ParametricSolver
from ..parallel.mesh import StepShards, data_shard, spatial_rows
from .optimizers import global_norm
from .train import (AttackConfig, LossConfig, TrainState, _batch_generator,
                    _model_forward, _randn_rows, _reduce_over_data,
                    _regime_generator, _regime_seeds, _run_attack, _seeds,
                    create_train_state)

__all__ = [
    "SolverTrainState",
    "create_solver_train_state",
    "make_solver_train_step",
    "solvers_from_state",
]

# rk4 'uv' and rk3 keep u this far off their poles (JAX :119-137)
_POLE_BAND = 2e-3
_CLIP_LO = 1e-3


@dataclass(frozen=True)
class SolverTrainState(TrainState):
    """``solver_params``: a ``{"u": tensor | None, "v": tensor | None}``
    dict a solver, on the model's device, updated in place by the step;
    ``solver_opt_state``: the solver optimizer's state, its buffers named
    ``solver{i}_u`` / ``solver{i}_v``."""

    solver_params: List[Dict[str, Optional[torch.Tensor]]] = field(
        default_factory=list)
    solver_opt_state: Any = None


def _solver_param_dict(solver_params) -> Dict[str, torch.Tensor]:
    """The solver parameters by name (``solver{i}_u`` / ``_v``), None left
    out: what the solver optimizer updates."""
    return {f"solver{i}_{k}": t for i, sp in enumerate(solver_params)
            for k, t in sp.items() if t is not None}


def solvers_from_state(solvers: Sequence[ParametricSolver], solver_params
                       ) -> List[ParametricSolver]:
    """The solvers with the state's (u, v), unfrozen."""
    return [s.replace(u=sp["u"], v=sp["v"], frozen=False)
            for s, sp in zip(solvers, solver_params)]


def create_solver_train_state(model, optimizer, solver_optimizer,
                              solvers: Sequence[ParametricSolver],
                              state_dict: Optional[dict] = None,
                              opt_state: Optional[dict] = None,
                              step: int = 0) -> SolverTrainState:
    """A state at ``step`` with the solvers' (u, v) copied to the model's
    device.  ``state_dict`` and ``opt_state`` load weights and the model
    optimizer's state as in ``create_train_state`` (e.g.
    ``mnist_params_from_jax(np_params)`` to start from a JAX state)."""
    base = create_train_state(model, optimizer, state_dict, opt_state, step)
    dev = model.device
    sp = [{k: None if t is None else t.detach().to(dev, copy=True)
           for k, t in (("u", s.u), ("v", s.v))} for s in solvers]
    return SolverTrainState(
        step=base.step, params=base.params, opt_state=base.opt_state,
        model_state=base.model_state, solver_params=sp,
        solver_opt_state=solver_optimizer.init(_solver_param_dict(sp)))


@torch.no_grad()
def _keep_off_pole_(u: torch.Tensor, pole: float) -> None:
    u.copy_(torch.where((u - pole).abs() < _POLE_BAND,
                        torch.where(u < pole, pole - _POLE_BAND,
                                    pole + _POLE_BAND), u))


@torch.no_grad()
def _clip_(sp: dict, solver: ParametricSolver, hi: float) -> None:
    for t in sp.values():
        if t is not None:
            t.clamp_(_CLIP_LO, hi)
    if solver.method == "rk4" and solver.parameterization == "uv":
        _keep_off_pole_(sp["u"], 0.5)
    if solver.method == "rk3" and sp["u"] is not None:
        _keep_off_pole_(sp["u"], 2.0 / 3.0)


def make_solver_train_step(model, optimizer, solver_optimizer,
                           solvers: Sequence[ParametricSolver],
                           solver_options: SolverOptions = SolverOptions(),
                           attack_cfg: AttackConfig = AttackConfig(),
                           loss_cfg: LossConfig = LossConfig(), *,
                           clip_solver_params: bool = True,
                           remat: bool = False, unroll: int = 1,
                           compute_dtype: Optional[torch.dtype] = None,
                           use_kernels: bool = True):
    """Returns ``step(state, x, y, generator) -> (state, metrics)``, like
    ``make_train_step``'s but with (u, v) trained by ``solver_optimizer``
    (the reference's ``lr_uv`` group).  Metrics: loss, xentropy, accuracy,
    grad_norm, solver_grad_norm (the global norm of the u/v gradients) and
    each solver's updated ``solver{i}_u`` / ``solver{i}_v``, 0-dim tensors
    on the model's device.  ``clip_solver_params`` keeps u and v inside
    the tableau's validity region after each update."""
    del unroll
    if compute_dtype not in (None, torch.float32, torch.bfloat16):
        raise ValueError(f"compute_dtype {compute_dtype} not supported")
    forward = _model_forward(model, solver_options, use_kernels,
                             compute_dtype, remat)
    clip_hi = [1.0 - 1e-3 if s.method == "rk4" else 1.0 for s in solvers]

    @spanned("train.step", unit=True)
    def step(state: SolverTrainState, x: torch.Tensor, y: torch.Tensor,
             generator: torch.Generator,
             shard: Optional[StepShards] = None):
        reduce = None if shard is None else shard.reduce
        with span("train.draws"):
            s_attack, s_data = _seeds(generator, 2)
            s_afwd, s_fwd = _regime_seeds(generator, solver_options, 2)
        current = solvers_from_state(solvers, state.solver_params)
        with full_f32(), data_shard(reduce), spatial_rows(
                None if shard is None else shard.spatial):
            with phase("nodems.attack"):
                frozen = model.detached_params()
                attack_solvers = [s.freeze() for s in current]
                x_adv = _run_attack(
                    lambda xi, g: forward(xi, attack_solvers, False, frozen,
                                          generator=g)[0],
                    attack_cfg, x, y,
                    _batch_generator(x.device, s_attack, shard), s_afwd)
            if loss_cfg.data_noise_std > 1e-12:
                x_adv = x_adv + loss_cfg.data_noise_std * _randn_rows(
                    x_adv, s_data, shard)
            with phase("nodems.train_pass"), torch.enable_grad():
                leaves = [{k: None if t is None
                           else t.detach().requires_grad_(True)
                           for k, t in sp.items()}
                          for sp in state.solver_params]
                logits, ss, new_state = forward(
                    x_adv, solvers_from_state(solvers, leaves), True,
                    ss=loss_cfg, generator=_regime_generator(s_fwd))
                xent = attacks.cross_entropy(logits, y)
                loss = xent
                if loss_cfg.ss_loss:
                    loss = loss + loss_cfg.ss_loss_reg * ss
                wrt = (list(state.params.values())
                       + list(_solver_param_dict(leaves).values()))
                with span("train.backward"):
                    grads = torch.autograd.grad(loss, wrt,
                                                allow_unused=True)
            grads = [torch.zeros_like(w) if g is None else g
                     for g, w in zip(grads, wrt)]
            # u's and v's gradients share the model's bucket
            loss, xent, acc, grads = _reduce_over_data(
                reduce, [loss, xent, (logits.argmax(-1) == y).float().mean()],
                grads)
            n = len(state.params)
            g_model, g_solver = grads[:n], grads[n:]
            metrics = {
                "loss": loss.detach(), "xentropy": xent.detach(),
                "accuracy": acc,
                "grad_norm": global_norm(
                    g_model, like=list(state.params.values())),
                "solver_grad_norm": (global_norm(g_solver) if g_solver else
                                     torch.zeros((), device=loss.device)),
            }
            with phase("nodems.update"):
                optimizer.update(state.params, g_model, state.opt_state)
                solver_optimizer.update(
                    _solver_param_dict(state.solver_params), g_solver,
                    state.solver_opt_state)
                if clip_solver_params:
                    for sp, s, hi in zip(state.solver_params, solvers,
                                         clip_hi):
                        _clip_(sp, s, hi)
                model.commit_state(new_state)
            for i, sp in enumerate(state.solver_params):
                for k, t in sp.items():
                    if t is not None:
                        metrics[f"solver{i}_{k}"] = t.detach().clone()
        return replace(state, step=state.step + 1), metrics

    return step
