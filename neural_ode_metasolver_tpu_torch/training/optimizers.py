"""SGD, RMSprop and Adam with torch-parity semantics, and the wrappers of
the JAX chain: gradient clipping, ``every_k`` accumulation and the
non-finite backoff (port of training/optimizers.py).

The JAX optimizer is the optax chain

    [with_nonfinite_backoff](
      [MultiSteps(k)]( [clip_by_global_norm(c)] -> add_decayed_weights(wd)
                       -> rule )
      -> scale_by_learning_rate(lr))

with rule one of
  * sgd: trace(momentum): buf = m buf + g from buf = 0, update buf (torch
    SGD with dampening 0);
  * rmsprop: scale_by_rms(0.99, 1e-8, eps outside the sqrt): nu = 0.99 nu
    + 0.01 g^2 from nu = 0, update g / (sqrt(nu) + 1e-8), no bias
    correction, then trace(momentum) where momentum is callable (a float
    momentum is ignored, as the reference builds RMSprop without one,
    runner.py:141);
  * adam: scale_by_adam(0.9, 0.999, 1e-8): mu and nu moments with bias
    correction by the rule's own count + 1.
Weight decay is coupled into the gradient before the rule.  lr and
momentum may be schedules of the count, evaluated on the host.

The counts: ``count`` is the learning rate's, which advances every
iteration (the LR schedule sits outside the accumulation, so it ticks per
iteration as the reference's scheduler does); the rule's count (momentum
schedule, Adam's bias correction) is the number of updates the rule has
made, which under ``every_k`` is ``emits`` and otherwise equals ``count``.
Under ``every_k`` a callable momentum is read at ``(c + 1) * k - 1`` for
the rule's count c, so its phase stays locked to the per-iteration lr
(JAX ``:49-57``).

``every_k`` (optax ``MultiSteps``, PARITY.md:84) keeps the running mean
of the gradients, ``acc += (g - acc) / (mini_step + 1)``, and on every
k-th iteration runs clip, decay and rule on that mean; the other
iterations change no parameter.

``with_nonfinite_backoff(backoff, recovery=1.1, min_scale=1e-3)`` drops
an iteration whose gradients have a non-finite global norm, leaving every
count and buffer as it was, and multiplies its ``scale`` by ``backoff``
(not below ``min_scale``); a finite iteration's update is multiplied by
the scale, which then recovers by ``recovery`` up to 1.  The port reads
the finiteness back to the host once per iteration (the JAX chain selects
on the device).

A fleet's stacked parameters (S members along a leading axis,
``training/fleet.py``) take the same elementwise rules; with ``members=S``
the wrapper clips each member by its own global norm.  The counts are the
fleet's, shared by its members, and the non-finite backoff has no member
form (it raises).

The update is in place, with ``torch._foreach_*`` ops over all parameters.
The state is a dict of Python numbers and dicts of tensors by parameter
name, which ``torch.save`` writes as is.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

__all__ = ["SGD", "RMSprop", "Adam", "Optimizer", "make_optimizer",
           "global_norm"]

Schedule = Union[float, Callable[[int], float]]
# torch RMSprop's defaults, as the JAX chain fixes them: alpha, and eps
# added outside the sqrt
_RMS_DECAY, _RMS_EPS = 0.99, 1e-8
# optax scale_by_adam's defaults, as the JAX chain takes them
_ADAM_B1, _ADAM_B2, _ADAM_EPS = 0.9, 0.999, 1e-8
# with_nonfinite_backoff's recovery and floor, as make_optimizer takes them
_RECOVERY, _MIN_SCALE = 1.1, 1e-3


def _at(value: Schedule, count: int) -> float:
    return float(value(count)) if callable(value) else float(value)


def _zeros(params: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: torch.zeros_like(p) for k, p in params.items()}


def global_norm(tensors: Sequence[torch.Tensor],
                members: Optional[int] = None) -> torch.Tensor:
    """The L2 norm of all the tensors together (optax ``global_norm``);
    with ``members`` S, each member's over its slices t[m], (S,)."""
    if members is not None:
        return torch.linalg.vector_norm(torch.stack([
            torch.linalg.vector_norm(t.reshape(members, -1), dim=1)
            for t in tensors]), dim=0)
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(
        list(tensors))))


@dataclass(frozen=True)
class _Rule:
    """The update rule: ``init(params)`` makes its state (the update count
    and its buffers by parameter name); ``update(params, grads, state)``
    applies one step in place and advances the count.  ``apply`` is the
    step the wrappers drive, with the lr read at ``lr_count``, the
    momentum schedule and bias correction at ``rule_count``, and the
    update multiplied by ``scale``."""

    learning_rate: Schedule
    momentum: Schedule = 0.9
    weight_decay: float = 0.0

    def init(self, params: Dict[str, torch.Tensor]) -> dict:
        return {"count": 0, **{k: _zeros(params) for k in self._buffers()}}

    def _buffers(self) -> List[str]:
        raise NotImplementedError

    def _direction(self, gs, state, names, rule_count) -> List[torch.Tensor]:
        raise NotImplementedError

    @torch.no_grad()
    def apply(self, params: Dict[str, torch.Tensor],
              grads: Sequence[torch.Tensor], state: dict, lr_count: int,
              rule_count: int, scale: float = 1.0) -> None:
        ps = list(params.values())
        gs = list(grads)
        if self.weight_decay:
            gs = torch._foreach_add(gs, ps, alpha=self.weight_decay)
        upd = self._direction(gs, state, list(params), rule_count)
        torch._foreach_add_(ps, upd,
                            alpha=-_at(self.learning_rate, lr_count) * scale)

    def update(self, params: Dict[str, torch.Tensor],
               grads: Sequence[torch.Tensor], state: dict) -> None:
        self.apply(params, grads, state, state["count"], state["count"])
        state["count"] += 1


@dataclass(frozen=True)
class SGD(_Rule):
    """SGD with momentum (the trace), buffers ``momentum``."""

    def _buffers(self):
        return ["momentum"]

    def _direction(self, gs, state, names, rule_count):
        bufs = [state["momentum"][k] for k in names]
        torch._foreach_mul_(bufs, _at(self.momentum, rule_count))
        torch._foreach_add_(bufs, gs)
        return bufs


@dataclass(frozen=True)
class RMSprop(_Rule):
    """RMSprop, buffers ``nu`` and, where momentum is callable,
    ``momentum``."""

    momentum: Schedule = 0.9  # a trace only where callable

    def _buffers(self):
        return ["nu", "momentum"] if callable(self.momentum) else ["nu"]

    def _direction(self, gs, state, names, rule_count):
        nus = [state["nu"][k] for k in names]
        torch._foreach_mul_(nus, _RMS_DECAY)
        torch._foreach_addcmul_(nus, gs, gs, value=1.0 - _RMS_DECAY)
        denom = torch._foreach_sqrt(nus)
        torch._foreach_add_(denom, _RMS_EPS)
        upd = torch._foreach_div(gs, denom)
        if callable(self.momentum):
            bufs = [state["momentum"][k] for k in names]
            torch._foreach_mul_(bufs, _at(self.momentum, rule_count))
            torch._foreach_add_(bufs, upd)
            upd = bufs
        return upd


@dataclass(frozen=True)
class Adam(_Rule):
    """Adam (optax ``scale_by_adam``), buffers ``mu`` and ``nu``; the
    momentum is not read."""

    def _buffers(self):
        return ["mu", "nu"]

    def _direction(self, gs, state, names, rule_count):
        mus = [state["mu"][k] for k in names]
        nus = [state["nu"][k] for k in names]
        torch._foreach_mul_(mus, _ADAM_B1)
        torch._foreach_add_(mus, gs, alpha=1.0 - _ADAM_B1)
        torch._foreach_mul_(nus, _ADAM_B2)
        torch._foreach_addcmul_(nus, gs, gs, value=1.0 - _ADAM_B2)
        n = rule_count + 1
        mu_hat = torch._foreach_div(mus, float(np.float32(1 - _ADAM_B1 ** n)))
        nu_hat = torch._foreach_div(nus, float(np.float32(1 - _ADAM_B2 ** n)))
        denom = torch._foreach_sqrt(nu_hat)
        torch._foreach_add_(denom, _ADAM_EPS)
        return torch._foreach_div(mu_hat, denom)


def _f32(x: float) -> float:
    return float(np.float32(x))


@dataclass(frozen=True)
class Optimizer:
    """A rule under the wrappers: global-norm clipping at ``grad_clip``,
    ``every_k`` accumulation (state ``acc``, ``mini_step``, ``emits``) and
    the non-finite backoff at ``nonfinite_backoff`` (state ``scale``,
    ``n_skipped``)."""

    rule: _Rule
    grad_clip: Optional[float] = None
    every_k: int = 1
    nonfinite_backoff: Optional[float] = None

    def init(self, params: Dict[str, torch.Tensor]) -> dict:
        state = self.rule.init(params)
        if self.every_k > 1:
            state.update(acc=_zeros(params), mini_step=0, emits=0)
        if self.nonfinite_backoff is not None:
            state.update(scale=1.0, n_skipped=0)
        return state

    @torch.no_grad()
    def update(self, params: Dict[str, torch.Tensor],
               grads: Sequence[torch.Tensor], state: dict,
               members: Optional[int] = None) -> None:
        """One iteration in place; ``members`` S clips each of a fleet's
        members by its own norm."""
        gs = list(grads)
        scale = 1.0
        if self.nonfinite_backoff is not None and members is not None:
            raise NotImplementedError(
                "the non-finite backoff has no per-member form in a fleet")
        if self.nonfinite_backoff is not None:
            if not bool(torch.isfinite(global_norm(gs))):
                dipped = np.float32(state["scale"]) * np.float32(
                    self.nonfinite_backoff)
                state["scale"] = max(_f32(dipped), _f32(_MIN_SCALE))
                state["n_skipped"] += 1
                return
            scale = state["scale"]
            state["scale"] = min(_f32(np.float32(scale)
                                      * np.float32(_RECOVERY)), 1.0)
        rule_count = state["count"]
        if self.every_k > 1:
            names = list(params)
            acc = [state["acc"][k] for k in names]
            m = state["mini_step"]
            # optax MultiSteps' running mean: acc + (g - acc) / (m + 1)
            diff = torch._foreach_sub(gs, acc)
            torch._foreach_div_(diff, float(m + 1))
            torch._foreach_add_(acc, diff)
            if m < self.every_k - 1:
                state["mini_step"] = m + 1
                state["count"] += 1
                return
            gs = [a.clone() for a in acc]
            rule_count = state["emits"]
        if self.grad_clip is not None:
            gn = global_norm(gs, members)
            per = ((lambda g: gn.reshape((-1,) + (1,) * (g.dim() - 1)))
                   if members is not None else (lambda g: gn))
            gs = [torch.where(per(g) < self.grad_clip, g,
                              g / per(g) * self.grad_clip) for g in gs]
        self.rule.apply(params, gs, state, state["count"], rule_count, scale)
        state["count"] += 1
        if self.every_k > 1:
            state["emits"] += 1
            state["mini_step"] = 0
            torch._foreach_zero_([state["acc"][k] for k in params])


def make_optimizer(name: str, learning_rate: Schedule,
                   momentum: Schedule = 0.9, weight_decay: float = 0.0,
                   grad_clip: Optional[float] = None, every_k: int = 1,
                   nonfinite_backoff: Optional[float] = None
                   ) -> Union[SGD, RMSprop, Adam, Optimizer]:
    """``make_optimizer("sgd" | "rmsprop" | "adam", lr, momentum,
    weight_decay, grad_clip, every_k, nonfinite_backoff)``: the bare rule
    without wrappers, else an :class:`Optimizer` around it."""
    rules = {"sgd": SGD, "rmsprop": RMSprop, "adam": Adam}
    if name.lower() not in rules:
        raise ValueError(f"unknown optimizer {name!r}")
    if every_k < 1:
        raise ValueError(f"every_k must be >= 1, got {every_k}")
    if every_k > 1 and callable(momentum):
        base = momentum
        momentum = lambda c: base((c + 1) * every_k - 1)
    rule = rules[name.lower()](learning_rate, momentum, weight_decay)
    if grad_clip is None and every_k == 1 and nonfinite_backoff is None:
        return rule
    return Optimizer(rule, grad_clip, every_k, nonfinite_backoff)
