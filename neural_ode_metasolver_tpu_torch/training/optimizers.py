"""SGD and RMSprop with torch-parity semantics (port of
training/optimizers.py, ``make_optimizer("sgd" | "rmsprop", ...)``).

The JAX optimizer is the optax chain add_decayed_weights(wd) -> trace(m) ->
scale_by_learning_rate(lr): weight decay is coupled into the gradient
before the momentum trace, the trace starts at zero (so the first buffer is
g), and the update is p -= lr * buf: torch SGD with dampening 0.  lr and
momentum may be schedules of the step; both are evaluated at the count of
updates made so far (the pre-increment count optax's ``inject_hyperparams``
and ``scale_by_schedule`` see).

RMSprop is optax's chain add_decayed_weights(wd) -> scale_by_rms(0.99,
1e-8, eps outside the sqrt) [-> trace(momentum) where momentum is callable]
-> scale_by_learning_rate(lr): nu = 0.99 nu + 0.01 g^2 from nu = 0, update
g / (sqrt(nu) + 1e-8), no bias correction; a float momentum is ignored,
as the reference builds RMSprop without one (runner.py:141).

The update is in place, with ``torch._foreach_*`` ops over all parameters.
adam, gradient clipping, ``every_k`` accumulation and the non-finite
backoff land with ROADMAP A14 and raise until then.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional, Sequence, Union

import torch

__all__ = ["SGD", "RMSprop", "make_optimizer"]

Schedule = Union[float, Callable[[int], float]]
# torch RMSprop's defaults, as the JAX chain fixes them: alpha, and eps
# added outside the sqrt
_RMS_DECAY, _RMS_EPS = 0.99, 1e-8


def _at(value: Schedule, count: int) -> float:
    return float(value(count)) if callable(value) else float(value)


@dataclass(frozen=True)
class SGD:
    """``init(params)`` makes the state: the update count and one momentum
    buffer per parameter; ``update(params, grads, state)`` applies one step
    in place and advances the count."""

    learning_rate: Schedule
    momentum: Schedule = 0.9
    weight_decay: float = 0.0

    def init(self, params: Dict[str, torch.Tensor]) -> dict:
        return {"count": 0,
                "momentum": {k: torch.zeros_like(p)
                             for k, p in params.items()}}

    @torch.no_grad()
    def update(self, params: Dict[str, torch.Tensor],
               grads: Sequence[torch.Tensor], state: dict) -> None:
        lr = _at(self.learning_rate, state["count"])
        mom = _at(self.momentum, state["count"])
        ps = list(params.values())
        bufs = [state["momentum"][k] for k in params]
        gs = list(grads)
        if self.weight_decay:
            gs = torch._foreach_add(gs, ps, alpha=self.weight_decay)
        torch._foreach_mul_(bufs, mom)
        torch._foreach_add_(bufs, gs)
        torch._foreach_add_(ps, bufs, alpha=-lr)
        state["count"] += 1


@dataclass(frozen=True)
class RMSprop:
    """``init(params)`` makes the state: the update count, the squared
    averages ``nu`` and, where momentum is callable, one momentum buffer per
    parameter; ``update(params, grads, state)`` applies one step in place
    and advances the count."""

    learning_rate: Schedule
    momentum: Schedule = 0.9  # a trace only where callable
    weight_decay: float = 0.0

    def init(self, params: Dict[str, torch.Tensor]) -> dict:
        state = {"count": 0,
                 "nu": {k: torch.zeros_like(p) for k, p in params.items()}}
        if callable(self.momentum):
            state["momentum"] = {k: torch.zeros_like(p)
                                 for k, p in params.items()}
        return state

    @torch.no_grad()
    def update(self, params: Dict[str, torch.Tensor],
               grads: Sequence[torch.Tensor], state: dict) -> None:
        lr = _at(self.learning_rate, state["count"])
        ps = list(params.values())
        nus = [state["nu"][k] for k in params]
        gs = list(grads)
        if self.weight_decay:
            gs = torch._foreach_add(gs, ps, alpha=self.weight_decay)
        torch._foreach_mul_(nus, _RMS_DECAY)
        torch._foreach_addcmul_(nus, gs, gs, value=1.0 - _RMS_DECAY)
        denom = torch._foreach_sqrt(nus)
        torch._foreach_add_(denom, _RMS_EPS)
        upd = torch._foreach_div(gs, denom)
        if callable(self.momentum):
            bufs = [state["momentum"][k] for k in params]
            torch._foreach_mul_(bufs, _at(self.momentum, state["count"]))
            torch._foreach_add_(bufs, upd)
            upd = bufs
        torch._foreach_add_(ps, upd, alpha=-lr)
        state["count"] += 1


def make_optimizer(name: str, learning_rate: Schedule,
                   momentum: Schedule = 0.9, weight_decay: float = 0.0,
                   grad_clip: Optional[float] = None, every_k: int = 1,
                   nonfinite_backoff: Optional[float] = None
                   ) -> Union[SGD, RMSprop]:
    """``make_optimizer("sgd" | "rmsprop", lr, momentum, weight_decay)``;
    everything else raises until ROADMAP A14."""
    if name.lower() == "adam":
        raise NotImplementedError(
            f"optimizer {name!r} is not ported yet (ROADMAP A14)")
    if name.lower() not in ("sgd", "rmsprop"):
        raise ValueError(f"unknown optimizer {name!r}")
    for opt, value, off in (("grad_clip", grad_clip, None),
                            ("every_k", every_k, 1),
                            ("nonfinite_backoff", nonfinite_backoff, None)):
        if value != off:
            raise NotImplementedError(
                f"{opt}={value!r} is not ported yet (ROADMAP A14)")
    if name.lower() == "rmsprop":
        return RMSprop(learning_rate, momentum, weight_decay)
    return SGD(learning_rate, momentum, weight_decay)
