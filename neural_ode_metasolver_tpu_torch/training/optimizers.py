"""SGD with torch-parity semantics (port of training/optimizers.py,
``make_optimizer("sgd", ...)``).

The JAX optimizer is the optax chain add_decayed_weights(wd) -> trace(m) ->
scale_by_learning_rate(lr): weight decay is coupled into the gradient
before the momentum trace, the trace starts at zero (so the first buffer is
g), and the update is p -= lr * buf: torch SGD with dampening 0.  lr and
momentum may be schedules of the step; both are evaluated at the count of
updates made so far (the pre-increment count optax's ``inject_hyperparams``
and ``scale_by_schedule`` see).

The update is in place, with ``torch._foreach_*`` ops over all parameters.
rmsprop, adam, gradient clipping, ``every_k`` accumulation and the
non-finite backoff land with ROADMAP A14 and raise until then.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional, Sequence, Union

import torch

__all__ = ["SGD", "make_optimizer"]

Schedule = Union[float, Callable[[int], float]]


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


def make_optimizer(name: str, learning_rate: Schedule,
                   momentum: Schedule = 0.9, weight_decay: float = 0.0,
                   grad_clip: Optional[float] = None, every_k: int = 1,
                   nonfinite_backoff: Optional[float] = None) -> SGD:
    """``make_optimizer("sgd", lr, momentum, weight_decay)``; everything
    else raises until ROADMAP A14."""
    if name.lower() in ("rmsprop", "adam"):
        raise NotImplementedError(
            f"optimizer {name!r} is not ported yet (ROADMAP A14)")
    if name.lower() != "sgd":
        raise ValueError(f"unknown optimizer {name!r}")
    for opt, value, off in (("grad_clip", grad_clip, None),
                            ("every_k", every_k, 1),
                            ("nonfinite_backoff", nonfinite_backoff, None)):
        if value != off:
            raise NotImplementedError(
                f"{opt}={value!r} is not ported yet (ROADMAP A14)")
    return SGD(learning_rate, momentum, weight_decay)
