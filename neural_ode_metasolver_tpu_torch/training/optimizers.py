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
``training/fleet.py``) take the same elementwise rules, and each member
keeps its own counts, as JAX's vmapped state does: ``init(params,
members=S)`` makes every count a list of S numbers (``count``,
``mini_step``, ``emits``, ``scale``, ``n_skipped``), and ``update(...,
members=S)`` clips each member by its own global norm and backs off each
member on its own finiteness.  While the members' counts agree (a fleet
that never skipped), the step is the single run's, on one shared value of
each count; once they differ, the host evaluates each member's lr,
momentum and bias corrections and the card scales member m's slice by
them.  ``skip`` (a bool, or a list for a fleet's members) drops a step as
``skip_nonfinite`` does: the skipped run or member keeps its tensors and
counts, and the backoff records the skip (JAX forces the gradients of a
skipped step to NaN, ``train.py:255-297``).

The update is in place, with ``torch._foreach_*`` ops over all parameters.
The state is a dict of Python numbers (a fleet's: lists of them) and dicts
of tensors by parameter name, which ``torch.save`` writes as is.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from ..parallel.mesh import tp_global_norm, tp_sharding_of

__all__ = ["SGD", "RMSprop", "Adam", "Optimizer", "make_optimizer",
           "global_norm", "keep_members"]

Schedule = Union[float, Callable[[int], float]]
# torch RMSprop's defaults, as the JAX chain fixes them: alpha, and eps
# added outside the sqrt
_RMS_DECAY, _RMS_EPS = 0.99, 1e-8
# optax scale_by_adam's defaults, as the JAX chain takes them
_ADAM_B1, _ADAM_B2, _ADAM_EPS = 0.9, 0.999, 1e-8
# with_nonfinite_backoff's recovery and floor, as make_optimizer takes them
_RECOVERY, _MIN_SCALE = 1.1, 1e-3
# the state's numbers: per member in a fleet
_COUNTS = ("count", "mini_step", "emits", "scale", "n_skipped")


def _each(fn, value):
    """``fn`` of a number, or of each member's number in a fleet's list."""
    return [fn(v) for v in value] if isinstance(value, list) else fn(value)


def _at(value: Schedule, count):
    return _each(lambda c: float(value(c)) if callable(value)
                 else float(value), count)


def _per_member(n: Optional[int], value):
    return value if n is None else [value] * n


def _rows(values: Sequence, tensors: Sequence[torch.Tensor],
          dtype: Optional[torch.dtype] = None) -> List[torch.Tensor]:
    """A fleet's per-member numbers (or flags, with ``dtype`` bool) as one
    (S,) tensor on the tensors' device, viewed to scale (or select along)
    each tensor's leading (member) axis."""
    vec = torch.tensor(list(values), dtype=dtype or tensors[0].dtype,
                       device=tensors[0].device)
    return [vec.view((-1,) + (1,) * (t.dim() - 1)) for t in tensors]


def _mul_(tensors: List[torch.Tensor], factor) -> None:
    if isinstance(factor, list):
        for t, f in zip(tensors, _rows(factor, tensors)):
            t.mul_(f)
    else:
        torch._foreach_mul_(tensors, factor)


def _div(tensors: List[torch.Tensor], factor) -> List[torch.Tensor]:
    if isinstance(factor, list):
        return [t / f for t, f in zip(tensors, _rows(factor, tensors))]
    return torch._foreach_div(tensors, factor)


def _zeros(params: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: torch.zeros_like(p) for k, p in params.items()}


def _buffers(state: dict) -> List[torch.Tensor]:
    """The state's tensors (rule buffers and ``acc``)."""
    return [t for v in state.values() if isinstance(v, dict)
            for t in v.values()]


def keep_members(new: Sequence[torch.Tensor], old: Sequence[torch.Tensor],
                 keep: Sequence[bool]) -> None:
    """Restore, in place, the rows (members) of ``new`` not in ``keep``
    from ``old``, by selection: a NaN in a restored row does not leak."""
    if not new:
        return
    with torch.no_grad():
        for t, o, mask in zip(new, old, _rows(keep, new, torch.bool)):
            t.copy_(torch.where(mask, t, o))


def global_norm(tensors: Sequence[torch.Tensor],
                members: Optional[int] = None,
                like: Optional[Sequence[torch.Tensor]] = None
                ) -> torch.Tensor:
    """The L2 norm of all the tensors together (optax ``global_norm``);
    with ``members`` S, each member's over its slices t[m], (S,).
    ``like``, the parameters the tensors belong to: where some hold this
    rank's slices of a ``model`` axis, the norm of the global tensors
    (``parallel.mesh.tp_global_norm``)."""
    if like is not None and any(tp_sharding_of(p) is not None
                                for p in like):
        return tp_global_norm(tensors, like)
    if members is not None:
        return torch.linalg.vector_norm(torch.stack([
            torch.linalg.vector_norm(t.reshape(members, -1), dim=1)
            for t in tensors]), dim=0)
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(
        list(tensors))))


def _member_update(advance, params: Dict[str, torch.Tensor],
                   gs: List[torch.Tensor], state: dict, members: int,
                   active: List[bool]) -> None:
    """One iteration of a fleet: ``advance(params, gs, state, members)``
    (the single run's step, for numbers or per-member lists), after which
    the members not ``active`` get their tensors and counts back.  While
    every member is active and the counts agree, ``advance`` runs on one
    shared number of each count: the single run's step exactly."""
    if not any(active):
        return
    counts = {k: state[k] for k in _COUNTS if k in state}
    if all(active) and all(len(set(v)) == 1 for v in counts.values()):
        view = dict(state, **{k: v[0] for k, v in counts.items()})
        advance(params, gs, view, members)
        state.update({k: [view[k]] * members for k in counts})
        return
    tensors = held = None
    if not all(active):
        tensors = list(params.values()) + _buffers(state)
        held = [t.detach().clone() for t in tensors]
    advance(params, gs, state, members)
    if held is not None:
        keep_members(tensors, held, active)
        for k, old in counts.items():
            state[k] = [n if a else o
                        for n, o, a in zip(state[k], old, active)]


def _active(members: int, skip) -> List[bool]:
    return [True] * members if skip is None else [not s for s in skip]


@dataclass(frozen=True)
class _Rule:
    """The update rule: ``init(params)`` makes its state (the update count
    and its buffers by parameter name); ``update(params, grads, state)``
    applies one step in place and advances the count.  ``apply`` is the
    step the wrappers drive, with the lr read at ``lr_count``, the
    momentum schedule and bias correction at ``rule_count``, and the
    update multiplied by ``scale``; a fleet's per-member lists of them
    scale each member's slice by its own."""

    learning_rate: Schedule
    momentum: Schedule = 0.9
    weight_decay: float = 0.0

    def init(self, params: Dict[str, torch.Tensor],
             members: Optional[int] = None) -> dict:
        return {"count": _per_member(members, 0),
                **{k: _zeros(params) for k in self._buffers()}}

    def _buffers(self) -> List[str]:
        raise NotImplementedError

    def _direction(self, gs, state, names, rule_count) -> List[torch.Tensor]:
        raise NotImplementedError

    @torch.no_grad()
    def apply(self, params: Dict[str, torch.Tensor],
              grads: Sequence[torch.Tensor], state: dict, lr_count,
              rule_count, scale=1.0) -> None:
        ps = list(params.values())
        gs = list(grads)
        if self.weight_decay:
            gs = torch._foreach_add(gs, ps, alpha=self.weight_decay)
        upd = self._direction(gs, state, list(params), rule_count)
        lr = _at(self.learning_rate, lr_count)
        if not isinstance(lr, list) and not isinstance(scale, list):
            torch._foreach_add_(ps, upd, alpha=-lr * scale)
            return
        n = len(lr if isinstance(lr, list) else scale)
        step = [-a * b for a, b in zip(
            lr if isinstance(lr, list) else [lr] * n,
            scale if isinstance(scale, list) else [scale] * n)]
        for p, u, f in zip(ps, upd, _rows(step, ps)):
            p.add_(u * f)

    def _advance(self, params, gs, state, members) -> None:
        self.apply(params, gs, state, state["count"], state["count"])
        state["count"] = _each(lambda c: c + 1, state["count"])

    @torch.no_grad()
    def update(self, params: Dict[str, torch.Tensor],
               grads: Sequence[torch.Tensor], state: dict,
               members: Optional[int] = None, skip=None) -> None:
        """One step in place; ``members`` S for a fleet's state, ``skip``
        (a bool, or one a member) drops the step of the run or member."""
        if members is None:
            if not skip:
                self._advance(params, list(grads), state, None)
            return
        _member_update(self._advance, params, list(grads), state, members,
                       _active(members, skip))


@dataclass(frozen=True)
class SGD(_Rule):
    """SGD with momentum (the trace), buffers ``momentum``."""

    def _buffers(self):
        return ["momentum"]

    def _direction(self, gs, state, names, rule_count):
        bufs = [state["momentum"][k] for k in names]
        _mul_(bufs, _at(self.momentum, rule_count))
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
            _mul_(bufs, _at(self.momentum, rule_count))
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
        mu_hat = _div(mus, _each(
            lambda c: float(np.float32(1 - _ADAM_B1 ** (c + 1))), rule_count))
        nu_hat = _div(nus, _each(
            lambda c: float(np.float32(1 - _ADAM_B2 ** (c + 1))), rule_count))
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

    def init(self, params: Dict[str, torch.Tensor],
             members: Optional[int] = None) -> dict:
        state = self.rule.init(params, members)
        if self.every_k > 1:
            state.update(acc=_zeros(params),
                         mini_step=_per_member(members, 0),
                         emits=_per_member(members, 0))
        if self.nonfinite_backoff is not None:
            state.update(scale=_per_member(members, 1.0),
                         n_skipped=_per_member(members, 0))
        return state

    def _dip(self, scale: float) -> float:
        dipped = np.float32(scale) * np.float32(self.nonfinite_backoff)
        return max(_f32(dipped), _f32(_MIN_SCALE))

    @torch.no_grad()
    def update(self, params: Dict[str, torch.Tensor],
               grads: Sequence[torch.Tensor], state: dict,
               members: Optional[int] = None, skip=None) -> None:
        """One iteration in place.  ``members`` S: a fleet's state, each
        member clipped by its own norm and backed off on its own
        finiteness.  ``skip`` (a bool, or one a member) drops the
        iteration of the run or member, which the backoff records as a
        non-finite one."""
        gs = list(grads)
        backoff = self.nonfinite_backoff is not None
        if members is None:
            if backoff and (skip or not bool(torch.isfinite(
                    global_norm(gs, like=list(params.values()))))):
                state["scale"] = self._dip(state["scale"])
                state["n_skipped"] += 1
            elif not skip:
                self._advance(params, gs, state, None)
            return
        active = _active(members, skip)
        if backoff:
            if any(active):
                finite = torch.isfinite(global_norm(gs, members)).tolist()
                active = [a and f for a, f in zip(active, finite)]
            state["scale"] = [s if a else self._dip(s)
                              for s, a in zip(state["scale"], active)]
            state["n_skipped"] = [n if a else n + 1
                                  for n, a in zip(state["n_skipped"],
                                                  active)]
        _member_update(self._advance, params, gs, state, members, active)

    def _advance(self, params, gs, state, members) -> None:
        """The iteration of finite gradients: the backoff's scale, the
        accumulation, clipping, the rule.  A fleet's members out of phase
        under ``every_k`` (after a skip) emit apart: the members that do
        not emit keep their params and rule buffers."""
        scale = 1.0
        if self.nonfinite_backoff is not None:
            scale = state["scale"]
            state["scale"] = _each(lambda s: min(_f32(
                np.float32(s) * np.float32(_RECOVERY)), 1.0), scale)
        rule_count = state["count"]
        emit = hold = None
        if self.every_k > 1:
            names = list(params)
            acc = [state["acc"][k] for k in names]
            m = state["mini_step"]
            # optax MultiSteps' running mean: acc + (g - acc) / (m + 1)
            diff = torch._foreach_sub(gs, acc)
            if isinstance(m, list):
                diff = _div(diff, [float(v + 1) for v in m])
            else:
                torch._foreach_div_(diff, float(m + 1))
            torch._foreach_add_(acc, diff)
            emit = _each(lambda v: v >= self.every_k - 1, m)
            if not any(emit if isinstance(emit, list) else [emit]):
                state["mini_step"] = _each(lambda v: v + 1, m)
                state["count"] = _each(lambda c: c + 1, state["count"])
                return
            gs = [a.clone() for a in acc]
            rule_count = state["emits"]
            if isinstance(emit, list) and not all(emit):
                hold = list(params.values()) + [
                    state[b][k] for b in self.rule._buffers() for k in names]
                held = [t.detach().clone() for t in hold]
        if self.grad_clip is not None:
            gn = global_norm(gs, members, like=list(params.values()))
            per = ((lambda g: gn.reshape((-1,) + (1,) * (g.dim() - 1)))
                   if members is not None else (lambda g: gn))
            gs = [torch.where(per(g) < self.grad_clip, g,
                              g / per(g) * self.grad_clip) for g in gs]
        self.rule.apply(params, gs, state, state["count"], rule_count, scale)
        if hold is not None:
            keep_members(hold, held, emit)
        state["count"] = _each(lambda c: c + 1, state["count"])
        if self.every_k > 1:
            if isinstance(emit, list):
                state["emits"] = [e + 1 if on else e
                                  for e, on in zip(state["emits"], emit)]
                state["mini_step"] = [0 if on else v + 1
                                      for v, on in zip(state["mini_step"],
                                                       emit)]
                accs = [state["acc"][k] for k in params]
                for a, on in zip(accs, _rows(emit, accs, torch.bool)):
                    a.masked_fill_(on, 0.0)
            else:
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
