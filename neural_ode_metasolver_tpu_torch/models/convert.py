"""Carry JAX-package weights into the port (counterpart of
``models/torch_export.py::cifar_state_dict_from_params``).

Both packages keep NHWC activations and HWIO / (in, out) kernels, so the
conversion maps names and copies, and transposes nothing.  The input is a
JAX parameter tree as nested dicts and lists of numpy arrays
(``jax.tree_util.tree_map(np.asarray, params)``); the output is a
``state_dict`` for :class:`~neural_ode_metasolver_tpu_torch.models.api.Model`:

    model.load_state_dict(cifar_params_from_jax(np_params))   # init_cifar
    model.load_state_dict(mnist_params_from_jax(np_params))   # init_mnist

Norm parameters (``scale``/``bias``) and WN's ``wn_g`` convert like any
other leaf; the tree's None leaves (the NF norms, PNF's missing state) are
left out, as the port's trees leave them out.  ``cifar_state_from_jax``
carries a JAX model state (BN's ``mean``/``var``, SN's ``sn_u``) onto the
model's buffers, so both packages compute the same thing:

    model.load_state_dict({**cifar_params_from_jax(np_params),
                           **cifar_state_from_jax(np_state)})

``rmsprop_state_from_jax`` carries an RMSprop optimizer state across, so a
JAX checkpoint's training resumes in the port:

    state = create_train_state(model, make_optimizer("rmsprop", ...),
                               mnist_params_from_jax(np_params),
                               rmsprop_state_from_jax(np_opt_state, step),
                               step=step)

with ``np_opt_state = jax.tree_util.tree_map(np.asarray, ts.opt_state)``
and ``step = int(ts.step)``.

A fleet's members (``training/fleet.py``) are S such state dicts stacked
along a leading axis: ``stack_members([mnist_params_from_jax(p) for p in
trees])``, or ``mnist_params_from_jax`` of a JAX fleet's stacked tree,
whose leaves already carry the axis.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Any, Mapping

import numpy as np
import torch

__all__ = ["cifar_params_from_jax", "cifar_state_from_jax",
           "mnist_params_from_jax", "rmsprop_state_from_jax",
           "stack_members"]


def _walk(node: Any, path: str, out: OrderedDict) -> OrderedDict:
    if isinstance(node, Mapping):
        for k, v in node.items():
            if v is not None:
                _walk(v, f"{path}.{k}", out)
    elif isinstance(node, (list, tuple)):
        for i, v in enumerate(node):
            _walk(v, f"{path}.{i}", out)
    else:
        out[path] = torch.tensor(np.asarray(node, dtype=np.float32))
    return out


def cifar_params_from_jax(params: Mapping[str, Any]) -> "OrderedDict[str, torch.Tensor]":
    """JAX CIFAR parameter tree (numpy leaves) -> the port Model's
    ``state_dict`` entries of its parameters (f32 CPU tensors, names
    ``params.<tree path>``)."""
    return _walk(params, "params", OrderedDict())


def cifar_state_from_jax(state: Mapping[str, Any]) -> "OrderedDict[str, torch.Tensor]":
    """JAX CIFAR model state (numpy leaves: BN ``mean``/``var``, SN
    ``sn_u``) -> the port Model's ``state_dict`` entries of its buffers
    (f32 CPU tensors, names ``state.<tree path>``)."""
    return _walk(state, "state", OrderedDict())


def mnist_params_from_jax(params: Mapping[str, Any]) -> "OrderedDict[str, torch.Tensor]":
    """JAX ``init_mnist`` parameter tree (numpy leaves) -> the port Model's
    ``state_dict`` (f32 CPU tensors, names ``params.<tree path>``)."""
    return _walk(params, "params", OrderedDict())


def _state_fields(node: Any, found: dict) -> None:
    """Collect the optax state fields ``nu`` and ``trace`` and every
    ``count`` of an optimizer-state tree (named tuples, tuples, lists,
    dicts)."""
    fields = getattr(node, "_fields", None)
    if fields is not None:
        for name in fields:
            value = getattr(node, name)
            if name == "count":
                found.setdefault("counts", []).append(int(np.asarray(value)))
            elif name in ("nu", "trace"):
                if name in found:
                    raise ValueError(f"optimizer state holds more than one "
                                     f"{name!r}")
                found[name] = value
            else:
                _state_fields(value, found)
    elif isinstance(node, Mapping):
        for value in node.values():
            _state_fields(value, found)
    elif isinstance(node, (list, tuple)):
        for value in node:
            _state_fields(value, found)


def rmsprop_state_from_jax(opt_state: Any, step: int) -> dict:
    """A JAX ``make_optimizer("rmsprop", ...)`` state (numpy leaves) -> the
    port's ``RMSprop`` state: ``nu`` by parameter name (``params.<tree
    path>``), the momentum trace where the JAX chain has one (a callable
    momentum), and the update count.  A constant-lr chain keeps no count,
    so it is ``step``, the TrainState's; the counts of schedules must
    equal it."""
    found: dict = {}
    _state_fields(opt_state, found)
    if "nu" not in found:
        raise ValueError("no RMSprop state (nu) in this optimizer state")
    count = int(step)
    if any(c != count for c in found.get("counts", [])):
        raise ValueError(f"the optimizer's counts {found['counts']} are "
                         f"not step {count}")
    out = {"count": count, "nu": dict(mnist_params_from_jax(found["nu"]))}
    if "trace" in found:
        out["momentum"] = dict(mnist_params_from_jax(found["trace"]))
    return out


def stack_members(state_dicts) -> "OrderedDict[str, torch.Tensor]":
    """S state dicts of one model -> one whose tensors are stacked (S,
    ...): a fleet's members, for ``create_fleet_state(...,
    state_dict=...)``."""
    return OrderedDict((k, torch.stack([torch.as_tensor(d[k])
                                        for d in state_dicts]))
                       for k in state_dicts[0])
