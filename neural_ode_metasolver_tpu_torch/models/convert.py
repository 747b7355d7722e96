"""Carry JAX-package weights into the port (counterpart of
``models/torch_export.py::cifar_state_dict_from_params``).

Both packages keep NHWC activations and HWIO / (in, out) kernels, so the
conversion maps names and copies, and transposes nothing.  The input is a
JAX parameter tree as nested dicts and lists of numpy arrays
(``jax.tree_util.tree_map(np.asarray, params)``); the output is a
``state_dict`` for :class:`~neural_ode_metasolver_tpu_torch.models.api.Model`:

    model.load_state_dict(cifar_params_from_jax(np_params))   # init_cifar
    model.load_state_dict(mnist_params_from_jax(np_params))   # init_mnist

For CIFAR only the norm-free NF/PNF family converts: its norm leaves are
``None`` and are dropped; a tree that carries norm parameters raises.  The
MNIST tree's GroupNorm scales and biases convert like any other leaf.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Any, Mapping, Tuple

import numpy as np
import torch

__all__ = ["cifar_params_from_jax", "mnist_params_from_jax"]

_CIFAR_NORM_KEYS = ("bn1", "bn2", "sc_bn")


def _walk(node: Any, path: str, out: OrderedDict,
          refused: Tuple[str, ...]) -> None:
    if isinstance(node, Mapping):
        for k, v in node.items():
            name = f"{path}.{k}"
            if v is None:
                continue
            if k in refused:
                raise ValueError(
                    f"norm-bearing parameter tree ({name[len('params.'):]} is "
                    "not None): only the norm-free NF/PNF family is ported")
            _walk(v, name, out, refused)
    elif isinstance(node, (list, tuple)):
        for i, v in enumerate(node):
            _walk(v, f"{path}.{i}", out, refused)
    else:
        out[path] = torch.tensor(np.asarray(node, dtype=np.float32))


def cifar_params_from_jax(params: Mapping[str, Any]) -> "OrderedDict[str, torch.Tensor]":
    """JAX CIFAR parameter tree (numpy leaves) -> the port Model's
    ``state_dict`` (f32 CPU tensors, names ``params.<tree path>``)."""
    out: OrderedDict = OrderedDict()
    _walk(params, "params", out, _CIFAR_NORM_KEYS)
    return out


def mnist_params_from_jax(params: Mapping[str, Any]) -> "OrderedDict[str, torch.Tensor]":
    """JAX ``init_mnist`` parameter tree (numpy leaves) -> the port Model's
    ``state_dict`` (f32 CPU tensors, names ``params.<tree path>``)."""
    out: OrderedDict = OrderedDict()
    _walk(params, "params", out, ())
    return out
