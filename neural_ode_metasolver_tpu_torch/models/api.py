"""Model interface of the port (port of models/api.py).

``build_model(name, device=None, *, generator=None, **overrides)`` builds
``"mnist"`` or a ``premetanode*`` registry config, draws its parameters from
a seeded ``torch.Generator`` and returns a :class:`Model`: an ``nn.Module``
that holds the family's parameter tree (nested ``ModuleDict``/``ModuleList``/
``ParameterDict``, so ``state_dict`` names are the JAX tree's paths under
``params.``) and whose forward is the family's apply function
(``apply_mnist`` or ``apply_cifar``).  It runs on the CUDA card unless the
caller passes ``device="cpu"``; without a card it raises.
"""
from __future__ import annotations

from typing import Any, Callable, Optional, Tuple, Union

import torch
from torch import nn

from ..backend import full_f32, resolve_device
from ..ops.regimes import SolverOptions
from .odenet_cifar10 import MODEL_REGISTRY, apply_cifar, init_cifar
from .odenet_mnist import MnistConfig, apply_mnist, init_mnist

__all__ = ["Model", "build_model"]

# registry names of the JAX package that later slices port
_NOT_PORTED = {f"metanode{d}": "A11" for d in (4, 6, 10, 18, 34)}


def _as_module(tree: Any) -> nn.Module:
    """Nested dicts/lists of tensors -> nested ModuleDict/ModuleList with a
    ParameterDict at each dict of tensors."""
    if isinstance(tree, dict):
        if all(isinstance(v, torch.Tensor) for v in tree.values()):
            return nn.ParameterDict({k: nn.Parameter(v)
                                     for k, v in tree.items()})
        return nn.ModuleDict({k: _as_module(v) for k, v in tree.items()})
    if isinstance(tree, (list, tuple)):
        return nn.ModuleList([_as_module(v) for v in tree])
    raise TypeError(f"unexpected parameter-tree node {type(tree).__name__}")


def _detached(node: Any) -> Any:
    """A ModuleDict/ModuleList/ParameterDict tree as nested dicts and lists
    of detached views of its tensors."""
    if isinstance(node, nn.ParameterDict):
        return {k: v.detach() for k, v in node.items()}
    if isinstance(node, nn.ModuleDict):
        return {k: _detached(v) for k, v in node.items()}
    return [_detached(v) for v in node]


class Model(nn.Module):
    """A MetaNODE: ``forward(x_nhwc, solvers, solver_options)`` -> logits in
    x's dtype, eval mode unless ``train=True``.  ``input_shape`` is one
    image's (H, W, C).

    An f32 forward computes in full f32, kernels and plain ops alike: it
    runs under ``backend.full_f32()``, so cuDNN never takes TF32 for its
    convs whatever the process flags say.  ``params`` runs the forward on
    another tree of the same structure, such as ``detached_params()`` (the
    attack's forward, which must not reach the weights).  ``generator``, a
    CPU ``torch.Generator``, serves the switch and ensemble regimes one
    draw per ODE block; standalone draws nothing."""

    def __init__(self, cfg: Any, params: dict, apply_fn: Callable,
                 input_shape: Tuple[int, int, int]):
        super().__init__()
        self.cfg = cfg
        self.params = _as_module(params)
        self.apply_fn = apply_fn
        self.input_shape = tuple(input_shape)

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device

    def detached_params(self) -> Any:
        """The parameters as the family's nested dicts and lists of
        detached views (same storage, no gradient)."""
        return _detached(self.params)

    def forward(self, x: torch.Tensor, solvers, solver_options=None, *,
                use_kernels: bool = True, train: bool = False,
                params: Any = None,
                generator: Optional[torch.Generator] = None, **options: Any):
        if solver_options is None:
            solver_options = SolverOptions()
        with full_f32():
            return self.apply_fn(
                self.params if params is None else params, x, solvers,
                solver_options, cfg=self.cfg, use_kernels=use_kernels,
                train=train, generator=generator, **options)


def build_model(name: str, device: Optional[Union[str, torch.device]] = None,
                *, generator: Optional[torch.Generator] = None,
                **overrides) -> Model:
    """Registry entry point: ``"mnist"`` (``MnistConfig`` overrides) or a
    ``premetanode*`` name (``CifarConfig`` overrides).

    Parameters are drawn on the CPU from ``generator`` (default: seed 0),
    so a seed gives the same weights on every device, then moved to
    ``device``."""
    dev = resolve_device(device)
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"model {name!r} is not ported yet (ROADMAP {_NOT_PORTED[name]})")
    if name == "mnist":
        cfg = MnistConfig(**overrides)
        init, apply_fn, shape = init_mnist, apply_mnist, (28, 28,
                                                          cfg.in_channels)
    elif name in MODEL_REGISTRY:
        cfg = MODEL_REGISTRY[name](**overrides)
        init, apply_fn, shape = init_cifar, apply_cifar, (32, 32, 3)
    else:
        raise ValueError(f"unknown model {name!r}")
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    return Model(cfg, init(cfg, generator), apply_fn, shape).to(dev)
