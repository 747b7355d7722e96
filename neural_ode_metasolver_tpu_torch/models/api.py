"""Model interface of the port (port of models/api.py).

``build_model(name, device=None, *, generator=None, init_scheme=None,
**overrides)`` builds ``"mnist"`` or any name of the CIFAR registry
(``metanode*``, ``premetanode*``), draws its parameters and model state
from a seeded ``torch.Generator`` and returns a :class:`Model`: an
``nn.Module`` that holds the family's parameter tree (nested
``ModuleDict``/``ModuleList``/``ParameterDict``, so ``state_dict`` names
are the JAX tree's paths under ``params.``), its model state as buffers
(BN running statistics, SN vectors, named by the JAX state tree's paths
under ``state.``), and whose forward is the family's apply function
(``apply_mnist`` or ``apply_cifar``).  It runs on the CUDA card unless the
caller passes ``device="cpu"``; without a card it raises.

A fleet (``training/fleet.py``) keeps S members' params and model state
outside the model, stacked along a leading axis and named as the model's
own: ``forward(x, ..., params=model.param_tree(flat), model_state=
model.state_tree(flat))`` runs them, and ``init_state_dict(generator)``
draws one member's, as ``build_model`` with that generator draws.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple, Union

import torch
from torch import nn

from ..backend import full_f32, resolve_device
from ..ops.regimes import SolverOptions
from ..parallel.mesh import mark_tp, tp_sharding_of
from .nn import apply_init_scheme
from .odenet_cifar10 import MODEL_REGISTRY, apply_cifar, init_cifar
from .odenet_mnist import MnistConfig, apply_mnist, init_mnist

__all__ = ["Model", "build_model", "make_cifar_model"]


class _Buffers(nn.Module):
    """A dict of tensors held as buffers."""

    def __init__(self, tensors: Dict[str, torch.Tensor]):
        super().__init__()
        for k, v in tensors.items():
            self.register_buffer(k, v)


def _as_module(tree: Any, leaf: Callable) -> nn.Module:
    """Nested dicts/lists of tensors -> nested ModuleDict/ModuleList with
    ``leaf(dict)`` at each dict of tensors."""
    if isinstance(tree, dict):
        if all(isinstance(v, torch.Tensor) for v in tree.values()):
            return leaf(tree)
        return nn.ModuleDict({k: _as_module(v, leaf) for k, v in tree.items()})
    if isinstance(tree, (list, tuple)):
        return nn.ModuleList([_as_module(v, leaf) for v in tree])
    raise TypeError(f"unexpected parameter-tree node {type(tree).__name__}")


def _params_leaf(tree: Dict[str, torch.Tensor]) -> nn.Module:
    return nn.ParameterDict({k: nn.Parameter(v) for k, v in tree.items()})


def _detach(p: torch.Tensor) -> torch.Tensor:
    """A detached view of a parameter, which keeps the parameter's
    tensor-parallel mark (``parallel.mesh.tp_sharding_of``)."""
    rule = tp_sharding_of(p)
    d = p.detach()
    return d if rule is None else mark_tp(d, rule)


def _tree(node: Any) -> Any:
    """A module tree as nested dicts and lists of its tensors: detached
    views of the parameters, the buffers themselves."""
    if isinstance(node, nn.ParameterDict):
        return {k: _detach(v) for k, v in node.items()}
    if isinstance(node, _Buffers):
        return dict(node.named_buffers(recurse=False))
    if isinstance(node, nn.ModuleDict):
        return {k: _tree(v) for k, v in node.items()}
    return [_tree(v) for v in node]


def _tree_of(node: Any, flat: Dict[str, torch.Tensor], prefix: str) -> Any:
    """The family's tree of ``node``'s structure, its leaves taken from
    ``flat`` by name (``prefix`` then the path)."""
    if isinstance(node, nn.ParameterDict):
        return {k: flat[f"{prefix}.{k}"] for k in node.keys()}
    if isinstance(node, _Buffers):
        return {k: flat[f"{prefix}.{k}"]
                for k, _ in node.named_buffers(recurse=False)}
    if isinstance(node, nn.ModuleDict):
        return {k: _tree_of(v, flat, f"{prefix}.{k}")
                for k, v in node.items()}
    return [_tree_of(v, flat, f"{prefix}.{i}") for i, v in enumerate(node)]


def _flatten(tree: Any, prefix: str, out: dict) -> dict:
    if isinstance(tree, dict):
        for k, v in tree.items():
            _flatten(v, f"{prefix}.{k}", out)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            _flatten(v, f"{prefix}.{i}", out)
    else:
        out[prefix] = tree
    return out


class Model(nn.Module):
    """A MetaNODE: ``forward(x_nhwc, solvers, solver_options)`` -> logits in
    x's dtype, eval mode unless ``train=True``.  ``input_shape`` is one
    image's (H, W, C).

    An f32 forward computes in full f32, kernels and plain ops alike: it
    runs under ``backend.full_f32()``, so cuDNN never takes TF32 for its
    convs whatever the process flags say.  ``params`` runs the forward on
    another tree of the same structure, such as ``detached_params()`` (the
    attack's forward, which must not reach the weights), and
    ``model_state`` on another state tree (a fleet's).  The forward reads
    the model state from the buffers and never writes them: in train mode
    ``return_aux=True`` gives the new state as ``aux["model_state"]``, and
    ``commit_state`` copies it in (the train step does, once a step's
    update is accepted).  ``generator``, a
    CPU ``torch.Generator``, serves the switch and ensemble regimes one
    draw per ODE block; standalone draws nothing.  ``pipeline`` (a CIFAR
    model's ``parallel.PipelineConfig``, given to ``make_cifar_model``)
    routes its ODE-block stacks through GPipe."""

    def __init__(self, cfg: Any, params: dict, state: dict,
                 apply_fn: Callable, input_shape: Tuple[int, int, int],
                 init_fn: Optional[Callable] = None, pipeline: Any = None):
        super().__init__()
        self.cfg = cfg
        self.pipeline = pipeline
        self.init_fn = init_fn
        self.params = _as_module(params, _params_leaf)
        self.state = _as_module(state, _Buffers)
        self.apply_fn = apply_fn
        self.input_shape = tuple(input_shape)

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device

    def detached_params(self) -> Any:
        """The parameters as the family's nested dicts and lists of
        detached views (same storage, no gradient)."""
        return _tree(self.params)

    def model_state(self) -> Any:
        """The model state as the family's nested dicts and lists of the
        buffers themselves."""
        return _tree(self.state)

    def param_tree(self, flat: Dict[str, torch.Tensor]) -> Any:
        """The family's parameter tree with the leaves of ``flat`` (by
        ``named_parameters`` name, e.g. a fleet's stacked params)."""
        return _tree_of(self.params, flat, "params")

    def state_tree(self, flat: Dict[str, torch.Tensor]) -> Any:
        """The model-state tree with the leaves of ``flat`` (by
        ``named_buffers`` name)."""
        return _tree_of(self.state, flat, "state")

    def init_state_dict(self, generator: torch.Generator
                        ) -> Dict[str, torch.Tensor]:
        """Fresh params and model state drawn from ``generator`` as
        ``build_model`` draws them (the same init scheme), by
        ``state_dict`` name, on the model's device."""
        if self.init_fn is None:
            raise ValueError("this model was not built by build_model")
        params, state = self.init_fn(generator)
        out = _flatten(params, "params", {})
        _flatten(state, "state", out)
        dev = self.device
        return {k: v.to(dev) for k, v in out.items()}

    def commit_state(self, new_state: Any) -> None:
        """Copy a state tree (``aux["model_state"]`` of a train-mode
        forward) into the buffers, in place."""
        flat = _flatten(new_state, "state", {})
        with torch.no_grad():
            for name, buf in self.named_buffers():
                buf.copy_(flat[name])

    def forward(self, x: torch.Tensor, solvers, solver_options=None, *,
                use_kernels: bool = True, train: bool = False,
                params: Any = None, model_state: Any = None,
                generator: Optional[torch.Generator] = None, **options: Any):
        if solver_options is None:
            solver_options = SolverOptions()
        if self.pipeline is not None:
            options = dict(options, pipeline=self.pipeline)
        with full_f32():
            return self.apply_fn(
                self.params if params is None else params, x, solvers,
                solver_options, cfg=self.cfg,
                state=(self.model_state() if model_state is None
                       else model_state),
                use_kernels=use_kernels, train=train, generator=generator,
                **options)


def make_cifar_model(cfg, device: Optional[Union[str, torch.device]] = None,
                     *, pipeline: Any = None,
                     generator: Optional[torch.Generator] = None,
                     init_scheme: Optional[str] = None) -> Model:
    """A CIFAR-family model of ``cfg`` (a ``CifarConfig``), drawn as
    ``build_model`` draws; ``pipeline`` (a ``parallel.PipelineConfig``)
    makes the forward route same-shape ODE-block stacks through GPipe over
    its mesh's pp axis (JAX ``models/api.py:70-87``)."""
    return _build(cfg, lambda g: init_cifar(cfg, g), apply_cifar,
                  (32, 32, 3), device, generator, init_scheme, pipeline)


def _build(cfg, init, apply_fn, shape, device, generator, init_scheme,
           pipeline=None) -> Model:
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator().manual_seed(0)

    def init_fn(g: torch.Generator):
        params, state = init(g)
        if init_scheme is not None:
            params = apply_init_scheme(g, params, init_scheme)
        return params, state

    params, state = init_fn(generator)
    return Model(cfg, params, state, apply_fn, shape, init_fn,
                 pipeline).to(dev)


def build_model(name: str, device: Optional[Union[str, torch.device]] = None,
                *, generator: Optional[torch.Generator] = None,
                init_scheme: Optional[str] = None, **overrides) -> Model:
    """Registry entry point: ``"mnist"`` (``MnistConfig`` overrides) or a
    CIFAR registry name (``CifarConfig`` overrides: ``norms``,
    ``num_gn_groups``, ``param_norms``, ``acts``, ``is_odenet``,
    ``faithful_preact_bug``, ``in_planes``, ``num_blocks``, ...).

    Parameters and state are drawn on the CPU from ``generator`` (default:
    seed 0), so a seed gives the same weights on every device, then moved
    to ``device``.  ``init_scheme`` (``"orthogonal"`` or ``"xavier"``, the
    CIFAR runner's ``--init``) then re-initializes the kernels from the
    same generator (``nn.apply_init_scheme``)."""
    if name == "mnist":
        cfg = MnistConfig(**overrides)
        return _build(cfg, lambda g: (init_mnist(cfg, g), {}), apply_mnist,
                      (28, 28, cfg.in_channels), device, generator,
                      init_scheme)
    if name in MODEL_REGISTRY:
        return make_cifar_model(MODEL_REGISTRY[name](**overrides), device,
                                generator=generator, init_scheme=init_scheme)
    raise ValueError(f"unknown model {name!r}")
