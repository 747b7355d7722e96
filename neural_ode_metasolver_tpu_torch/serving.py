"""Serving (port of serving.py): ``ServedModel``, ``export_model`` and
``load_model``.

``ServedModel(model, solvers, solver_options, compute_dtype=None)`` is a
callable that answers one request: a batch of NHWC images of any size in,
f32 logits out, under ``torch.inference_mode()``, for either family (MNIST
or CIFAR), in eval mode: a CIFAR net with BN or SN reads its running
statistics and SN vectors from the model's buffers and never writes them.  The default computes in f32, the dtype of the shipped MNIST
artifact (``examples/checkpoints/mnist_digits_smoothing_served``), and in
full f32: no TF32, whatever the process flags (``Model.forward``).  With
``compute_dtype=torch.bfloat16`` it is the port of the JAX
``training/train.py::_cast_model``: the input is cast to bf16, each conv
casts its f32 weights to bf16 at the call, and the logits come back in f32.

``export_model`` freezes what a ``ServedModel`` computes into an artifact
with ``torch.export`` (the JAX package writes versioned StableHLO with
``jax.export``); ``load_model`` serves it without the model code.  An
artifact is a directory::

    <path>/model.pt2     the exported program (torch.export.save)
    <path>/config.json   the caller's config, then the reserved keys
                         input_shape, input_dtype, batch_polymorphic and
                         platforms (the device type it was exported on)

Example::

    export_model(dir, model, solvers, SolverOptions(),
                 input_shape=(1, 28, 28, 1))
    served = load_model(dir)      # on the card; load_model(dir, "cpu")
    logits = served(x)            # any batch size if batch_polymorphic

Kernels B1, B2 and B3 are in the graph as the custom ops of
``ops/library.py``, so a loaded artifact launches the same kernels, and
counts the same launches, as the live model.  The weights, the solvers and
the regime are baked in.  The switch and ensemble regimes draw on the host
at each forward: with no generator to draw from, their export raises, as
their live ``ServedModel`` does and as the JAX export does without a PRNG
key; no draw is ever baked into a graph.
"""
from __future__ import annotations

import json
import os
from typing import Optional, Sequence, Tuple, Union

import torch

from .backend import full_f32, resolve_device, span
from .ops import library  # noqa: F401  the nodems:: ops a program calls
from .ops.regimes import SolverOptions

__all__ = ["ServedModel", "LoadedModel", "export_model", "load_model"]

_PROGRAM, _CONFIG = "model.pt2", "config.json"


class ServedModel:
    """A model with its solvers bound in; call it like a function."""

    def __init__(self, model, solvers: Sequence, solver_options:
                 Optional[SolverOptions] = None,
                 compute_dtype: Optional[torch.dtype] = None):
        if compute_dtype not in (None, torch.float32, torch.bfloat16):
            raise ValueError(f"compute_dtype {compute_dtype} not supported")
        self.model = model.eval()
        self.solvers = list(solvers)
        self.solver_options = solver_options or SolverOptions()
        self.compute_dtype = compute_dtype

    @property
    def device(self) -> torch.device:
        return self.model.device

    def logits(self, x: torch.Tensor) -> torch.Tensor:
        """The forward of checked images on the model's device (what
        ``export_model`` traces)."""
        x = x.to(self.compute_dtype or torch.float32).contiguous()
        return self.model(x, self.solvers, self.solver_options).float()

    def __call__(self, x) -> torch.Tensor:
        """(B, *model.input_shape) images (tensor or array, any device):
        (B, 28, 28, 1) for MNIST, (B, 32, 32, 3) for CIFAR -> (B,
        num_classes) f32 logits on the model's device.  The call is one
        span ``serve.request`` (a unit, ``batch`` its images) holding
        ``serve.copy_in`` (``bytes`` the images' host bytes) and the
        model's ``ode.solve`` spans (``backend.span``)."""
        with span("serve.request", unit=True, batch=_leading(x)), \
                torch.inference_mode():
            with span("serve.copy_in", bytes=getattr(x, "nbytes", None)):
                x = torch.as_tensor(x, device=self.device)
            if x.dim() != 4 or tuple(x.shape[1:]) != self.model.input_shape:
                raise ValueError(f"images {tuple(x.shape)} are not (B, "
                                 f"{', '.join(map(str, self.model.input_shape))})")
            return self.logits(x)


def _leading(x) -> Optional[int]:
    """The leading size of an array or tensor, or None (a scalar, a list):
    checked with the rest of the shape after the copy in."""
    shape = getattr(x, "shape", ())
    return int(shape[0]) if len(shape) else None


class _Program(torch.nn.Module):
    """``ServedModel.logits`` as a module, for ``torch.export``."""

    def __init__(self, served: ServedModel):
        super().__init__()
        self.model = served.model
        self.served = served

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.served.logits(x)


def export_model(
    path: str,
    model,
    solvers: Sequence,
    solver_options: Optional[SolverOptions] = None,
    *,
    input_shape: Tuple[int, ...],
    input_dtype: torch.dtype = torch.float32,
    batch_polymorphic: bool = True,
    config: Optional[dict] = None,
    compute_dtype: Optional[torch.dtype] = None,
) -> None:
    """Export ``ServedModel(model, solvers, solver_options,
    compute_dtype)`` under ``torch.no_grad()`` to ``path``, on the model's
    device.

    ``input_shape`` includes the batch dimension; with
    ``batch_polymorphic`` the program takes any batch of at least 1 (it is
    traced at a batch of at least 2, since ``torch.export`` would fix a
    traced size of 1), else exactly ``input_shape``.  ``config`` is
    written to ``config.json`` first and the reserved keys after it, so
    they win."""
    served = ServedModel(model, solvers, solver_options, compute_dtype)
    shape = tuple(int(d) for d in input_shape)
    if len(shape) != 4 or shape[1:] != served.model.input_shape:
        raise ValueError(f"input_shape {shape} is not (B, "
                         f"{', '.join(map(str, served.model.input_shape))})")
    batch = max(2, shape[0]) if batch_polymorphic else shape[0]
    example = torch.zeros((batch,) + shape[1:], dtype=input_dtype,
                          device=served.device)
    dynamic = ({0: torch.export.Dim("batch", min=1)},) \
        if batch_polymorphic else None
    with torch.no_grad():
        program = torch.export.export(_Program(served), (example,),
                                      dynamic_shapes=dynamic, strict=False)
    os.makedirs(path, exist_ok=True)
    torch.export.save(program, os.path.join(path, _PROGRAM))
    meta = {
        **(config or {}),
        "input_shape": list(shape),
        "input_dtype": str(input_dtype).removeprefix("torch."),
        "batch_polymorphic": batch_polymorphic,
        "platforms": [served.device.type],
    }
    with open(os.path.join(path, _CONFIG), "w") as f:
        json.dump(meta, f, indent=1)


def _attr(module: torch.nn.Module, target: str):
    for name in target.split("."):
        module = getattr(module, name)
    return module


def _lean(module: torch.fx.GraphModule) -> torch.fx.GraphModule:
    """Take out of a loaded graph the work that no request needs:
    ``torch.export``'s runtime metadata asserts, ``.to`` calls to the
    dtype a tensor already has, and every aten op whose inputs are all
    constants (the solver's grid and tableau arithmetic, the weights' casts
    and views), computed once here by the same op on the same device.
    Kernels, shapes and the input guards stay; each request's results are
    unchanged, bit for bit."""
    graph = module.graph
    known = {}  # node -> its value, for the constant ones
    for node in list(graph.nodes):
        if node.op == "get_attr":
            value = _attr(module, node.target)
            if isinstance(value, torch.Tensor):
                known[node] = value
            continue
        op = node.target
        if node.op != "call_function" or not isinstance(
                op, torch._ops.OpOverload) or op.namespace != "aten":
            continue
        if op is torch.ops.aten._assert_tensor_metadata.default:
            graph.erase_node(node)
        elif (all(n in known for n in node.all_input_nodes)
              and not op._schema.is_mutable
              and torch.Tag.nondeterministic_seeded not in op.tags):
            args, kwargs = torch.fx.node.map_arg(
                (node.args, node.kwargs), lambda n: known[n])
            value = known[node] = op(*args, **kwargs)
            if isinstance(value, torch.Tensor):
                name = f"_folded_{len(known)}"
                module.register_buffer(name, value.detach(), persistent=False)
                with graph.inserting_before(node):
                    folded = graph.get_attr(name)
                known[folded] = value
                node.replace_all_uses_with(folded)
            else:  # a dtype or a number: a literal in its users' args
                for user in list(node.users):
                    user.args, user.kwargs = torch.fx.node.map_arg(
                        (user.args, user.kwargs),
                        lambda n: value if n is node else n)
        elif (op is torch.ops.aten.to.dtype and not node.kwargs
              and len(node.args) == 2
              and getattr(node.args[0].meta.get("val"), "dtype",
                          None) == node.args[1]):
            node.replace_all_uses_with(node.args[0])  # .to returns self
    for node in reversed(graph.nodes):
        if (not node.users and node.op in ("call_function", "get_attr")
                and not node.is_impure()):
            graph.erase_node(node)
    module.recompile()
    return module


class LoadedModel:
    """A loaded export: call it like a function; the weights are inside.
    ``config`` is the artifact's ``config.json``."""

    def __init__(self, program, config: dict, device: torch.device):
        self._module = _lean(program.module())
        self.config = config
        self.device = device
        self.input_dtype = getattr(torch, config["input_dtype"])

    def __call__(self, x) -> torch.Tensor:
        """Images of the artifact's shape (any batch if it is batch
        polymorphic) -> f32 logits on the artifact's device, in full f32
        as the live model computes (a loaded graph's convs and matmuls
        would otherwise follow the process's TF32 flags)."""
        with torch.inference_mode(), full_f32():
            x = torch.as_tensor(x, device=self.device).to(self.input_dtype)
            return self._module(x)


def load_model(path: str,
               device: Optional[Union[str, torch.device]] = None
               ) -> LoadedModel:
    """Load an :func:`export_model` artifact onto ``device`` (the card
    unless the caller asks for the CPU).  An artifact exported on another
    device type is moved there (``move_to_device_pass``); the graph's
    constant arithmetic is computed once here (``_lean``).  Needs the
    port's op registration only, none of the model-building code."""
    dev = resolve_device(device)
    with open(os.path.join(path, _CONFIG)) as f:
        config = json.load(f)
    program = torch.export.load(os.path.join(path, _PROGRAM))
    if config["platforms"] != [dev.type]:
        from torch.export.passes import move_to_device_pass

        program = move_to_device_pass(program, dev)
    return LoadedModel(program, config, dev)
