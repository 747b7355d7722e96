"""Import reference (SOPA) checkpoints into the port's models (port of
models/torch_import.py).

The reference ships trained models as pickled torch modules or
state_dicts (``sopa/src/models/utils.py:36`` ``load_model``,
``examples/mnist/checkpoints/checkpoint_15444.pth``).  These functions map
such a state_dict onto the port's :class:`~.api.Model`: torch OIHW conv
weight -> HWIO kernel, torch (out, in) linear weight -> (in, out) kernel,
norm ``weight``/``bias`` -> ``scale``/``bias``.  They take any mapping of
state_dict names to array-likes (CPU tensors, numpy arrays) and return
the Model's ``state_dict`` entries of its parameters (f32 CPU tensors
named ``params.<tree path>``), as ``convert.py``'s ``*_from_jax`` do::

    sd = torch.load("model_best_0.pth", weights_only=False)["state_dict"]
    model.load_state_dict(mnist_params_from_torch_state_dict(sd))
"""
from __future__ import annotations

import re
from typing import Any, Mapping

import numpy as np

from .convert import cifar_params_from_jax, mnist_params_from_jax

__all__ = [
    "mnist_params_from_torch_state_dict",
    "cifar_params_from_torch_state_dict",
]


def _arr(sd: Mapping[str, Any], name: str) -> np.ndarray:
    if name not in sd:
        raise KeyError(
            f"state_dict is missing {name!r} — not a conv-downsampling "
            f"odenet MNIST MetaNODE checkpoint? keys: {sorted(sd)[:8]}..."
        )
    return np.asarray(sd[name], dtype=np.float32)


def _oihw_to_hwio(arr: np.ndarray) -> np.ndarray:
    """torch Conv2d weight (O, I, H, W) -> HWIO kernel (H, W, I, O): the
    one place the conv layout conversion lives (both importers use it)."""
    return arr.transpose(2, 3, 1, 0)


def _conv(sd, prefix):
    out = {"kernel": _oihw_to_hwio(_arr(sd, prefix + ".weight"))}
    if prefix + ".bias" in sd:
        out["bias"] = _arr(sd, prefix + ".bias")
    return out


def _norm(sd, prefix):
    return {"scale": _arr(sd, prefix + ".weight"),
            "bias": _arr(sd, prefix + ".bias")}


def _linear(sd, prefix):
    out = {"kernel": _arr(sd, prefix + ".weight").T}
    if prefix + ".bias" in sd:
        out["bias"] = _arr(sd, prefix + ".bias")
    return out


def cifar_params_from_torch_state_dict(sd: Mapping[str, Any],
                                       block_type: str = "prebasic"):
    """A reference CIFAR (pre)MetaNODE state_dict -> the port Model's
    parameter entries (odenet_cifar10/layers.py:380-530).

    Covers the norm-free family (NF/PNF configs: bias-free convs
    everywhere, one final linear).  Name map:

      ``conv1.weight``                              -> ``conv1.kernel``
      ``layerL.blocks_res.i.conv{1,2}.weight``      -> ``layerL.res.i.conv{1,2}.kernel``
      ``layerL.blocks_res.i.shortcut.0.weight``     -> ``layerL.res.i.sc_conv.kernel``
      ``layerL.blocks_ode.i.rhs_func.conv{1,2}.weight`` -> ``layerL.ode.i.conv{1,2}.kernel``
      ``fc_layers.K.{weight,bias}``                 -> ``fc.{kernel,bias}``

    A state_dict with norm parameters (BN/GN weights) raises with the
    offending keys: their running statistics belong in the model state and
    need a config-aware import.  ``block_type`` (``"prebasic"``,
    premetanode*, or ``"basic"``, metanode*) names the target family, as
    the JAX function takes it; NF checkpoints of both have the same names,
    and the port's trees carry no None leaves, so the entries are the same.
    """
    if block_type not in ("prebasic", "basic"):
        raise ValueError(f"unknown block_type {block_type!r}")
    out: dict = {}
    unknown = []
    for name, v in sd.items():
        arr = np.asarray(v, dtype=np.float32)
        if name == "conv1.weight":
            out.setdefault("conv1", {})["kernel"] = _oihw_to_hwio(arr)
            continue
        m = re.fullmatch(
            r"layer(\d+)\.blocks_(res|ode)\.(\d+)\."
            r"(?:rhs_func\.)?conv([12])\.weight",
            name,
        )
        if m:
            layer, kind, idx, ci = m.groups()
            blocks = out.setdefault(f"layer{layer}", {}).setdefault(kind, {})
            blocks.setdefault(int(idx), {})[f"conv{ci}"] = {
                "kernel": _oihw_to_hwio(arr)
            }
            continue
        m = re.fullmatch(
            r"layer(\d+)\.blocks_res\.(\d+)\.shortcut\.0\.weight", name
        )
        if m:
            layer, idx = m.groups()
            blocks = out.setdefault(f"layer{layer}", {}).setdefault("res", {})
            blocks.setdefault(int(idx), {})["sc_conv"] = {
                "kernel": _oihw_to_hwio(arr)
            }
            continue
        m = re.fullmatch(r"fc_layers\.\d+\.(weight|bias)", name)
        if m:
            fc = out.setdefault("fc", {})
            slot = "kernel" if m.group(1) == "weight" else "bias"
            if slot in fc:
                raise ValueError(
                    f"multiple linear layers in fc_layers ({name} would "
                    "overwrite an earlier one) — unsupported head layout"
                )
            fc[slot] = arr.T if slot == "kernel" else arr
            continue
        unknown.append(name)
    if unknown:
        raise ValueError(
            "unsupported state_dict entries (norm-bearing checkpoints need "
            f"a config-aware import): {unknown}"
        )
    # index dicts -> lists, in block order
    for lname, layer in out.items():
        if lname.startswith("layer"):
            for kind, blocks in layer.items():
                layer[kind] = [blocks[i] for i in sorted(blocks)]
    return cifar_params_from_jax(out)


def mnist_params_from_torch_state_dict(sd: Mapping[str, Any]):
    """A reference MNIST MetaNODE state_dict -> the port Model's parameter
    entries (odenet, conv downsampling; layers.py:96-209).

    Expected names: ``downsampling_layers.{0,3,6}`` convs with norms at
    ``{1,4}``, one ``blocks.0.rhs_func`` ODEfunc (norm1/conv1/norm2/conv2/
    norm3 with ConcatConv2d ``._layer`` nesting), and a
    ``fc_layers.{0,4}`` head (norm + linear).  Any other entry (extra ODE
    blocks, res-downsampling variants) raises rather than being silently
    dropped.
    """
    expected = set()
    for prefix in ("downsampling_layers.0", "downsampling_layers.3",
                   "downsampling_layers.6", "blocks.0.rhs_func.conv1._layer",
                   "blocks.0.rhs_func.conv2._layer", "fc_layers.4"):
        expected.update({prefix + ".weight", prefix + ".bias"})
    for prefix in ("downsampling_layers.1", "downsampling_layers.4",
                   "blocks.0.rhs_func.norm1", "blocks.0.rhs_func.norm2",
                   "blocks.0.rhs_func.norm3", "fc_layers.0"):
        expected.update({prefix + ".weight", prefix + ".bias"})
    extra = sorted(set(sd) - expected)
    if extra:
        raise ValueError(
            "state_dict has entries this importer does not map (a different "
            f"MetaNODE variant?): {extra}"
        )
    return mnist_params_from_jax({
        "down": {
            "conv0": _conv(sd, "downsampling_layers.0"),
            "norm0": _norm(sd, "downsampling_layers.1"),
            "conv1": _conv(sd, "downsampling_layers.3"),
            "norm1": _norm(sd, "downsampling_layers.4"),
            "conv2": _conv(sd, "downsampling_layers.6"),
        },
        "blocks": [
            {
                "norm1": _norm(sd, "blocks.0.rhs_func.norm1"),
                "conv1": _conv(sd, "blocks.0.rhs_func.conv1._layer"),
                "norm2": _norm(sd, "blocks.0.rhs_func.norm2"),
                "conv2": _conv(sd, "blocks.0.rhs_func.conv2._layer"),
                "norm3": _norm(sd, "blocks.0.rhs_func.norm3"),
            }
        ],
        "head": {
            "norm": _norm(sd, "fc_layers.0"),
            "fc": _linear(sd, "fc_layers.4"),
        },
    })
