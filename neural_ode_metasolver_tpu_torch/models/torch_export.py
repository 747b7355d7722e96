"""Export the port's parameter trees as reference (SOPA) checkpoints (port of
models/torch_export.py).

The inverse of :mod:`torch_import`: a model trained in the port can be
handed back to a reference user as a checkpoint their own code loads —
``sopa/src/models/utils.py:36`` ``load_model`` for MNIST
(``{'state_dict', 'args', 'solver_id'}``, the ``model_best_{id}.pth``
schema, odenet_mnist/runner.py:225-226) and the CIFAR full-checkpoint
schema (``{'model', 'optimizer', 'amp', 'lr_scheduler', 'iter',
'wandb_config'}``, examples/cifar10/train_and_attack.py:548-557) that the
Evaluate notebook rebuilds a model from (cells 4-6: ``Namespace(**
checkpoint['wandb_config'])`` + ``model.load_state_dict(
checkpoint['model'])``).

``params`` is the port's parameter tree, nested dicts and lists of tensors
as ``Model.detached_params()`` returns them (any device; the NF norms are
absent, as the port's trees leave out the JAX tree's None leaves).
Layouts: HWIO conv kernel -> torch OIHW ``weight``, (in, out) linear
kernel -> torch (out, in), ``scale``/``bias`` -> norm ``weight``/``bias``.
The ``*_state_dict_from_params`` functions return ``OrderedDict[str,
torch.Tensor]`` (f32 CPU copies) in the reference module's parameter
order, the ``save_*_reference_checkpoint`` wrappers ``torch.save`` them.

The MNIST schema carries an ``argparse.Namespace`` (as the reference writes
it, runner.py:225-226), which ``torch.load``'s ``weights_only=True`` default
rejects: load with ``torch.serialization.add_safe_globals(
[argparse.Namespace])`` or ``weights_only=False``, as the reference's own
artifacts need on torch >= 2.6.
"""
from __future__ import annotations

import argparse
from collections import OrderedDict
from typing import Any, Mapping, Optional

import torch

__all__ = [
    "mnist_state_dict_from_params",
    "cifar_state_dict_from_params",
    "reference_wandb_config",
    "save_mnist_reference_checkpoint",
    "save_cifar_reference_checkpoint",
]


def _t(leaf) -> torch.Tensor:
    """An f32 CPU copy of a leaf (never a view of the model's tensor)."""
    return torch.as_tensor(leaf).detach().to("cpu", torch.float32,
                                              copy=True)


def _put_conv(out: OrderedDict, prefix: str, conv: Mapping[str, Any]):
    out[prefix + ".weight"] = _t(conv["kernel"]).permute(3, 2, 0, 1
                                                          ).contiguous()
    if conv.get("bias") is not None:
        out[prefix + ".bias"] = _t(conv["bias"])


def _put_norm(out: OrderedDict, prefix: str, norm: Mapping[str, Any]):
    out[prefix + ".weight"] = _t(norm["scale"])
    out[prefix + ".bias"] = _t(norm["bias"])


def _put_linear(out: OrderedDict, prefix: str, lin: Mapping[str, Any]):
    out[prefix + ".weight"] = _t(lin["kernel"]).t().contiguous()
    if lin.get("bias") is not None:
        out[prefix + ".bias"] = _t(lin["bias"])


def mnist_state_dict_from_params(params: Mapping[str, Any]) -> OrderedDict:
    """The MNIST MetaNODE's parameter tree (odenet, conv downsampling) ->
    the reference module's state_dict, the exact inverse of
    ``mnist_params_from_torch_state_dict``.

    Keys follow the reference module's registration order
    (odenet_mnist/layers.py:96-209): ``downsampling_layers.{0,1,3,4,6}``,
    ``blocks.0.rhs_func.{norm1,conv1._layer,norm2,conv2._layer,norm3}``,
    ``fc_layers.{0,4}``.
    """
    out: OrderedDict = OrderedDict()
    down = params["down"]
    _put_conv(out, "downsampling_layers.0", down["conv0"])
    _put_norm(out, "downsampling_layers.1", down["norm0"])
    _put_conv(out, "downsampling_layers.3", down["conv1"])
    _put_norm(out, "downsampling_layers.4", down["norm1"])
    _put_conv(out, "downsampling_layers.6", down["conv2"])
    blocks = params["blocks"]
    if len(blocks) != 1:
        raise ValueError(
            f"reference MNIST MetaNODE has exactly 1 ODE block; params "
            f"carry {len(blocks)}"
        )
    b = blocks[0]
    _put_norm(out, "blocks.0.rhs_func.norm1", b["norm1"])
    _put_conv(out, "blocks.0.rhs_func.conv1._layer", b["conv1"])
    _put_norm(out, "blocks.0.rhs_func.norm2", b["norm2"])
    _put_conv(out, "blocks.0.rhs_func.conv2._layer", b["conv2"])
    _put_norm(out, "blocks.0.rhs_func.norm3", b["norm3"])
    _put_norm(out, "fc_layers.0", params["head"]["norm"])
    _put_linear(out, "fc_layers.4", params["head"]["fc"])
    return out


def cifar_state_dict_from_params(params: Mapping[str, Any]) -> OrderedDict:
    """A CIFAR (pre)MetaNODE parameter tree -> the reference module's
    state_dict, the exact inverse of ``cifar_params_from_torch_state_dict``
    (the NF/PNF norm-free family: bias-free convs everywhere, one final
    linear; odenet_cifar10/layers.py:380-530).

    A tree with norm parameters (``bn*`` entries) raises: their running
    statistics live in the model state and need a config-aware export.
    """
    out: OrderedDict = OrderedDict()
    _require_normfree(params.get("bn1"), "bn1")
    _put_conv(out, "conv1", params["conv1"])
    for lname in sorted(k for k in params if k.startswith("layer")):
        layer = params[lname]
        for kind, torch_kind, rhs in (("res", "blocks_res", ""),
                                      ("ode", "blocks_ode", "rhs_func.")):
            for i, b in enumerate(layer.get(kind, [])):
                prefix = f"{lname}.{torch_kind}.{i}."
                _require_normfree(b.get("bn1"), prefix + "bn1")
                _require_normfree(b.get("bn2"), prefix + "bn2")
                _require_normfree(b.get("sc_bn"), prefix + "sc_bn")
                _put_conv(out, prefix + rhs + "conv1", b["conv1"])
                _put_conv(out, prefix + rhs + "conv2", b["conv2"])
                if b.get("sc_conv") is not None:
                    _put_conv(out, prefix + "shortcut.0", b["sc_conv"])
    _put_linear(out, "fc_layers.2", params["fc"])
    return out


def _require_normfree(leaf, name: str):
    if leaf is not None:
        raise ValueError(
            f"norm-bearing param tree ({name} is not None) — only the "
            "norm-free NF/PNF family exports to the reference state_dict "
            "schema (running statistics need a config-aware export)"
        )


def save_mnist_reference_checkpoint(
    path: str,
    params: Mapping[str, Any],
    *,
    args: Optional[Mapping[str, Any]] = None,
    solver_id: int = 0,
) -> None:
    """Write a ``model_best_{id}.pth``-schema checkpoint that the
    reference's ``load_model`` (sopa/src/models/utils.py:36-48) rebuilds.

    ``load_model`` destructures the top-level dict *by insertion order*
    (``(_, state_dict), (_, model_args), (_, solver_id) = ....items()``),
    so the key order is part of the format.  ``args`` entries are merged
    over the minimal defaults ``load_model`` reads (``network``,
    ``downsampling_method``, ``in_channels``); pass e.g. ``{"solvers":
    [["rk2", "u", 8, -1, 0.5, -1]]}`` for the reference attacks_runner's
    solver rebuild (odenet_mnist/attacks_runner.py:65).
    """
    ns = {"network": "odenet", "downsampling_method": "conv",
          "in_channels": 1}
    ns.update(dict(args or {}))
    ckpt = OrderedDict()
    ckpt["state_dict"] = mnist_state_dict_from_params(params)
    ckpt["args"] = argparse.Namespace(**ns)
    ckpt["solver_id"] = solver_id
    torch.save(ckpt, path)


def reference_wandb_config(cfg, **extra) -> dict:
    """The ``wandb_config`` dict the reference Evaluate notebook rebuilds a
    CIFAR model from (cells 4-6): network, in_planes, is_odenet and the 9
    normalization / param-normalization / activation selector strings
    (examples/cifar10/train_and_attack.py:161-182).

    ``cfg`` is a :class:`CifarConfig`; the registry name is the entry whose
    ``num_blocks`` and ``block_type`` it matches (the notebook does
    ``getattr(cifar10_models, config.network)``, so a non-registry
    ``num_blocks`` has no reference constructor and raises here).
    GeLUpoly and GeLUtanh export as ``GeLU``: the reference registry has
    only the erf form, which they approximate (models/nn.py).
    """
    from .odenet_cifar10 import MODEL_REGISTRY

    name = None
    for reg_name, factory in MODEL_REGISTRY.items():
        ref = factory()
        if (ref.num_blocks == cfg.num_blocks
                and ref.block_type == cfg.block_type):
            name = reg_name
            break
    if name is None:
        raise ValueError(
            f"num_blocks={cfg.num_blocks!r} block_type={cfg.block_type!r} "
            "matches no reference registry constructor "
            "(metanode*/premetanode*) — the reference cannot rebuild it "
            "from a wandb_config"
        )
    ref_act = {"GeLUpoly": "GeLU", "GeLUtanh": "GeLU"}
    config = {
        "network": name,
        "in_planes": cfg.in_planes,
        "is_odenet": cfg.is_odenet,
        "normalization_resblock": cfg.norms[0],
        "normalization_odeblock": cfg.norms[1],
        "normalization_bn1": cfg.norms[2],
        "param_normalization_resblock": cfg.param_norms[0],
        "param_normalization_odeblock": cfg.param_norms[1],
        "param_normalization_bn1": cfg.param_norms[2],
        "activation_resblock": ref_act.get(cfg.acts[0], cfg.acts[0]),
        "activation_odeblock": ref_act.get(cfg.acts[1], cfg.acts[1]),
        "activation_bn1": ref_act.get(cfg.acts[2], cfg.acts[2]),
    }
    config.update(extra)
    return config


def save_cifar_reference_checkpoint(
    path: str,
    params: Mapping[str, Any],
    cfg,
    *,
    iter: int = 0,
    wandb_config_extra: Optional[Mapping[str, Any]] = None,
) -> None:
    """Write an ``amp_checkpoint_{itr}.pth``-schema checkpoint
    (examples/cifar10/train_and_attack.py:548-557) that the reference
    Evaluate notebook loads.

    The notebook reads only ``model`` and ``wandb_config``; the other
    slots (``optimizer``/``amp``/``lr_scheduler``) hold torch/apex state
    of the reference's own training loop, so they are ``None`` here, to
    keep the key schema for tooling that indexes by key.
    """
    ckpt = OrderedDict()
    ckpt["model"] = cifar_state_dict_from_params(params)
    ckpt["optimizer"] = None
    ckpt["amp"] = None
    ckpt["lr_scheduler"] = None
    ckpt["iter"] = iter
    ckpt["wandb_config"] = reference_wandb_config(
        cfg, **dict(wandb_config_extra or {}))
    torch.save(ckpt, path)
