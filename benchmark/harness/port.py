"""The program's side that every driver builds alike: the port's model and
solver from a configuration file, and seeded images on the device.

A configuration's ``build`` holds the keyword arguments of the port's
``build_model(port_model, ...)``, lists read as tuples; its optional
``build_activation`` names the keyword that takes the cell's activation and
how many copies of it (``{"acts": 3}``: one per stage).  A new
configuration is therefore a new file, and no edit here.
"""
from __future__ import annotations

import torch


def _tuples(v):
    if isinstance(v, list):
        return tuple(_tuples(i) for i in v)
    return v


def build_kwargs(cfg: dict, activation: str) -> dict:
    """The keyword arguments of ``build_model`` for ``cfg`` and the cell's
    ``activation``."""
    kw = {k: _tuples(v) for k, v in cfg.get("build", {}).items()}
    for key, copies in cfg.get("build_activation", {}).items():
        kw[key] = (activation,) * int(copies)
    return kw


def model(cfg: dict, activation: str, device):
    """The port's model for ``cfg`` on ``device``; its own initial weights
    are replaced by the benchmark's."""
    from neural_ode_metasolver_tpu_torch.models import build_model

    return build_model(cfg["port_model"], device=device,
                       **build_kwargs(cfg, activation))


def solver(cfg: dict):
    """The port's u-parametrized solver of ``cfg``'s ``solver`` entry."""
    from neural_ode_metasolver_tpu_torch.ops import create_solver

    s = cfg["solver"]
    return create_solver(s["method"], "u", n_steps=s["n_steps"], u0=s["u"])


def images(shape, kind: str, g: torch.Generator, device) -> torch.Tensor:
    """Seeded images on ``device``: N(0, 1) for "normal", else U[0, 1)."""
    if kind == "normal":
        return torch.randn(shape, generator=g, device=device)
    return torch.rand(shape, generator=g, device=device)
