"""Plain float32 PyTorch references of the benchmark's configurations.

A configuration file names its reference module here by ``"reference"``;
each module gives ``check(cfg)``, ``param_spec(cfg)``, ``forward(cfg,
weights, x, u, activation, precision)`` and ``forward_ops(cfg, batch)``.
The references import nothing of the program under test and compute with
TF32 off (``common.precision_flags``).
"""
from __future__ import annotations

import importlib
from types import ModuleType


def load(name: str) -> ModuleType:
    """The reference module ``benchmark/reference/<name>.py``."""
    return importlib.import_module(f"{__name__}.{name}")
