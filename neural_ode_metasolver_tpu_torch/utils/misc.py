"""Shared helpers (port of utils/misc.py; reference
sopa/src/models/utils.py, odenet_mnist/utils.py).

``fix_seeds`` seeds Python's ``random``, numpy and torch (every device's
default generator) and returns the seed; the port's entry points take
explicit ``torch.Generator`` objects seeded from it, as the JAX package
takes keys.
"""
from __future__ import annotations

import contextlib
import logging
import os
import random
from typing import Mapping, Union

import numpy as np
import torch

__all__ = ["fix_seeds", "count_parameters", "makedirs", "get_logger",
           "atomic_write"]


@contextlib.contextmanager
def atomic_write(path: str, mode: str = "w", **open_kwargs):
    """Open a same-directory temp file for writing and ``os.replace`` it
    onto ``path`` on clean exit, so an interrupted write never leaves a
    truncated file at ``path``; on an exception the temp file is removed
    and ``path`` is untouched.  The temp name carries the pid."""
    tmp = f"{path}.{os.getpid()}.tmp"
    try:
        with open(tmp, mode, **open_kwargs) as f:
            yield f
    except BaseException:
        with contextlib.suppress(OSError):
            os.remove(tmp)
        raise
    os.replace(tmp, path)


def fix_seeds(seed: int = 502) -> int:
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    return seed


def count_parameters(params: Union[torch.nn.Module,
                                   Mapping[str, torch.Tensor]]) -> int:
    """Total trainable parameter count (odenet_mnist/utils.py:21-23) of a
    module or a name -> tensor mapping."""
    if isinstance(params, torch.nn.Module):
        params = dict(params.named_parameters())
    return sum(int(p.numel()) for p in params.values())


def makedirs(dirname: str):
    os.makedirs(dirname, exist_ok=True)


def get_logger(
    logpath: str,
    displaying: bool = True,
    saving: bool = True,
    debug: bool = False,
    name: str = "nodems",
) -> logging.Logger:
    """File+console logger (odenet_mnist/utils.py:30-55); a second call
    with the same name closes and replaces the first's handlers."""
    logger = logging.getLogger(name)
    level = logging.DEBUG if debug else logging.INFO
    logger.setLevel(level)
    for h in logger.handlers:
        h.close()
    logger.handlers.clear()
    if saving:
        makedirs(os.path.dirname(os.path.abspath(logpath)))
        fh = logging.FileHandler(logpath)
        fh.setLevel(level)
        logger.addHandler(fh)
    if displaying:
        ch = logging.StreamHandler()
        ch.setLevel(level)
        logger.addHandler(ch)
    return logger
