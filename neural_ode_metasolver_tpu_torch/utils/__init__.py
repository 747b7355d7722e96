"""Cross-cutting utilities of the port: seeding, logging, param counting
(mirrors the JAX ``utils``)."""
from .misc import (
    atomic_write,
    count_parameters,
    fix_seeds,
    get_logger,
    makedirs,
)

__all__ = ["atomic_write", "count_parameters", "fix_seeds", "get_logger",
           "makedirs"]
