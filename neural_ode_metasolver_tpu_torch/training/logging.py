"""Experiment logging: JSONL metrics stream + optional wandb mirror (port of
training/logging.py, plain Python, kept as the port's own copy).

The reference logs through wandb (``wandb.init(project=..., entity=
"sopa_node")``, runner_new.py:108-112; per-step scalars at
train_validate.py:80-84,169-178,335-342).  The primary sink here is an
append-only ``metrics.jsonl``: a ``_type: config`` line, then one JSON
object per log call with ``_time`` (seconds since the logger opened) and
``step``.  With ``use_wandb`` and the ``wandb`` package importable the same
stream is mirrored to it.  In a process group of several ranks only rank 0
opens and writes the file (and the wandb run); the others' calls do
nothing.
"""
from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Optional

from ..parallel.mesh import rank

__all__ = ["MetricsLogger"]

try:  # optional dependency
    import wandb as _wandb
except Exception:  # pragma: no cover
    _wandb = None


class MetricsLogger:
    def __init__(
        self,
        log_dir: str,
        config: Optional[Dict[str, Any]] = None,
        use_wandb: bool = False,
        project: str = "neural-ode-metasolver-tpu",
        entity: Optional[str] = None,
    ):
        self.path = os.path.join(log_dir, "metrics.jsonl")
        self._t0 = time.time()
        self.wandb_run = None
        self._f = None
        if rank() != 0:
            return
        os.makedirs(log_dir, exist_ok=True)
        self._f = open(self.path, "a")
        if use_wandb and _wandb is not None:
            self.wandb_run = _wandb.init(project=project, entity=entity,
                                         config=config)
        if config is not None:
            self._write({"_type": "config", **_jsonable(config)})

    def log(self, metrics: Dict[str, Any], step: Optional[int] = None):
        if self._f is None:
            return
        rec = {"_time": round(time.time() - self._t0, 3)}
        if step is not None:
            rec["step"] = int(step)
        rec.update({k: _scalar(v) for k, v in metrics.items()})
        self._write(rec)
        if self.wandb_run is not None:
            self.wandb_run.log(metrics, step=step)

    def _write(self, rec):
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()

    def close(self):
        if self._f is None:
            return
        self._f.close()
        if self.wandb_run is not None:
            self.wandb_run.finish()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _scalar(v):
    try:
        return float(v)
    except (TypeError, ValueError):
        return str(v)


def _jsonable(d):
    return json.loads(json.dumps(d, default=str))
