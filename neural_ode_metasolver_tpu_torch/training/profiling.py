"""Profiling on ``torch.profiler`` (port of training/profiling.py).

``trace(log_dir)`` records the enclosed block, host and CUDA activities
(host only where no card is present), and writes a Chrome trace
(``trace.json``, loadable in Perfetto or chrome://tracing) into
``log_dir``, also when the block raises; ``start_trace`` and
``stop_trace`` do the same around a window that is not a block (the
runners' steps 1-3).  ``annotate(name)`` is a named range on the trace, as
the step's ``nodems.*`` ranges (``training/train.py``) are.
"""
from __future__ import annotations

import contextlib
import os
from typing import Optional, Tuple

import torch
from torch.profiler import ProfilerActivity, profile, record_function

__all__ = ["trace", "annotate", "start_trace", "stop_trace"]

_active: Optional[Tuple[profile, str]] = None


def start_trace(log_dir: str) -> None:
    global _active
    if _active is not None:
        raise RuntimeError("a trace is already running")
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    _active = (prof, log_dir)


def stop_trace() -> str:
    """Stop the running trace and write it; returns the file's path."""
    global _active
    if _active is None:
        raise RuntimeError("no trace is running")
    prof, log_dir = _active
    _active = None
    prof.stop()
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, "trace.json")
    prof.export_chrome_trace(path)
    return path


@contextlib.contextmanager
def trace(log_dir: str):
    """Usage::

        with trace("/tmp/profile"):
            ts, m = step(ts, x, y, generator)
            torch.cuda.synchronize()
    """
    start_trace(log_dir)
    try:
        yield
    finally:
        stop_trace()


def annotate(name: str):
    """Named region that shows up on the trace timeline."""
    return record_function(name)
