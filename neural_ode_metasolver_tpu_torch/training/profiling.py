"""Profiling on ``torch.profiler`` (port of training/profiling.py).

``trace(log_dir)`` records the enclosed block, host and CUDA activities
(host only where no card is present), and writes a Chrome trace
(``trace.json``, loadable in Perfetto or chrome://tracing) into
``log_dir``, also when the block raises; ``start_trace`` and
``stop_trace`` do the same around a window that is not a block (the
runners' steps 1-3).  The window also records the program's spans
(``backend.span``: ``train.step``, ``nodems.*``, ``ode.solve``,
``data.wait``, ``checkpoint.save``, ...), which ``stop_trace`` writes into
the same file on the profiler's timeline, one row a thread beside the
profiler's (``on_profiler`` maps their clock).  ``annotate(name)`` is such
a span.
"""
from __future__ import annotations

import contextlib
import json
import os
import threading
from typing import List, Optional, Tuple

import torch
from torch.profiler import ProfilerActivity, profile

from ..backend import Recording, Span, record_spans, span

__all__ = ["trace", "annotate", "start_trace", "stop_trace",
           "on_profiler"]

# a span row's tid: the thread's native id above the range a Linux tid
# takes (at most 2**22), so it never shares a row with the profiler's ops
SPAN_ROW = 1 << 24

_active: Optional[Tuple[profile, str, contextlib.ExitStack, Recording]] = None


def start_trace(log_dir: str) -> None:
    global _active
    if _active is not None:
        raise RuntimeError("a trace is already running")
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    spans = contextlib.ExitStack()
    rec = spans.enter_context(record_spans())
    prof.start()
    _active = (prof, log_dir, spans, rec)


def stop_trace() -> str:
    """Stop the running trace and write it, the window's spans included;
    returns the file's path."""
    global _active
    if _active is None:
        raise RuntimeError("no trace is running")
    prof, log_dir, spans, rec = _active
    _active = None
    try:
        prof.stop()
    finally:
        spans.close()
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        chrome = json.load(f)
    # the export's ts: wall-clock us counted from baseTimeNanoseconds
    base_ns = int(chrome.get("baseTimeNanoseconds", 0))
    chrome["traceEvents"].extend(_chrome_events(rec, base_ns))
    with open(path, "w") as f:
        json.dump(chrome, f)
    return path


def on_profiler(rec: Recording, trace_start_ns: int
                ) -> List[Tuple[Span, float, float]]:
    """Each span of ``rec`` with its start and end in us on a profiler's
    timeline, whose zero is ``trace_start_ns`` (a wall-clock ns reading:
    ``prof.profiler.kineto_results.trace_start_ns()``, from which the
    ``time_range`` of ``prof.events()`` counts)."""
    return [(s, (rec.wall(s.start_ns) - trace_start_ns) / 1e3,
             (rec.wall(s.end_ns) - trace_start_ns) / 1e3) for s in rec]


def _chrome_events(rec: Recording, base_ns: int) -> list:
    pid = os.getpid()
    out, rows = [], set()
    for s, t0, t1 in on_profiler(rec, base_ns):
        rows.add(s.thread)
        out.append({"ph": "X", "cat": "span", "name": s.name, "pid": pid,
                    "tid": SPAN_ROW + s.thread, "ts": t0, "dur": t1 - t0,
                    "args": {"id": s.id, "parent": s.parent,
                             "unit": s.unit, **s.attrs}})
    main = threading.main_thread().native_id
    for tid in rows:
        who = "main" if tid == main else str(tid)
        out.append({"ph": "M", "name": "thread_name", "pid": pid,
                    "tid": SPAN_ROW + tid,
                    "args": {"name": f"program spans, thread {who}"}})
    return out


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


def annotate(name: str, **attrs):
    """The span ``name`` (``backend.span``): a named region on the trace
    timeline, recorded wherever spans are."""
    return span(name, **attrs)
