"""Device resolution, kernel launch counters and program spans.

Entry points (``build_model``, ``ServedModel``) run on the CUDA card unless
the caller asks for the CPU with ``device="cpu"``; without a card and
without that request they raise instead of quietly running on the CPU.

Every kernel wrapper adds one to its counter here each time it launches its
CUDA kernel, and nowhere else, so a run can show that its main path went
through the kernels (``chip_smoke.py`` resets the counters, serves, reads
them).  The plain versions the wrappers take for CPU tensors count nothing.

``full_f32()`` pins f32 convs and matmuls to full f32 (no TF32) for the
duration of a call, whatever the process flags say.

``kernel_ops()`` says whether the kernel wrappers call their custom ops
(``ops/library.py``) rather than launch directly: only while
``torch.export`` traces.

Program spans: ``span(name)`` marks a stretch of the host's work (a
train step, an ODE solve, a served request's copy in).  Nothing is kept
unless a ``record_spans()`` block is open: outside one, ``span`` returns
one shared no-op context, so an unrecorded span costs a flag check.  A
recorded span keeps its name, its start and end on
``time.perf_counter_ns``'s clock, its parent (the innermost span open on
the same thread), its thread, its unit (one id that every span of a train
step or a served request shares: the id of the ``unit=True`` span that
opened it) and at most two small attributes.  ``Recording.wall`` maps
a span's times onto the wall clock, whose epoch ``torch.profiler``'s
``trace_start_ns()`` shares, so spans line up with a profiler trace
(``training/profiling.py`` writes them into its ``trace.json``).
``spanned(name)`` runs each call of a function inside its span.
``phase(name)`` is a span that is also a ``record_function`` range on
every profiler trace: the train steps' ``nodems.*`` phases, whose ranges
the benchmark reads for device time by phase.

``check_forward_only`` guards the wrapper of the forward-only kernel B2:
its outputs are fresh tensors with no ``grad_fn``, so where a gradient
could flow it raises instead of silently cutting it off.
"""
from __future__ import annotations

import contextlib
import functools
import itertools
import threading
import time
from collections import Counter
from typing import Any, Dict, Iterator, List, Optional, Union

import torch
from torch.profiler import record_function

__all__ = [
    "resolve_device",
    "full_f32",
    "kernel_ops",
    "check_forward_only",
    "count_launch",
    "launch_counts",
    "reset_launch_counts",
    "Span",
    "Recording",
    "span",
    "phase",
    "spanned",
    "record_spans",
]

_LAUNCHES: Counter = Counter()


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` means the CUDA card; raise when there is none.

    An explicit ``"cpu"`` is honoured; an explicit CUDA device without a
    card raises as well.
    """
    if device is None:
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions on the CPU"
        )
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device}")
    return device


@contextlib.contextmanager
def full_f32() -> Iterator[None]:
    """Turn TF32 off for cuDNN convs and cuBLAS matmuls, and restore the
    caller's flags on exit.  PyTorch's default lets cuDNN run f32 convs in
    TF32 (10-bit mantissa), which the JAX reference does not."""
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = cudnn.allow_tf32, matmul.allow_tf32
    cudnn.allow_tf32 = matmul.allow_tf32 = False
    try:
        yield
    finally:
        cudnn.allow_tf32, matmul.allow_tf32 = saved


def kernel_ops() -> bool:
    """Whether the wrappers of B1, B2, B3 and GeLUpoly go through their
    ``torch.library`` ops (``ops/library.py``): while ``torch.export``
    traces, which cannot trace a ctypes launch.  Eager calls launch
    directly and skip the op's dispatch (PERF.md §6); both routes run the
    same launch code."""
    return torch.compiler.is_exporting()


def check_forward_only(what: str, **tensors: torch.Tensor) -> None:
    """Raise when grad mode is on and any of ``tensors`` requires grad: the
    kernel ``what`` has no backward and its output would be detached."""
    needs = [k for k, t in tensors.items() if t.requires_grad]
    if torch.is_grad_enabled() and needs:
        raise RuntimeError(
            f"{what} is a forward-only kernel, but {', '.join(needs)} "
            "requires grad: its output would be cut off from autograd. "
            "Run it under torch.no_grad() or take the differentiable path")


def count_launch(name: str) -> None:
    """Record one launch of kernel ``name`` (called by its wrapper only)."""
    _LAUNCHES[name] += 1


def launch_counts() -> Dict[str, int]:
    """A copy of the launch counters, by kernel name."""
    return dict(_LAUNCHES)


def reset_launch_counts() -> None:
    _LAUNCHES.clear()


class Recording(list):
    """The spans a ``record_spans`` block saw finish, in the order they
    ended, and one (perf, wall) clock pair read as it opened."""

    def __init__(self) -> None:
        super().__init__()
        self.perf_ns = time.perf_counter_ns()
        self.wall_ns = time.time_ns()

    def wall(self, perf_ns: int) -> int:
        """``perf_ns`` (a span's time) on the wall clock, in ns."""
        return self.wall_ns + perf_ns - self.perf_ns


_RECORDINGS: List[Recording] = []
_NOOP = contextlib.nullcontext()
_IDS = itertools.count(1)
_OPEN = threading.local()
_unit: Optional[int] = None  # the id of the unit span open in the process


class Span:
    """One span: the context ``span`` returns while spans are recorded,
    and once it has ended, the record a ``Recording`` keeps.  Times are ns
    on ``time.perf_counter_ns``'s clock; ``parent`` is the id of the span
    open on the same thread when it opened, ``thread`` the thread's native
    id, ``unit`` the id of its unit's span (see the module's docstring)."""

    __slots__ = ("name", "start_ns", "end_ns", "id", "parent", "thread",
                 "unit", "attrs", "_new_unit", "_outer_unit")

    def __init__(self, name: str, new_unit: bool, attrs: Dict[str, Any]):
        self.name, self._new_unit, self.attrs = name, new_unit, attrs

    def __enter__(self) -> "Span":
        global _unit
        stack = getattr(_OPEN, "stack", None)
        if stack is None:
            # the native id once a thread: a system call, slow in a VM
            stack = _OPEN.stack = []
            _OPEN.thread = threading.get_native_id()
        self.thread = _OPEN.thread
        self.id = next(_IDS)
        self.parent = stack[-1].id if stack else None
        if self._new_unit:
            self._outer_unit, _unit = _unit, self.id
            self.unit = self.id
        else:
            self.unit = stack[-1].unit if stack else _unit
        stack.append(self)
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> None:
        global _unit
        self.end_ns = time.perf_counter_ns()
        stack = getattr(_OPEN, "stack", None)
        if stack and stack[-1] is self:
            stack.pop()
        if self._new_unit:
            _unit = self._outer_unit
        for rec in _RECORDINGS:
            rec.append(self)

    def __repr__(self) -> str:
        return (f"Span({self.name!r}, id={self.id}, parent={self.parent}, "
                f"unit={self.unit}, {self.end_ns - self.start_ns} ns, "
                f"{self.attrs})")


def span(name: str, *, unit: bool = False, **attrs: Any):
    """A context that records the span ``name`` while a ``record_spans``
    block is open, else the shared no-op.  ``unit=True`` opens a new unit
    (a train step, a served request); ``attrs`` are at most two small
    values (``path="b2"``, ``bytes=...``)."""
    if not _RECORDINGS:
        return _NOOP
    return Span(name, unit, attrs)


def spanned(name: str, *, unit: bool = False):
    """Decorate a function so that each call runs inside ``span(name,
    unit=unit)``."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with span(name, unit=unit):
                return fn(*args, **kwargs)
        return call
    return wrap


@contextlib.contextmanager
def phase(name: str) -> Iterator[None]:
    """A step phase: the span ``name`` and, on every profiler trace, the
    ``record_function`` range ``name`` inside it."""
    with span(name), record_function(name):
        yield


@contextlib.contextmanager
def record_spans() -> Iterator[Recording]:
    """Keep every span that ends inside the block; yields the
    ``Recording`` they go to.  Blocks may nest: each keeps its own."""
    rec = Recording()
    _RECORDINGS.append(rec)
    try:
        yield rec
    finally:
        # by identity: two recordings of equal spans compare equal
        del _RECORDINGS[next(i for i, r in enumerate(_RECORDINGS)
                             if r is rec)]
