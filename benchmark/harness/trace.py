"""Reduce a profiler trace of a cell's traced window to what the per-layer
metrics read.

A ``Recorded`` trace holds plain lists, so the arithmetic runs the same on
a hand-made event list as on ``torch.profiler``'s:

  window    (t0, t1), the traced window on the trace's clock (us)
  device    (name, start, end) of every device operation (kernels,
            copies, fills)
  ranges    (name, start, end) of the program's ``nodems.*`` ranges on
            the host
  launches  (host start, device us) of every host op that launched device
            work: the op's kernels belong to the range open at its start,
            whichever thread ran it (autograd runs the backward on its own)
  host      (name, start, end) of the host's ops on the window's thread

Busy time is the union of the device intervals inside the window, never
their sum, so work that overlaps counts once.
"""
from __future__ import annotations

import bisect
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

Span = Tuple[str, float, float]


@dataclass
class Recorded:
    window: Tuple[float, float]
    device: List[Span] = field(default_factory=list)
    ranges: List[Span] = field(default_factory=list)
    launches: List[Tuple[float, float]] = field(default_factory=list)
    host: List[Span] = field(default_factory=list)


def merged(spans: List[Span], window: Tuple[float, float]
           ) -> List[Tuple[float, float]]:
    """The union of the spans clipped to the window, as disjoint sorted
    intervals."""
    lo, hi = window
    ivs = sorted((max(s, lo), min(e, hi)) for _, s, e in spans
                 if e > lo and s < hi)
    out: List[List[float]] = []
    for s, e in ivs:
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def busy_us(rec: Recorded) -> float:
    return sum(e - s for s, e in merged(rec.device, rec.window))


def idle_gaps(rec: Recorded, top: int = 10) -> List[Tuple[str, float]]:
    """The longest stretches of the window with no device operation
    running, each named by the innermost host op running at its start
    ("idle" where none is), in seconds, longest first."""
    lo, hi = rec.window
    busy = merged(rec.device, rec.window)
    edges = [lo] + [x for iv in busy for x in iv] + [hi]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    host = sorted(rec.host, key=lambda h: h[1])
    starts = [h[1] for h in host]

    def name_at(t: float) -> str:
        best: Optional[Span] = None
        for h in host[:bisect.bisect_right(starts, t)]:
            if h[2] > t and (best is None or h[1] >= best[1]):
                best = h
        return best[0] if best else "idle"

    gaps.sort(key=lambda g: g[0] - g[1])
    return [(name_at(s), (e - s) / 1e6) for s, e in gaps[:top]]


def by_range(rec: Recorded) -> Dict[str, float]:
    """Device us by the program range open when the launching host op
    started ("outside" for none)."""
    ranges = sorted(rec.ranges, key=lambda r: r[1])
    starts = [r[1] for r in ranges]
    out: Dict[str, float] = {}
    for t, us in rec.launches:
        name = "outside"
        for r in reversed(ranges[:bisect.bisect_right(starts, t)]):
            if r[1] <= t < r[2]:
                name = r[0]
                break
        out[name] = out.get(name, 0.0) + us
    return out


def by_name(rec: Recorded) -> Dict[str, float]:
    """Device us by operation name, inside the window."""
    lo, hi = rec.window
    out: Dict[str, float] = {}
    for name, s, e in rec.device:
        if e > lo and s < hi:
            out[name] = out.get(name, 0.0) + (min(e, hi) - max(s, lo))
    return out


def count_in_window(rec: Recorded) -> int:
    lo, hi = rec.window
    return sum(1 for _, s, e in rec.device if e > lo and s < hi)


def from_profiler(prof, window_name: str) -> Recorded:
    """A ``Recorded`` from a finished ``torch.profiler.profile`` whose
    window is the host range ``window_name``; a trace of the device alone
    (no host range recorded) takes the span of its device operations."""
    from torch.autograd import DeviceType

    events = prof.events()
    win = next((e for e in events if e.name == window_name
                and e.device_type == DeviceType.CPU), None)
    rec = Recorded((0.0, 0.0))
    own = ("nodems.", "nodebench.")
    for e in events:
        tr = e.time_range
        if e.device_type == DeviceType.CUDA:
            if not e.name.startswith(own):
                rec.device.append((e.name, tr.start, tr.end))
            continue
        if e.name.startswith("nodems."):
            rec.ranges.append((e.name, tr.start, tr.end))
        if e.kernels:
            rec.launches.append((tr.start, sum(k.duration
                                               for k in e.kernels)))
        if (win is None or e.thread == win.thread) \
                and not e.name.startswith(own):
            rec.host.append((e.name, tr.start, tr.end))
    if win is not None:
        rec.window = (win.time_range.start, win.time_range.end)
    elif rec.device:
        rec.window = (min(d[1] for d in rec.device),
                      max(d[2] for d in rec.device))
    return rec
