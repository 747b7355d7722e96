"""The port's program spans (``backend.span``) read beside a device trace
of a cell's units: what the host was doing while the device sat idle, and
the host's own time a unit by span.

A span on the trace's timeline is ``(name, start, end, id, parent,
unit)``, in us from the profiler's zero, placed by the recording's clock
pair and the trace's ``trace_start_ns`` (``on_timeline``).  Over a
``trace.Recorded`` of the device alone (its host events are the CUDA
runtime's calls):

  named_gaps        the longest idle gaps, each named by the host op
                    running at its start, else by the innermost span open
                    then, else "idle", with the unit it falls in
  idle_by_span      all the idle time, split by the innermost span open at
                    each gap's start ("outside" where none is), or with
                    ``over_gap`` by the innermost span open over each part
                    of a gap; either adds up to the window's idle time
  unnamed_gaps      the gaps that no span covers, by where they fall
                    against the units
  launches_in_units the share of the kernel-launch calls
                    (``cudaLaunchKernel*``) that start inside a unit span

and over the spans of an untraced window, ``host_ms``: each span name's
host ms a unit, whole and self (less its child spans).  A unit is a
``train.step`` or a ``serve.request``.
"""
from __future__ import annotations

import bisect
from typing import Dict, List, Optional, Sequence, Tuple

from benchmark.harness import trace

Placed = Tuple[str, float, float, int, Optional[int], Optional[int]]
UNITS = ("train.step", "serve.request")
LAUNCH = "cudaLaunchKernel"


def on_timeline(rec, trace_start_ns: int) -> List[Placed]:
    """The spans of a ``backend.Recording`` on a profiler's timeline."""
    from neural_ode_metasolver_tpu_torch.training.profiling import \
        on_profiler

    return [(s.name, t0, t1, s.id, s.parent, s.unit)
            for s, t0, t1 in on_profiler(rec, trace_start_ns)]


def gaps(rec: trace.Recorded) -> List[Tuple[float, float]]:
    """The stretches of the window with no device operation running."""
    lo, hi = rec.window
    edges = [lo] + [x for iv in trace.merged(rec.device, rec.window)
                    for x in iv] + [hi]
    return [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]


def _innermost(items: Sequence[Tuple[str, float, float]], t: float
               ) -> Optional[str]:
    """The name of the item open at ``t`` that opened last, or None."""
    best = None
    for it in items:
        if it[1] <= t < it[2] and (best is None or it[1] >= best[1]):
            best = it
    return best[0] if best else None


def unit_at(spans: Sequence[Placed], t: float
            ) -> Optional[Tuple[int, float]]:
    """The unit open at ``t`` as (its place among the units, from 0; us
    since it opened), or None."""
    units = sorted(s[1:3] for s in spans if s[0] in UNITS)
    for i, (a, b) in enumerate(units):
        if a <= t < b:
            return i, t - a
    return None


def named_gaps(rec: trace.Recorded, spans: Sequence[Placed], top: int = 10
               ) -> List[Tuple[str, float, Optional[Tuple[int, float]]]]:
    """The ``top`` longest idle gaps, longest first: each one's name (the
    host op running at its start, else the innermost span, else "idle"),
    its seconds and the unit it starts in (``unit_at``)."""
    host = sorted(rec.host, key=lambda h: h[1])
    starts = [h[1] for h in host]
    longest = sorted(gaps(rec), key=lambda g: g[0] - g[1])[:top]
    return [(_innermost(host[:bisect.bisect_right(starts, s)], s)
             or _innermost(spans, s) or "idle", (e - s) / 1e6,
             unit_at(spans, s)) for s, e in longest]


def idle_by_span(rec: trace.Recorded, spans: Sequence[Placed],
                 over_gap: bool = False) -> Dict[str, float]:
    """Idle us by the innermost span open at each gap's start, or with
    ``over_gap`` by the innermost span open over each part of a gap
    ("outside" for none)."""
    out: Dict[str, float] = {}
    for s, e in gaps(rec):
        cuts = [s, e]
        if over_gap:
            cuts = sorted({s, e} | {t for sp in spans for t in sp[1:3]
                                    if s < t < e})
        for a, b in zip(cuts, cuts[1:]):
            name = _innermost(spans, a) or "outside"
            out[name] = out.get(name, 0.0) + (b - a)
    return out


def unnamed_gaps(rec: trace.Recorded, spans: Sequence[Placed]
                 ) -> Dict[str, List[float]]:
    """The idle gaps no span covers, by where they fall: "before the
    units", "between units" or "after the units"; each a list of us."""
    units = sorted((s[1], s[2]) for s in spans if s[0] in UNITS)
    out: Dict[str, List[float]] = {}
    for s, e in gaps(rec):
        if _innermost(spans, s) is not None:
            continue
        where = ("before the units" if not units or s < units[0][0] else
                 "after the units" if s >= units[-1][1] else
                 "between units")
        out.setdefault(where, []).append(e - s)
    return out


def launches_in_units(rec: trace.Recorded, spans: Sequence[Placed]
                      ) -> Tuple[int, Optional[float]]:
    """The launch calls on the trace and the share of them that start
    inside a unit span (None where there are none)."""
    units = sorted((s[1], s[2]) for s in spans if s[0] in UNITS)
    starts = [u[0] for u in units]
    calls = [h[1] for h in rec.host if h[0].startswith(LAUNCH)]
    inside = 0
    for t in calls:
        i = bisect.bisect_right(starts, t) - 1
        inside += i >= 0 and t < units[i][1]
    return len(calls), (inside / len(calls) if calls else None)


def host_ms(rec, units: int) -> Dict[str, Dict[str, float]]:
    """Each span name's host ms a unit (its spans' summed length over the
    units), its self ms a unit (that length less what its child spans
    cover) and its spans a unit."""
    child_ns: Dict[int, int] = {}
    for s in rec:
        if s.parent is not None:
            child_ns[s.parent] = child_ns.get(s.parent, 0) \
                + s.end_ns - s.start_ns
    out: Dict[str, Dict[str, float]] = {}
    for s in rec:
        d = out.setdefault(s.name, {"ms": 0.0, "self_ms": 0.0,
                                    "count": 0.0})
        took = s.end_ns - s.start_ns
        d["ms"] += took / 1e6 / units
        d["self_ms"] += (took - child_ns.get(s.id, 0)) / 1e6 / units
        d["count"] += 1.0 / units
    return out
