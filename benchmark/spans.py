#!/usr/bin/env python3
"""Name a cell's idle device time by the port's program spans, and read the
spans' host time a unit, on one CUDA card.

    python3 benchmark/spans.py --workload <cell> --seed <n> [--pairs 5]
                               [--units N]

After the cell's set-up (``run.py``'s), it runs ``trace_units`` units with
the device alone traced and the program's spans recorded
(``backend.record_spans``), then ``--pairs`` times in turn ``--units``
units (``trace_units`` if not given) untraced and as many with spans
recorded and no profiler.  The last line
of standard output is one JSON object:

  traced     the traced units' wall and busy seconds, idle ms a unit, that
             idle split by the innermost span open at each gap's start
             (``idle_by_span``, "outside" for none) and over each part of
             a gap (``idle_over_gap``), the ten longest gaps named by the
             host op running at their start, else the span, else "idle",
             each with the unit it falls in and the ms into it, the gaps no
             span covers by where they fall, and the share of the launch
             calls inside a unit span; Python's garbage collections in the
             window count as spans ``python.gc``
  untraced   each window's wall seconds untraced (``plain_wall_s``) and
             with spans on (``spans_wall_s``), in pairs whose order
             alternates, the seconds Python's collections took in each
             (``*_gc_s``), the spans' on-cost (the median of the latter
             over the median of the former, less 1; the same of the
             windows' seconds less their collections'; the median of each
             pair's ratio, less 1), and every span name's host ms and
             count a unit
  span_ns    one span's host ns off and on, timed alone on this host, and
             what that predicts for the on-cost of a unit

It exits with 2 without a CUDA card.  Nothing here is read by ``run.py``.
"""
import argparse
import gc
import json
import os
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOP = 10


def _span_ns(windows: int = 500, n: int = 200) -> dict:
    """One span's enter and exit on this host, off and recorded, in ns:
    ``windows`` recordings of ``n`` spans each, about what a window of
    units records; ``on_no_gc`` with Python's collector off, which leaves
    out the collections that so many spans set off on the process's
    heap; ``clock_read`` one ``time.perf_counter_ns()``, of which a
    recorded span takes two."""
    from neural_ode_metasolver_tpu_torch import backend

    def each(record: bool) -> float:
        took = 0
        for _ in range(windows):
            with backend.record_spans() if record else backend._NOOP:
                t0 = time.perf_counter_ns()
                for _ in range(n):
                    with backend.span("ode.solve", path="rk", steps=8):
                        pass
                took += time.perf_counter_ns() - t0
        return took / (windows * n)

    out = {"off": each(False), "on": each(True)}
    gc.disable()
    try:
        out["on_no_gc"] = each(True)
    finally:
        gc.enable()
    t0 = time.perf_counter_ns()
    for _ in range(windows * n):
        time.perf_counter_ns()
    out["clock_read"] = (time.perf_counter_ns() - t0) / (windows * n)
    return out


class _Collections:
    """Python's garbage collections while it is open, as (start, end)
    perf-clock ns pairs (``gc.callbacks``)."""

    def __enter__(self) -> list:
        self.pauses = []
        gc.callbacks.append(self._note)
        return self.pauses

    def __exit__(self, *exc) -> None:
        gc.callbacks.remove(self._note)

    def _note(self, phase, info) -> None:
        if phase == "start":
            self.pauses.append([time.perf_counter_ns(), None])
        elif self.pauses:
            self.pauses[-1][1] = time.perf_counter_ns()


def _gc_s(pauses: list, t0: int, t1: int) -> float:
    """Seconds of the collections between perf-clock ns ``t0`` and
    ``t1``."""
    return sum(b - a for a, b in pauses
               if b is not None and t0 <= a < t1) / 1e9


def _traced(driver, run, n: int, device):
    """``n`` units with the device alone traced and spans recorded: the
    trace, the spans on its timeline (with Python's garbage collections
    as spans ``python.gc``) and the units' wall seconds."""
    from torch.profiler import ProfilerActivity, profile, record_function

    import run as runner
    from benchmark.harness import spans, trace
    from neural_ode_metasolver_tpu_torch import backend

    acts = [ProfilerActivity.CUDA if device.type == "cuda"
            else ProfilerActivity.CPU]
    with _Collections() as pauses:
        with backend.record_spans() as rec:
            with profile(activities=acts) as prof:
                with record_function(runner.WINDOW):
                    wall = runner._plain(driver, run, n, device)
    start = prof.profiler.kineto_results.trace_start_ns()
    placed = spans.on_timeline(rec, start) + [
        ("python.gc", (rec.wall(a) - start) / 1e3,
         (rec.wall(b) - start) / 1e3, None, None, None)
        for a, b in pauses if b is not None]
    return trace.from_profiler(prof, runner.WINDOW), placed, wall


def _windows(driver, run, n: int, device, pairs: int) -> dict:
    """``pairs`` pairs of ``n`` units untraced, spans off and on, the
    first of a pair off in even pairs and on in odd ones, so that
    collections that fall every other window hit both sides: each
    window's wall seconds and the seconds Python's collections took in
    it, and the spans the windows with spans on recorded."""
    import run as runner
    from neural_ode_metasolver_tpu_torch import backend

    out = {"plain_wall_s": [], "spans_wall_s": [], "plain_gc_s": [],
           "spans_gc_s": []}
    kept = []

    def window(record: bool) -> None:
        side = "spans" if record else "plain"
        t0 = time.perf_counter_ns()
        with backend.record_spans() if record else backend._NOOP as rec:
            out[side + "_wall_s"].append(
                runner._plain(driver, run, n, device))
        kept.extend(rec or [])
        out[side + "_gc_s"].append(_gc_s(pauses, t0,
                                         time.perf_counter_ns()))

    with _Collections() as pauses:
        for i in range(pairs):
            for record in ((False, True) if i % 2 == 0 else (True, False)):
                window(record)
    return out, kept


def _per_unit(us: dict, n: int) -> dict:
    """us summed over ``n`` units as ms a unit, largest first."""
    return {k: v / 1e3 / n for k, v in sorted(us.items(),
                                                key=lambda kv: -kv[1])}


def measure(cell, driver, run, device, pairs: int,
            units: int = 0) -> dict:
    from benchmark.harness import spans, trace

    n = int(cell.traffic["trace_units"])
    rec, placed, wall = _traced(driver, run, n, device)
    busy = trace.busy_us(rec)
    idle = rec.window[1] - rec.window[0] - busy
    by_span = spans.idle_by_span(rec, placed)
    calls, share = spans.launches_in_units(rec, placed)
    m = units or n
    win, kept = _windows(driver, run, m, device, pairs)
    plain, spans_wall = win["plain_wall_s"], win["spans_wall_s"]
    net = [[w - g for w, g in zip(win[f"{side}_wall_s"],
                                  win[f"{side}_gc_s"])]
           for side in ("plain", "spans")]
    each = _span_ns()
    host = spans.host_ms(kept, m * pairs)
    per_unit = sum(v["count"] for v in host.values())
    unit_s = statistics.median(plain) / m
    return {
        "units": n, "window_units": m,
        "traced": {
            "wall_s": wall, "busy_s": busy / 1e6,
            "idle_ms": idle / 1e3 / n,
            "idle_by_span": _per_unit(by_span, n),
            "idle_by_span_sum_ms": sum(by_span.values()) / 1e3 / n,
            "idle_over_gap": _per_unit(spans.idle_by_span(
                rec, placed, over_gap=True), n),
            "idle_gaps": [[name, s, None if at is None else
                           [at[0], at[1] / 1e3]] for name, s, at in
                          spans.named_gaps(rec, placed, TOP)],
            "unnamed_gaps": {k: {"count": len(v), "ms": sum(v) / 1e3,
                                 "longest_ms": max(v) / 1e3}
                             for k, v in spans.unnamed_gaps(
                                 rec, placed).items()},
            "launch_calls": calls, "launches_in_spans": share},
        "untraced": dict(
            win, on_cost=statistics.median(spans_wall)
            / statistics.median(plain) - 1.0,
            on_cost_net_of_gc=statistics.median(net[1])
            / statistics.median(net[0]) - 1.0,
            on_cost_paired=statistics.median(
                b / a for a, b in zip(plain, spans_wall)) - 1.0,
            host_ms=host),
        "span_ns": dict(each, per_unit=per_unit,
                        on_cost=each["on"] * 1e-9 * per_unit / unit_s),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--pairs", type=int, default=5)
    ap.add_argument("--units", type=int, default=0)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import run as runner

    runner._cache_env()
    import torch

    from benchmark.harness import cell as cellmod
    from benchmark.harness import runs

    cell = cellmod.resolve(args.workload, ROOT)
    if not torch.cuda.is_available():
        print(f"{args.workload} needs a CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    driver = cell.driver()
    run = driver.setup(cell, args.seed, device)
    runs.sync(device)
    out = {"workload": args.workload, "seed": args.seed,
           "device": runs.device_info(device),
           "power_limit": runs.power_limit(),
           **measure(cell, driver, run, device, args.pairs, args.units)}
    print(json.dumps(out, allow_nan=False), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
