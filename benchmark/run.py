#!/usr/bin/env python3
"""Run one cell of the port's benchmark once, on one CUDA card.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
                             --trace <0|1>

The cell is an entry of ``BENCHMARK.json`` at the checkout's root; its
configuration, traffic, limits, driver, metric readers and kernel classes
are files found by name (``benchmark/harness/cell.py``).  The run makes
its weights and inputs on the device from ``--seed``, warms up the cell's
own shapes (set-up, timed from the process's start as ``setup_s``), then:

  --trace 0  measures for ``--seconds`` with nothing traced and reports the
             cell's end-to-end metrics;
  --trace 1  traces ``trace_units`` units (steps or requests) with
             ``torch.profiler``, times as many untraced, and reports the
             cell's per-layer metrics, the device's busy and window
             seconds and a breakdown.

After the window it reads the peak device memory, frees the program's
state and decides ``correct`` against the plain reference
(``benchmark/harness/compare.py``), printing each number compared beside
its limit as the last lines of standard error and last in the result.
The last line of standard output is the result, one JSON object.

It exits with 2 and prints no result without a CUDA card (or with fewer
than the cell asks for), and with 3 when JAX or the JAX package was
loaded.  Build and kernel caches stay inside the checkout.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from types import SimpleNamespace  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, ".nodebench_cache")
WINDOW = "nodebench.window"
TOP = 10


def _cache_env() -> None:
    """Every cache a CUDA or PyTorch build may write, at fixed paths inside
    the checkout (the port's own kernels build into its ``_build_out``)."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("PYTORCH_KERNEL_CACHE_PATH", "torch_kernels"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = os.path.join(CACHE, sub)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def _forbidden() -> bool:
    """Whether JAX or the JAX package is loaded, named on standard error."""
    from benchmark.harness import runs

    bad = runs.loaded_forbidden()
    if bad:
        print(f"forbidden modules loaded: {', '.join(bad)}", file=sys.stderr)
    return bool(bad)


def _read(cell, metrics, ctx) -> dict:
    out = {}
    for m in metrics:
        v = cell.metric_reader(m["name"]).read(ctx)
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out


def _timed(cell, driver, run, seconds, setup_s) -> tuple:
    res = driver.window(run, seconds)
    ctx = SimpleNamespace(setup_s=setup_s, **res)
    return _read(cell, cell.end_to_end, ctx), res, {}


def _plain(driver, run, n: int, device) -> float:
    """The host's seconds of ``n`` units, from the first one's start to the
    last one's work done."""
    from benchmark.harness import runs

    runs.sync(device)
    t0 = time.perf_counter()
    for _ in range(n):
        driver.unit(run)
    runs.sync(device)
    return time.perf_counter() - t0


def _profiled(driver, run, n: int, device, activities):
    """``n`` units under the profiler: the trace and the host's seconds
    from the first unit's start to the last one's work done."""
    from torch.profiler import profile, record_function

    from benchmark.harness import runs, trace

    runs.sync(device)
    with profile(activities=activities) as prof:
        with record_function(WINDOW):
            wall = _plain(driver, run, n, device)
    return trace.from_profiler(prof, WINDOW), wall


def _traced(cell, driver, run, device) -> tuple:
    """Two traced windows of ``trace_units`` units each, then as many units
    untraced.  The first records the host's ops too, whose cost slows a
    host-heavy step: it gives only the device time by program range.  The
    second records the device alone and gives the window, the busy time,
    the kernels' times and the rest.  The third, timed by the host's clock,
    gives the units' wall time without the profiler's cost a launch."""
    from torch.profiler import ProfilerActivity

    from benchmark import reference
    from benchmark.harness import cell as cellmod
    from benchmark.harness import trace, work
    from neural_ode_metasolver_tpu_torch import backend

    n = int(cell.traffic["trace_units"])
    classes = cellmod.kernel_classes(cell.root)
    family = reference.load(cell.config["reference"])
    ops = work.step_ops(family, cell.config, cell.traffic)
    backend.reset_launch_counts()
    gpu = device.type == "cuda"
    host_rec, _ = _profiled(driver, run, n, device, [ProfilerActivity.CPU]
                            + ([ProfilerActivity.CUDA] if gpu else []))
    rec, wall = _profiled(driver, run, n, device, [ProfilerActivity.CUDA]
                          if gpu else [ProfilerActivity.CPU])
    plain = _plain(driver, run, n, device)
    counted = {k: v / (3 * n) for k, v in backend.launch_counts().items()}
    launches_ok = all(counted.get(k, 0) == v for k, v in
                      cell.launches.items())
    print(f"launches per unit: expected {json.dumps(cell.launches)} "
          f"counted {json.dumps(counted)}", file=sys.stderr)
    names = trace.by_name(rec)
    class_us, unclaimed = {}, 0.0
    for name, us in names.items():
        k = cellmod.classify(name, classes)
        if k is not None:
            class_us[k] = class_us.get(k, 0.0) + us
        elif not name.startswith(("Memcpy", "Memset")):
            unclaimed += us
    busy = trace.busy_us(rec) / 1e6
    ctx = SimpleNamespace(
        units=n, wall_s=wall, plain_wall_s=plain, busy_s=busy,
        device_ops=trace.count_in_window(rec) / n,
        class_ms={k: v / 1e3 / n for k, v in class_us.items()},
        least_ms=work.least_ms_by_class(ops, classes, cell),
        range_ms={k: v / 1e3 / n
                  for k, v in trace.by_range(host_rec).items()},
        elementwise_ms=unclaimed / 1e3 / n,
        flops_per_unit=work.model_flops(ops),
        peak_flops=work.PEAK_FLOPS[cell.config["peak"]],
        launches_ok=launches_ok)
    print("traced: " + json.dumps({
        "units": n, "wall_s": wall, "plain_wall_s": plain, "busy_s": busy,
        "host_traced_wall_s": (host_rec.window[1] - host_rec.window[0]) / 1e6,
        "class_ms": ctx.class_ms, "least_ms": ctx.least_ms,
        "range_ms": ctx.range_ms, "elementwise_ms": ctx.elementwise_ms,
        "kernel_classes": {name[:160]: cellmod.classify(name, classes)
                           for name in sorted(names, key=names.get,
                                              reverse=True)[:40]}}),
        file=sys.stderr)
    top = sorted(names.items(), key=lambda kv: -kv[1])[:TOP]
    breakdown = {"device_ops": [[k, v / 1e6] for k, v in top],
                 "idle_gaps": [list(g) for g in trace.idle_gaps(rec, TOP)]}
    res = {"units": n, "attempted": 3 * n, "failed": 0}
    return _read(cell, cell.per_layer, ctx), res, {
        "busy_s": busy, "window_s": wall, "breakdown": breakdown}


def run_cell(cell, seed: int, seconds: float, trace: bool, device,
             t0: float = T0):
    """One run of ``cell`` on ``device``: the result dict, or None when a
    forbidden module was loaded."""
    import torch

    from benchmark.harness import compare, runs

    driver = cell.driver()
    run = driver.setup(cell, seed, device)
    runs.sync(device)
    setup_s = time.perf_counter() - t0
    if trace:
        print(f"setup_s {setup_s}", file=sys.stderr)
        metrics, res, extra = _traced(cell, driver, run, device)
    else:
        metrics, res, extra = _timed(cell, driver, run, seconds, setup_s)
    dev = runs.device_info(device)
    if _forbidden():
        return None
    out = driver.release(run)
    del run
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    readings = driver.check(cell, out)
    print("readings: " + json.dumps(readings), file=sys.stderr)
    correct, checks = compare.judge(readings, cell.limits)
    if trace:
        dev.update(busy_s=extra["busy_s"], window_s=extra["window_s"])
    dev["power_limit"] = runs.power_limit() if device.type == "cuda" \
        else "not read"
    result = {"correct": bool(correct and res["failed"] == 0),
              "attempted": res["attempted"], "failed": res["failed"],
              "metrics": metrics, "device": dev}
    if trace:
        result["breakdown"] = extra["breakdown"]
    result["checks"] = checks
    return result


def _emit(result: dict) -> None:
    print(f"card: {result['device'].get('kind')}, power limit "
          f"{result['device'].get('power_limit')}", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result, allow_nan=False), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _cache_env()
    sys.path.insert(0, ROOT)
    from benchmark.harness import cell as cellmod

    cell = cellmod.resolve(args.workload, ROOT)
    import torch

    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s); "
              f"{have} available", file=sys.stderr)
        return 2
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                      torch.device("cuda", 0))
    if result is None or _forbidden():
        return 3
    _emit(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
