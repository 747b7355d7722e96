#!/usr/bin/env python3
"""Where a served request's time goes in the PyTorch port, on the card.

    python3 scripts/profile_torch_serving.py [--model M] [--exported]
                                              [--trace-dir DIR] [batch ...]

Serves ``--model premetanode10`` (the default: in_planes 64, bf16) or
``--model mnist`` (the MNIST MetaNODE, dim 64, f32), random weights from
seed 0, 8-step RK2 u=0.5, as a live ``ServedModel``, or with
``--exported`` through ``serving.export_model`` and ``load_model`` (the
artifact written to a temporary directory).  For each batch size (default 1 and 256), after
a warm-up, it times 20 requests without the profiler (host clock, median),
then traces 3 requests with ``torch.profiler`` (CPU and CUDA activities).
Prints per traced request: the host-clock time, the device time summed
over kernels, the device busy share (their ratio; 1 minus it is the idle
share), the number of device operations (kernels and copies), device
time by kind (the port's kernels, cuDNN's convs, copies, other PyTorch
kernels) and by kernel name (the 16 largest).  With ``--trace-dir`` it also writes each chrome
trace there.  Imports no JAX; needs a CUDA device.
"""
import argparse
import json
import os
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

N_REQUESTS = 3  # traced
N_TIMED = 20  # untraced
N_TOP = 16  # kernels listed by name


def kind(name):
    """The kind of a device operation, by its kernel name."""
    if "nodems::" in name:
        return "port kernels"
    if name.startswith(("Memcpy", "Memset")):
        return "copies"
    if any(k in name for k in ("cudnn", "xmma", "implicit_gemm", "conv")):
        return "cuDNN convs"
    return "other PyTorch kernels"


# name -> (build_model keyword arguments, compute dtype name, image shape)
MODELS = {
    "premetanode10": ({"in_planes": 64}, "bfloat16", (32, 32, 3)),
    "mnist": ({"dim": 64}, "float32", (28, 28, 1)),
}


def main(model_name, batches, trace_dir=None, exported=False):
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    from neural_ode_metasolver_tpu_torch.models import build_model
    from neural_ode_metasolver_tpu_torch.ops import parse_solver_dsl
    from neural_ode_metasolver_tpu_torch.serving import (
        ServedModel,
        export_model,
        load_model,
    )

    kwargs, dtype, shape = MODELS[model_name]
    model = build_model(model_name, generator=torch.Generator().manual_seed(0),
                        **kwargs)
    solvers = parse_solver_dsl("rk2,u,8,-1,0.5,-1")
    served = ServedModel(model, solvers, compute_dtype=getattr(torch, dtype))
    if exported:
        with tempfile.TemporaryDirectory() as art:
            export_model(art, model, solvers, input_shape=(1,) + shape,
                         compute_dtype=getattr(torch, dtype))
            served = load_model(art)
    rows = []
    for batch in batches:
        x = torch.rand(batch, *shape,
                       generator=torch.Generator().manual_seed(1))
        served(x)  # warm-up: kernels built and loaded, cuDNN plans made
        torch.cuda.synchronize()
        untraced = []
        for _ in range(N_TIMED):
            t0 = time.perf_counter()
            served(x)
            torch.cuda.synchronize()
            untraced.append((time.perf_counter() - t0) * 1e3)
        untraced_ms = sorted(untraced)[N_TIMED // 2]
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(N_REQUESTS):
                served(x)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3 / N_REQUESTS
        by_name = {}  # kernels only: a CPU op's device time repeats them
        n_device_ops = 0
        for e in prof.key_averages():
            if e.device_type == DeviceType.CUDA:
                by_name[e.key] = by_name.get(e.key, 0.0) + e.self_device_time_total
                n_device_ops += e.count
        device_ms = sum(by_name.values()) / 1e3 / N_REQUESTS
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:N_TOP]
        by_kind = {}
        for k, v in by_name.items():
            by_kind[kind(k)] = by_kind.get(kind(k), 0.0) + v / 1e3 / N_REQUESTS
        row = {
            "batch": batch, "untraced_median_ms": untraced_ms,
            "wall_ms_per_request": wall_ms,
            "device_ms_per_request": device_ms,
            "device_busy_share": device_ms / wall_ms if wall_ms else None,
            "device_ops_per_request": n_device_ops / N_REQUESTS,
            "device_ms_by_kind": by_kind,
            "device_ms_by_kernel": {k: v / 1e3 / N_REQUESTS for k, v in top},
        }
        rows.append(row)
        if trace_dir is not None:
            os.makedirs(trace_dir, exist_ok=True)
            prof.export_chrome_trace(
                os.path.join(trace_dir,
                             f"torch_serving_{model_name}"
                             f"{'_exported' if exported else ''}_b{batch}"
                             ".trace.json"))
        print(f"batch {batch}: untraced median {untraced_ms:.3f} ms over "
              f"{N_TIMED} requests; traced {wall_ms:.3f} ms per request "
              f"(host clock), "
              f"{device_ms:.3f} ms of kernels, busy share "
              f"{row['device_busy_share']:.3f}, "
              f"{row['device_ops_per_request']:g} device ops", flush=True)
        for k, v in sorted(by_kind.items(), key=lambda kv: -kv[1]):
            print(f"  {v:9.3f} ms  ({k})")
        for k, v in row["device_ms_by_kernel"].items():
            print(f"  {v:9.3f} ms  {k[:100]}")
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "model": model_name, "dtype": dtype,
                      "exported": exported, "rows": rows}))


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", choices=sorted(MODELS), default="premetanode10")
    ap.add_argument("--exported", action="store_true")
    ap.add_argument("--trace-dir", default=None)
    ap.add_argument("batches", nargs="*", type=int, default=[1, 256])
    args = ap.parse_args()
    main(args.model, args.batches, args.trace_dir, args.exported)
