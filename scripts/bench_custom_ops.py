#!/usr/bin/env python3
"""What a ``torch.library`` op call costs the host, against a direct launch
of the same kernel, on the card.

    python3 scripts/bench_custom_ops.py [--out FILE]

Kernels B1, B2 and B3 are custom ops (``ops/library.py``) that the
wrappers call only while ``torch.export`` traces; eager calls launch
directly (``backend.kernel_ops``).  This script measures what routing
eager calls through the ops would cost:

  * per call, host microseconds of the direct launch code and of the op
    (``torch.ops.nodems.*``), at batch 1 where the host bounds a call:
    B1 at the MNIST ConcatConv2d (1, 6, 6, 65 -> 64) f32, B3 at (1, 6, 6,
    64) + relu f32, and B2's solve at (1, 16, 16, 128) bf16, 8 steps (33
    launches a call).  Each is the least of three rounds of 2,000 calls
    timed on the host clock without a sync (the issue time, with the
    device never the bound at these sizes), beside the same rounds ended
    by a sync;
  * the host-bound steps both ways in one process, with
    ``backend.kernel_ops`` patched to take the ops eagerly: the digits
    train step (``profile_torch_training.py --model mnist``: MNIST dim 64,
    PGD-7, smoothing, RMSprop, f32, batch 128), the single clean step
    (``--model mnist-clean``) and an MNIST served request at batch 1 and
    256 (dim 64, f32, RK2 u=0.5 8 steps), direct and through the ops
    alternating over five rounds (median ms of each round's timed steps
    or requests, then the median and the spread over rounds); the same
    MNIST model exported with ``serving.export_model`` and loaded with
    ``load_model`` in the same process serves in every round too.

Random weights from seed 0, seeded inputs.  Prints the card's name and
power limit, then one JSON line per row and the whole result as one JSON
line (also written to ``--out``).  Imports no JAX; needs a CUDA device.
"""
import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

CALLS = 2000  # calls a round of the per-call timing
ROUNDS = 5  # alternating rounds of the step and request timings
STEPS = 5  # timed train steps a round
REQUESTS = 20  # timed served requests a round


def per_call(torch, fn):
    """(host us a call, us a call with the sync): the least of three rounds
    of CALLS calls."""
    fn()
    torch.cuda.synchronize()
    host, synced = [], []
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(CALLS):
            fn()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        host.append((t1 - t0) / CALLS * 1e6)
        synced.append((t2 - t0) / CALLS * 1e6)
    return min(host), min(synced)


def main(out=None):
    import torch

    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    from neural_ode_metasolver_tpu_torch import backend
    from neural_ode_metasolver_tpu_torch.models import build_model
    from neural_ode_metasolver_tpu_torch.ops import (
        SolverOptions,
        conv3x3,
        group_norm,
        ode_block,
        parse_solver_dsl,
    )
    from neural_ode_metasolver_tpu_torch.serving import (
        ServedModel,
        export_model,
        load_model,
    )
    from neural_ode_metasolver_tpu_torch.training import (
        AttackConfig,
        NoiseConfig,
        create_train_state,
        make_optimizer,
        make_train_step,
    )

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(f"device: {torch.cuda.get_device_name(0)}; nvidia-smi: {smi}",
          flush=True)
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(0)
    result = {"device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
              "per_call": [], "paths": []}

    # ------------------------------------------------------- per call
    x1 = torch.randn(1, 6, 6, 65, generator=g).to(dev)
    w1 = (torch.randn(3, 3, 65, 64, generator=g) * 0.05).to(dev)
    xg = torch.randn(1, 6, 6, 64, generator=g).to(dev)
    sc = torch.randn(64, generator=g).to(dev)
    bi = torch.randn(64, generator=g).to(dev)
    y0 = torch.randn(1, 16, 16, 128, generator=g).to(dev, torch.bfloat16)
    wa = (torch.randn(3, 3, 128, 128, generator=g) * 0.02).to(
        dev, torch.bfloat16)
    wb = (torch.randn(3, 3, 128, 128, generator=g) * 0.02).to(
        dev, torch.bfloat16)
    rows = [
        ("conv3x3_same (1,6,6,65->64) f32", 1,
         lambda: conv3x3._launch_conv(x1, w1, conv3x3.KERNEL_NAME),
         lambda: torch.ops.nodems.conv3x3_same(x1, w1)),
        ("group_norm_act (1,6,6,64) relu f32", 1,
         lambda: group_norm._forward(xg, sc, bi, 32, 1e-5, "relu"),
         lambda: torch.ops.nodems.group_norm_act(xg, sc, bi, 32, 1e-5,
                                                 "relu")),
        ("ode_block_rk2 (1,16,16,128) bf16, 8 steps", 33,
         lambda: ode_block._solve(y0, wa, wb, 0.5, 8),
         lambda: torch.ops.nodems.ode_block_rk2(y0, wa, wb, 0.5, 8)),
    ]
    with torch.inference_mode():
        for name, launches, direct, op in rows:
            if not torch.equal(direct(), op()):
                sys.exit(f"{name}: the op and the direct launch differ")
            d_host, d_sync = per_call(torch, direct)
            o_host, o_sync = per_call(torch, op)
            row = {"kernel": name, "launches_a_call": launches,
                   "direct_host_us": d_host, "op_host_us": o_host,
                   "op_extra_host_us": o_host - d_host,
                   "direct_synced_us": d_sync, "op_synced_us": o_sync}
            result["per_call"].append(row)
            print(json.dumps(row), flush=True)

    # ---------------------------------------------- steps and requests
    solvers = parse_solver_dsl("rk2,u,8,-1,0.5,-1")
    direct_route = backend.kernel_ops

    def eager_ops():
        return True

    def timed(fn, n):
        fn()
        torch.cuda.synchronize()
        ms = []
        for _ in range(n):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(ms)

    paths = {}
    mnist = build_model("mnist", dim=64,
                        generator=torch.Generator().manual_seed(0))
    opt = make_optimizer("rmsprop", 1e-3, weight_decay=5e-4)
    attack = AttackConfig(mode="at", eps=0.3, pgd_lr=2 / 255, pgd_niter=7)
    noise = NoiseConfig(noise_type="normal", sigma=0.0125, prob=1.0)
    gx = torch.Generator().manual_seed(1)
    xm = torch.rand(128, 28, 28, 1, generator=gx).to(dev)
    ym = torch.randint(0, 10, (128,), generator=gx).to(dev)
    for label, step in (
            ("digits step, batch 128", make_train_step(
                mnist, opt, solvers, SolverOptions(), attack, noise)),
            ("clean step, batch 128", make_train_step(
                mnist, opt, solvers, SolverOptions()))):
        box = {"state": create_train_state(mnist, opt),
               "gen": torch.Generator().manual_seed(10)}

        def run(step=step, box=box):
            box["state"], _ = step(box["state"], xm, ym, box["gen"])

        paths[label] = (run, STEPS)
    served = ServedModel(mnist, solvers)
    with tempfile.TemporaryDirectory() as art:
        export_model(art, mnist, solvers, SolverOptions(),
                     input_shape=(1, 28, 28, 1))
        loaded = load_model(art)
        for b in (1, 256):
            xs = torch.rand(b, 28, 28, 1, generator=gx).to(dev)
            paths[f"served MNIST, batch {b}"] = (
                lambda xs=xs: served(xs), REQUESTS)
            paths[f"loaded MNIST artifact, batch {b}"] = (
                lambda xs=xs: loaded(xs), REQUESTS)
        samples = {(k, r): [] for k in paths for r in ("direct", "ops")}
        for _ in range(ROUNDS):
            for route in ("direct", "ops"):
                backend.kernel_ops = (direct_route if route == "direct"
                                      else eager_ops)
                try:
                    for k, (fn, n) in paths.items():
                        if route == "ops" and k.startswith("loaded"):
                            continue  # a loaded graph always calls the ops
                        samples[(k, route)].append(timed(fn, n))
                finally:
                    backend.kernel_ops = direct_route
    for k in paths:
        row = {"path": k}
        for route in ("direct", "ops"):
            s = samples[(k, route)]
            if s:
                row[f"{route}_ms"] = statistics.median(s)
                row[f"{route}_spread_ms"] = [min(s), max(s)]
        result["paths"].append(row)
        print(json.dumps(row), flush=True)
    print(json.dumps(result), flush=True)
    if out:
        with open(out, "w") as f:
            json.dump(result, f, indent=1)


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None)
    main(ap.parse_args().out)
