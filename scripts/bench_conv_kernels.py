#!/usr/bin/env python3
"""Time the port's kernels at the flagship train step's and the served
paths' shapes, on the card, for comparing two checkouts in one run.

    python3 scripts/bench_conv_kernels.py [--package-root DIR] [--out FILE]
    python3 scripts/bench_conv_kernels.py --wgrad-sweep [--out FILE]

Rows, batch 256: B1 forward (``conv3x3_same``) at the stem, 64->64 and
128->128 in bf16 and MNIST's (6, 6, 65->64) in f32; B1's dgrad
(``conv3x3_dgrad``) and the wgrad kernel (``conv3x3_wgrad``) at the train
step's three shapes in bf16 and f32; B2 (``ode_block_rk2_forward``, u 0.5,
8 steps) at both ODE blocks in bf16; B3 (``fused_group_norm_act``) at the
MNIST MetaNODE's four shapes in f32.  Device ms per call: 20 calls (B2: 5)
captured in one CUDA graph, the least of three replays timed by events.
With ``--package-root`` the port is imported from that checkout (an
unpacked ``git archive`` of another commit), so run parent, change, change,
parent in one chip call and compare within it.

``--wgrad-sweep`` instead times the wgrad kernel's TMA path at the bf16
64->64 and 128->128 shapes under other launch plans (image rows a step,
ring slots, clusters of 1, 2 or 4 splits) beside the one ``wgrad_plan``
picks, each checked against the plain version.  Imports no JAX; needs a
CUDA device.
"""
import argparse
import json
import math
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

BATCH = 256
STEM = (BATCH, 32, 32, 3, 64)
L1 = (BATCH, 32, 32, 64, 64)
L2 = (BATCH, 16, 16, 128, 128)
MNIST_CONV = (BATCH, 6, 6, 65, 64)
# (N, H, W, C, act) of the MNIST MetaNODE's GroupNorms, 32 groups
GN_SHAPES = [(BATCH, 26, 26, 64, "relu"), (BATCH, 13, 13, 64, "relu"),
             (BATCH, 6, 6, 64, "relu"), (BATCH, 6, 6, 64, None)]


def time_ms(fn, reps=20, replays=3):
    """Device ms per call: ``reps`` calls in one CUDA graph, the least of
    ``replays`` replays timed by events."""
    import torch

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    best = float("inf")
    for _ in range(replays):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / reps)
    del graph
    return best


def kernel_rows(dev):
    """One row per kernel and shape of the module docstring."""
    import torch
    from neural_ode_metasolver_tpu_torch.ops.conv3x3 import (
        conv3x3_dgrad,
        conv3x3_same,
        conv3x3_wgrad,
    )
    from neural_ode_metasolver_tpu_torch.ops.group_norm import (
        fused_group_norm_act,
    )
    from neural_ode_metasolver_tpu_torch.ops.ode_block import (
        ode_block_rk2_forward,
    )

    gen = torch.Generator(device=dev)

    def randn(shape, scale, seed, dtype):
        gen.manual_seed(seed)
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(
            dtype)

    bf, f32 = torch.bfloat16, torch.float32
    rows = []

    def add(kind, shape, dtype, fn, reps=20):
        ms = time_ms(fn, reps)
        rows.append({"kind": kind, "shape": list(shape),
                     "dtype": str(dtype).split(".")[-1], "ms": ms})
        print(f"  {kind:6s} {rows[-1]['dtype']:8s} {shape}: {ms:.5f} ms",
              flush=True)

    for shape, dtype in ((STEM, bf), (L1, bf), (L2, bf), (MNIST_CONV, f32)):
        n, h, w, cin, cout = shape
        x = randn((n, h, w, cin), 1.0, 1, dtype)
        k = randn((3, 3, cin, cout), (9 * cin) ** -0.5, 2, dtype)
        add("B1", shape, dtype, lambda: conv3x3_same(x, k))
    for dtype in (bf, f32):
        for shape in (STEM, L1, L2):
            n, h, w, cin, cout = shape
            k = randn((3, 3, cin, cout), (9 * cout) ** -0.5, 2, dtype)
            dy = randn((n, h, w, cout), 1.0, 9, dtype)
            x = randn((n, h, w, cin), 1.0, 1, dtype)
            add("dgrad", shape, dtype, lambda: conv3x3_dgrad(dy, k))
            add("wgrad", shape, dtype, lambda: conv3x3_wgrad(x, dy))
    for n, h, w, c in ((BATCH, 32, 32, 64), (BATCH, 16, 16, 128)):
        y0 = randn((n, h, w, c), 0.5, 3, bf)
        w1 = randn((3, 3, c, c), (9 * c) ** -0.5, 4, bf)
        w2 = randn((3, 3, c, c), (9 * c) ** -0.5, 5, bf)
        add("B2", (n, h, w, c), bf,
            lambda: ode_block_rk2_forward(y0, w1, w2, 0.5, 8), reps=5)
    for n, h, w, c, act in GN_SHAPES:
        x = randn((n, h, w, c), 2.0, 6, f32) + 0.5
        scale = randn((c,), 0.3, 7, f32) + 1.0
        bias = randn((c,), 0.5, 8, f32)
        add("B3", (n, h, w, c, act), f32,
            lambda: fused_group_norm_act(x, scale, bias, 32, act=act))
    return rows


def wgrad_sweep(dev):
    """The TMA path at the bf16 train shapes under candidate plans."""
    import torch
    from neural_ode_metasolver_tpu_torch.ops import conv3x3 as cv

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    gen = torch.Generator(device=dev)
    rows = []
    for shape in (L1, L2):
        n, h, w, cin, cout = shape
        gen.manual_seed(1)
        x = torch.randn((n, h, w, cin), generator=gen, device=dev).to(
            torch.bfloat16)
        gen.manual_seed(9)
        dy = torch.randn((n, h, w, cout), generator=gen, device=dev).to(
            torch.bfloat16)
        ref = cv.reference_conv3x3_wgrad(x, dy).float()
        bar = 2.0 ** -7 * ref.abs().max().item()
        picked = cv.wgrad_plan(n, h, w, cin, cout, torch.bfloat16, sms)
        tiles = math.ceil(cin / 64) * math.ceil(cout / 64)
        plans = []
        for r in range(1, h + 1):
            if r * w % 16 or r * w // 16 not in cv.TMA_SLICES:
                continue
            fit = (cv.SMEM_OPTIN - 1024 - 64) // cv._tma_stage_bytes(r, w)
            base = min(n * math.ceil(h / r), math.ceil(sms / tiles))
            for stages in range(2, min(cv.TMA_MAX_STAGES, fit) + 1):
                for cluster in (1, 2, 4):
                    plans.append(cv.WgradPlan("tma", base // cluster * cluster,
                                              r, stages, cluster))
        if picked not in plans:
            plans.append(picked)
        results = []
        for plan in plans:
            got = cv._launch_wgrad(x, dy, plan)
            err = (got.float() - ref).abs().max().item()
            ms = time_ms(lambda: cv._launch_wgrad(x, dy, plan))
            row = {"shape": list(shape), "plan": plan._asdict(), "ms": ms,
                   "max_abs_err": err, "ok": err <= bar,
                   "picked": plan == picked}
            results.append(row)
            rows.append(row)
        results.sort(key=lambda r: r["ms"])
        print(f"== wgrad bf16 {shape}: {len(results)} plans", flush=True)
        for r in results:
            p = r["plan"]
            print(f"  {r['ms']:.5f} ms  rows {p['rows']} stages "
                  f"{p['stages']} splits {p['splits']} cluster "
                  f"{p['cluster']}  err "
                  f"{r['max_abs_err']:.2e}{'' if r['ok'] else ' FAIL'}"
                  f"{'  <- wgrad_plan' if r['picked'] else ''}", flush=True)
        del x, dy, ref
    return rows


def main(out_path=None, package_root=None, sweep=False):
    import torch

    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    sys.path.insert(0, os.path.abspath(package_root or REPO))
    import neural_ode_metasolver_tpu_torch as port
    from neural_ode_metasolver_tpu_torch.backend import full_f32

    print(f"package: {os.path.dirname(os.path.abspath(port.__file__))}",
          flush=True)
    dev = torch.device("cuda")
    with full_f32():
        rows = wgrad_sweep(dev) if sweep else kernel_rows(dev)
    if out_path:
        os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
        with open(out_path, "w") as fh:
            for r in rows:
                fh.write(json.dumps(r) + "\n")
    return 0


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", help="write every row as JSON lines here")
    ap.add_argument("--package-root",
                    help="import the port from this checkout instead")
    ap.add_argument("--wgrad-sweep", action="store_true",
                    help="time the wgrad kernel's TMA path under other plans")
    args = ap.parse_args()
    sys.exit(main(args.out, args.package_root, args.wgrad_sweep))
