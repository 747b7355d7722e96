#!/usr/bin/env python3
"""Time the port's kernels at the flagship train step's and the served
paths' shapes, on the card, for comparing two checkouts in one run.

    python3 scripts/bench_conv_kernels.py [--package-root DIR] [--out FILE]
    python3 scripts/bench_conv_kernels.py --wgrad-sweep [--out FILE]
    python3 scripts/bench_conv_kernels.py --f32-sweep [--out FILE]
    python3 scripts/bench_conv_kernels.py --dump-bf16 FILE [--package-root DIR]

Rows, batch 256: B1 forward (``conv3x3_same``) at the stem, 64->64 and
128->128 in bf16 and MNIST's (6, 6, 65->64) in f32; B1's dgrad
(``conv3x3_dgrad``) and the wgrad kernel (``conv3x3_wgrad``) at the train
step's three shapes in bf16 and f32; B1, its dgrad and the wgrad at the
digits train step's (128, 6, 6, 65->64) in f32; B2
(``ode_block_rk2_forward``, u 0.5, 8 steps) at both ODE blocks in bf16; B3
(``fused_group_norm_act``) at the MNIST MetaNODE's four shapes in f32.  Device ms per call: 20 calls (B2: 5)
captured in one CUDA graph, the least of three replays timed by events.
With ``--package-root`` the port is imported from that checkout (an
unpacked ``git archive`` of another commit), so run parent, change, change,
parent in one chip call and compare within it.

``--wgrad-sweep`` instead times the wgrad kernel's TMA path at the bf16
64->64 and 128->128 shapes under other launch plans (image rows a step,
ring slots, clusters of 1, 2 or 4 splits) beside the one ``wgrad_plan``
picks, each checked against the plain version.

``--f32-sweep`` times the f32 kernels under candidate plans beside the one
the package picks, each checked against the plain version at the card
bars (1e-4 of the largest output, the wgrad 1e-5), with cuDNN's full-f32
call (grouped over the members) as the yardstick: B1's f32 core
(``conv3x3_f32_plan``: rows 128, 64, 32 and 2 to 4 ring slots) at the
flagship f32 shapes, MNIST's (6, 6, 65->64) at batch 256 and 128 and its
dgrad (64->65), and the u-sweep fleet's 16 members of 128; the wgrad's f32
path (``wgrad_plan``: K ranges and ring slots) at the digits and member
shapes and the flagship's.

``--dump-bf16 FILE`` saves the bf16 outputs of B1, its dgrad, the wgrad
and B2 on seeded inputs (the flagship's shapes, MNIST's 65 channels, a
member-batched launch) with ``torch.save``: dumps of two checkouts
(``--package-root``) compare bit for bit.  Imports no JAX; needs a CUDA
device.
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
DIGITS_CONV = (128, 6, 6, 65, 64)
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

    for shape, dtype in ((STEM, bf), (L1, bf), (L2, bf), (MNIST_CONV, f32),
                         (DIGITS_CONV, f32)):
        n, h, w, cin, cout = shape
        x = randn((n, h, w, cin), 1.0, 1, dtype)
        k = randn((3, 3, cin, cout), (9 * cin) ** -0.5, 2, dtype)
        add("B1", shape, dtype, lambda: conv3x3_same(x, k))
    for dtype in (bf, f32):
        for shape in (STEM, L1, L2) + ((DIGITS_CONV,) if dtype == f32
                                       else ()):
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


# (kind, S members or 0 for a single run, N, H, W, Cin, Cout) of the f32
# sweep; the dgrad's Cin and Cout are the forward conv's
F32_SWEEP = [("B1", 0, BATCH, 32, 32, 64, 64),
             ("B1", 0, BATCH, 16, 16, 128, 128),
             ("B1", 0, BATCH, 6, 6, 65, 64), ("B1", 0, 128, 6, 6, 65, 64),
             ("B1", 16, 128, 6, 6, 65, 64),
             ("dgrad", 0, BATCH, 32, 32, 64, 64),
             ("dgrad", 0, BATCH, 16, 16, 128, 128),
             ("dgrad", 0, 128, 6, 6, 65, 64),
             ("dgrad", 0, BATCH, 6, 6, 65, 64),
             ("dgrad", 16, 128, 6, 6, 65, 64),
             ("wgrad", 0, 128, 6, 6, 65, 64), ("wgrad", 16, 128, 6, 6, 65, 64),
             ("wgrad", 0, BATCH, 32, 32, 64, 64),
             ("wgrad", 0, BATCH, 16, 16, 128, 128)]


def f32_sweep(dev):
    """The f32 kernels under candidate plans (module docstring)."""
    import torch
    import torch.nn.functional as F
    from neural_ode_metasolver_tpu_torch.ops import conv3x3 as cv

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    gen = torch.Generator(device=dev)
    f32 = torch.float32

    def randn(shape, scale, seed):
        gen.manual_seed(seed)
        return torch.randn(shape, generator=gen, device=dev) * scale

    rows = []
    for kind, s, n, h, w, cin, cout in F32_SWEEP:
        lead = (s,) if s else ()
        x = randn(lead + (n, h, w, cin), 1.0, 1)
        k = randn(lead + (3, 3, cin, cout), (9 * cin) ** -0.5, 2)
        dy = randn(lead + (n, h, w, cout), 1.0, 9)
        g = max(s, 1)

        # cuDNN's operands as chip_smoke.py gives them: a single run's NCHW
        # views of the NHWC tensors (channels_last strides), the members'
        # (N, S*C, H, W) grouped copies
        if s:
            xg, dyg = (t.permute(1, 0, 4, 2, 3).reshape(n, -1, h, w)
                       .contiguous() for t in (x, dy))
            kg = k.permute(0, 4, 3, 1, 2).reshape(g * cout, cin, 3, 3
                                                  ).contiguous()
        else:
            xg, dyg = x.permute(0, 3, 1, 2), dy.permute(0, 3, 1, 2)
            kg = k.permute(3, 2, 0, 1).contiguous(
                memory_format=torch.channels_last)
        flops = 2 * g * n * h * w * cin * cout * 9
        if kind == "wgrad":
            ref = cv.reference_conv3x3_wgrad(x, dy)
            bar = 1e-5 * max(1.0, ref.abs().max().item())
            picked = cv.wgrad_plan(n, h, w, cin, cout, f32, sms)
            steps = -(-n * h * w // cv.WGRAD_F32_BK)
            cands = sorted({max(1, min(steps, v)) for v in (
                picked.splits, -(-steps // 1), -(-steps // 2),
                -(-steps // 3), -(-steps // 4), -(-steps // 6),
                -(-steps // 8), 8, 10, 16, 24, 33, 48, 66)})
            plans = [cv.WgradPlan("f32", c, cv.WGRAD_F32_BK, st, 1)
                     for c in cands for st in (2, 3)]
            run = lambda pl: cv._launch_wgrad(x, dy, pl)  # noqa: E731
            lib = lambda: torch.nn.grad.conv2d_weight(  # noqa: E731
                xg, (g * cout, cin, 3, 3), dyg, padding=1, groups=g)
        else:
            # the dgrad's flipped weights with rows padded to 16 bytes, as
            # conv3x3_dgrad gives them
            src, wk, co, ci = ((x, k, cout, cin) if kind == "B1" else
                               (dy, F.pad(k.flip(-4, -3).transpose(-2, -1),
                                          (0, -cin % 4)).contiguous(), cin,
                                cout))
            ref = cv.reference_conv3x3(src, wk[..., :co])
            bar = 1e-4 * max(1.0, ref.abs().max().item())
            picked = cv.conv3x3_f32_plan(n, h, w, ci, co, sms)
            plans = []
            for r in cv.F32_ROWS:
                for st in (2, 3, 4):
                    pl = cv.ConvF32Plan(
                        "f32_halo" if w <= r + 2 else "f32_bands", r,
                        picked.cols, cv.F32_THREADS // r, st)
                    if cv._f32_smem(w, ci, *pl[1:]) <= cv.SMEM_OPTIN:
                        plans.append(pl)
            run = lambda pl: cv._launch_conv(  # noqa: E731
                src, wk, "sweep", pl, cout=co)
            if kind == "B1":
                lib = lambda: F.conv2d(xg, kg, padding=1,  # noqa: E731
                                       groups=g)
            else:
                lib = lambda: torch.nn.grad.conv2d_input(  # noqa: E731
                    (n, g * cin, h, w), kg, dyg, padding=1, groups=g)
        lib_ms = time_ms(lib, 10)
        bound_ms = flops / 67e12 * 1e3
        results = []
        for pl in plans:
            got = run(pl)
            err = (got - ref).abs().max().item()
            ms = time_ms(lambda: run(pl), 10)
            row = {"kind": kind, "members": s, "shape": [n, h, w, cin, cout],
                   "plan": pl._asdict(), "ms": ms, "max_abs_err": err,
                   "ok": err <= bar, "picked": pl == picked,
                   "cudnn_ms": lib_ms, "bound_ms": bound_ms}
            results.append(row)
            rows.append(row)
        results.sort(key=lambda r: r["ms"])
        print(f"== f32 {kind} {f'{s} x ' if s else ''}{(n, h, w, cin, cout)}"
              f": cuDNN {lib_ms:.5f} ms, bound {bound_ms:.5f} ms", flush=True)
        for r in results:
            print(f"  {r['ms']:.5f} ms ({r['bound_ms'] / r['ms']:.3f} of the "
                  f"bound) {tuple(r['plan'].values())} err "
                  f"{r['max_abs_err']:.2e}{'' if r['ok'] else ' FAIL'}"
                  f"{'  <- picked' if r['picked'] else ''}", flush=True)
        del x, k, dy, ref, xg, dyg, kg
        torch.cuda.empty_cache()
    return rows


def dump_bf16(dev):
    """The bf16 outputs of B1, dgrad, wgrad and B2, by name."""
    import torch
    from neural_ode_metasolver_tpu_torch.ops import conv3x3 as cv
    from neural_ode_metasolver_tpu_torch.ops.ode_block import (
        ode_block_rk2_forward,
    )

    gen = torch.Generator(device=dev)

    def randn(shape, scale, seed):
        gen.manual_seed(seed)
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(
            torch.bfloat16)

    out = {}
    for shape in (STEM, L1, L2, (128, 6, 6, 65, 64), (2, 8, 8, 64, 5)):
        n, h, w, cin, cout = shape
        x = randn((n, h, w, cin), 1.0, 1)
        k = randn((3, 3, cin, cout), (9 * cin) ** -0.5, 2)
        dy = randn((n, h, w, cout), 1.0, 9)
        out[f"B1 {shape}"] = cv.conv3x3_same(x, k)
        out[f"dgrad {shape}"] = cv.conv3x3_dgrad(dy, k)
        out[f"wgrad {shape}"] = cv.conv3x3_wgrad(x, dy)
    xs = randn((3, 4, 8, 8, 64), 1.0, 3)
    ks = randn((3, 3, 3, 64, 64), 0.04, 4)
    out["B1 members (3, 4, 8, 8, 64, 64)"] = cv.conv3x3_same(xs, ks)
    for n, h, w, c in ((BATCH, 32, 32, 64), (BATCH, 16, 16, 128)):
        y0 = randn((n, h, w, c), 0.5, 5)
        w1 = randn((3, 3, c, c), (9 * c) ** -0.5, 6)
        w2 = randn((3, 3, c, c), (9 * c) ** -0.5, 7)
        out[f"B2 {(n, h, w, c)}"] = ode_block_rk2_forward(y0, w1, w2, 0.5, 8)
    torch.cuda.synchronize()
    return {k: v.cpu() for k, v in out.items()}


def main(out_path=None, package_root=None, sweep=False, f32=False,
         dump=None):
    import torch

    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    sys.path.insert(0, os.path.abspath(package_root or REPO))
    import neural_ode_metasolver_tpu_torch as port
    from neural_ode_metasolver_tpu_torch.backend import full_f32

    print(f"package: {os.path.dirname(os.path.abspath(port.__file__))}",
          flush=True)
    dev = torch.device("cuda")
    if dump:
        torch.save(dump_bf16(dev), dump)
        return 0
    with full_f32():
        rows = (f32_sweep(dev) if f32 else wgrad_sweep(dev) if sweep
                else kernel_rows(dev))
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
    ap.add_argument("--f32-sweep", action="store_true",
                    help="time the f32 kernels under other plans")
    ap.add_argument("--dump-bf16", metavar="FILE",
                    help="save the bf16 kernels' outputs to FILE")
    args = ap.parse_args()
    sys.exit(main(args.out, args.package_root, args.wgrad_sweep,
                  args.f32_sweep, args.dump_bf16))
