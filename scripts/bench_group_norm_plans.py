#!/usr/bin/env python3
"""Time kernel B3, or its backward, under every launch plan it can run, on
the card.

    python3 scripts/bench_group_norm_plans.py [--backward] [--out FILE.jsonl]
    python3 scripts/bench_group_norm_plans.py [--backward] --wrapper-only
                                              [--package-root DIR]

For each shape of ``chip_smoke.py``'s phase 5 (the MNIST MetaNODE's
GroupNorms at batch 256 and the off-path (256, 32, 32, 64)), in f32 and
bf16, it enumerates the plans of ``ops/group_norm.py`` that fit (register
path: 1-8 warps a sample; cluster path: 4 or 8 warps a block, 2-8 blocks a
sample; re-reading path: 1, 4 or 8 blocks of 8 warps), checks each against
the plain version at ``chip_smoke.py``'s bars, and times it: device ms per
launch from 20 launches captured in one CUDA graph, the least of three
replays.  It also times a one-element ``add_`` the same way (the launch
floor).  Prints one line per plan, marks the plan ``launch_plan`` picks, and
writes every row as JSON to ``--out`` if given.  With ``--wrapper-only``
it times just ``fused_group_norm_act`` (the plan it picks) at those shapes,
from the package under ``--package-root`` if given (an unpacked checkout
of another commit, so that two versions can be timed in turns in one run).
With ``--backward`` it does the same for ``group_norm_backward`` (the full
launch, with dscale and dbias) at phase 6b's shapes and the wide CIFAR
shapes, beside aten's GroupNorm backward after the activation's: its plans
are the staged path (4 or 8 warps, every cluster that fits a block) and
re-reading (1, 4 or 8 blocks), and its bars phase 6b's.
Imports no JAX; needs a CUDA device.
"""
import argparse
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

GROUPS = 32
# (N, H, W, C, act): phase 5's shapes
SHAPES = [
    (256, 26, 26, 64, "relu"), (256, 13, 13, 64, "relu"),
    (256, 6, 6, 64, "relu"), (256, 6, 6, 64, None),
    (256, 32, 32, 64, "relu"),
]
# (N, H, W, C, act): phase 6b's shapes, then the wide CIFAR shapes of
# metanode18/34 (bf16 and f32 both)
BWD_SHAPES = [
    (128, 26, 26, 64, "relu"), (128, 13, 13, 64, "relu"),
    (128, 6, 6, 64, "relu"), (128, 6, 6, 64, None),
    (256, 32, 32, 64, "relu"), (256, 32, 32, 64, "gelu"),
    (256, 32, 32, 64, None), (256, 16, 16, 128, "gelu"),
    (256, 16, 16, 128, None), (256, 8, 8, 256, "gelu"),
    (256, 8, 8, 256, None), (256, 4, 4, 512, "gelu"),
    (256, 4, 4, 512, None),
]
REPS = 20


def time_ms(fn, reps=REPS, replays=3):
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


def candidates(n, h, w, c, dtype):
    """Every plan of the kernel's instances that holds (n, h, w, c)."""
    from neural_ode_metasolver_tpu_torch.ops import group_norm as gn

    vec, shuffle = gn.access(c, GROUPS, dtype)
    hw = h * w
    out = []
    if shuffle:  # the register and cluster paths
        for warps in (1, 2, 4, 8):
            for regs in gn._REGS:
                if gn._per_thread(hw, c, vec, 32 * warps, 1) <= regs:
                    out.append(gn.make_plan("register", vec, warps, 1, regs,
                                            c, GROUPS))
        for warps in (4, 8):
            for k in range(2, gn.MAX_CLUSTER + 1):
                for regs in gn._REGS:
                    if gn._per_thread(hw, c, vec, 32 * warps, k) <= regs:
                        out.append(gn.make_plan("cluster", vec, warps, k,
                                                regs, c, GROUPS))
    for k in (1, 4, 8):
        out.append(gn.make_plan("reread", vec, 8, k, 0, c, GROUPS))
    return out


def bwd_candidates(n, h, w, c, dtype):
    """Every backward plan of the kernel's instances that holds (n, h, w,
    c) in a block's shared memory."""
    from neural_ode_metasolver_tpu_torch.ops import group_norm as gn

    vec, _ = gn.access(c, GROUPS, dtype)
    hw = h * w
    out = []

    def add(path, warps, k, regs):
        plan = gn.make_bwd_plan(path, vec, warps, k, regs, c, GROUPS, hw,
                                dtype)
        if plan.smem_bytes <= gn.SMEM_OPTIN:
            out.append(plan)

    for warps in (4, 8):
        for k in range(1, gn.MAX_CLUSTER + 1):
            add("staged", warps, k, 0)
    for k in (1, 4, 8):
        add("reread", 8, k, 0)
    return out


def aten_bwd(x, scale, bias, g, act):
    """aten's GroupNorm backward after the activation's, as chip_smoke.py's
    phase 6b times it (NCHW copies, the forward's statistics)."""
    import torch

    n, h, w, c = x.shape
    x_cl = x.permute(0, 3, 1, 2).contiguous()
    g_cl = g.permute(0, 3, 1, 2).contiguous()
    s_l = scale.to(x.dtype)
    y_l, mean_l, rstd_l = torch.ops.aten.native_group_norm(
        x_cl, s_l, bias.to(x.dtype), n, c, h * w, GROUPS, 1e-5)

    def library():
        gy = (torch.ops.aten.threshold_backward(g_cl, y_l, 0.0)
              if act == "relu" else
              torch.ops.aten.gelu_backward(g_cl, y_l)
              if act == "gelu" else g_cl)
        return torch.ops.aten.native_group_norm_backward(
            gy, x_cl, mean_l, rstd_l, s_l, n, c, h * w, GROUPS,
            [True, True, True])
    return library


def bwd_inputs(dev, n, h, w, c, dtype):
    """phase 6b's inputs: x, scale, bias, dout."""
    import torch

    gen = torch.Generator(device=dev)

    def randn(shape, scale, seed):
        gen.manual_seed(seed)
        return torch.randn(shape, generator=gen, device=dev) * scale

    x = (randn((n, h, w, c), 2.0, 6) + 0.5).to(dtype)
    return (x, randn((c,), 0.3, 7) + 1.0, randn((c,), 0.5, 8),
            randn((n, h, w, c), 1.0, 9).to(dtype))


def bwd_bars(x, g, ref):
    """phase 6b's bars on (dx, dscale, dbias)."""
    import torch

    n, h, w, c = x.shape
    dxmax = ref[0].float().abs().max().item()
    xf = x.float().reshape(n, h * w, GROUPS, c // GROUPS)
    xhat = ((xf - xf.mean((1, 3), keepdim=True)) * torch.rsqrt(
        xf.var((1, 3), unbiased=False, keepdim=True) + 1e-5)
            ).reshape(n, h, w, c)
    l1 = 2.0 * g.float().abs()
    return [1e-4 * max(1.0, dxmax) if x.dtype == torch.float32
            else 2.0 ** -6 * dxmax,
            1e-5 * max(1.0, (l1 * xhat.abs()).sum().item()),
            1e-5 * max(1.0, l1.sum().item())]


def bwd_main(dev, floor, out_path, wrapper_only):
    """The backward's plans (or, ``wrapper_only``, its wrapper) at
    BWD_SHAPES, beside aten's."""
    import torch
    from neural_ode_metasolver_tpu_torch.ops import group_norm as gn

    rows = [{"launch_floor_ms": floor}]
    for dtype in (torch.float32, torch.bfloat16):
        for n, h, w, c, act in BWD_SHAPES:
            x, scale, bias, g = bwd_inputs(dev, n, h, w, c, dtype)
            args = (x, scale, bias, g, GROUPS)
            lib_ms = time_ms(aten_bwd(x, scale, bias, g, act))
            if wrapper_only:
                ms = time_ms(lambda: gn.group_norm_backward(*args, act=act))
                rows.append({"shape": [n, h, w, c], "act": act,
                             "dtype": str(dtype).split(".")[-1], "ms": ms,
                             "library_ms": lib_ms})
                print(f"  bwd {(n, h, w, c)} act={act} {rows[-1]['dtype']}: "
                      f"{ms:.5f} ms (aten {lib_ms:.5f})", flush=True)
                continue
            ref = gn.group_norm_backward_reference(*args, act=act)
            bars = bwd_bars(x, g, ref)
            picked = gn.launch_plan(n, h, w, c, GROUPS, dtype,
                                    backward=True)
            results = []
            for plan in bwd_candidates(n, h, w, c, dtype):
                def run():
                    return gn._launch_bwd(x, scale, bias, g, GROUPS, 1e-5,
                                          act, plan, True)
                try:
                    got = run()
                    torch.cuda.synchronize()
                except RuntimeError as e:  # a refused plan: say why
                    print(f"  refused {plan}: {e}", flush=True)
                    continue
                errs = [(a.float() - b.float()).abs().max().item()
                        for a, b in zip(got, ref)]
                row = {"shape": [n, h, w, c], "act": act,
                       "dtype": str(dtype).split(".")[-1],
                       "plan": plan._asdict(), "ms": time_ms(run),
                       "library_ms": lib_ms, "max_abs_err": errs,
                       "ok": all(e <= b for e, b in zip(errs, bars)),
                       "picked": plan == picked}
                results.append(row)
                rows.append(row)
            results.sort(key=lambda r: r["ms"])
            print(f"== bwd {(n, h, w, c)} act={act} {dtype}: {len(results)} "
                  f"plans; aten {lib_ms:.5f} ms", flush=True)
            for r in results[:10] + [r for r in results[10:] if r["picked"]]:
                p = r["plan"]
                print(f"  {r['ms']:.5f} ms  {p['path']:8s} w{p['warps']} "
                      f"k{p['cluster']} r{p['regs']} s{p['smem_bytes']}  err "
                      f"{max(r['max_abs_err']):.2e}"
                      f"{'' if r['ok'] else ' FAIL'}"
                      f"{'  <- launch_plan' if r['picked'] else ''}",
                      flush=True)
            bad = [r for r in results if not r["ok"]]
            if bad:
                print(f"  {len(bad)} plans over the bars {bars}", flush=True)
            del x, g, ref
    if out_path:
        os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
        with open(out_path, "w") as fh:
            for r in rows:
                fh.write(json.dumps(r) + "\n")
    return 0


def time_wrapper(dev):
    """Device ms of ``fused_group_norm_act`` at each shape, f32 and bf16."""
    import torch
    from neural_ode_metasolver_tpu_torch.ops.group_norm import (
        fused_group_norm_act,
    )

    gen = torch.Generator(device=dev)
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        for n, h, w, c, act in SHAPES:
            gen.manual_seed(6)
            x = (torch.randn((n, h, w, c), generator=gen, device=dev) * 2.0
                 + 0.5).to(dtype)
            scale = torch.ones(c, device=dev)
            bias = torch.zeros(c, device=dev)
            ms = time_ms(lambda: fused_group_norm_act(x, scale, bias, GROUPS,
                                                      act=act))
            rows.append({"shape": [n, h, w, c], "act": act,
                         "dtype": str(dtype).split(".")[-1], "ms": ms})
            print(f"  {(n, h, w, c)} act={act} {rows[-1]['dtype']}: "
                  f"{ms:.5f} ms", flush=True)
    return rows


def main(out_path=None, package_root=None, wrapper_only=False,
         backward=False):
    import torch

    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    sys.path.insert(0, os.path.abspath(package_root or REPO))
    import neural_ode_metasolver_tpu_torch as port

    print(f"package: {os.path.dirname(os.path.abspath(port.__file__))}",
          flush=True)
    dev = torch.device("cuda")
    one = torch.zeros(1, device=dev)
    floor = time_ms(lambda: one.add_(1.0))
    print(f"launch floor (one-element add_): {floor:.5f} ms", flush=True)
    if backward:
        return bwd_main(dev, floor, out_path, wrapper_only)
    if wrapper_only:
        rows = [{"launch_floor_ms": floor}] + time_wrapper(dev)
        if out_path:
            with open(out_path, "w") as fh:
                for r in rows:
                    fh.write(json.dumps(r) + "\n")
        return 0
    from neural_ode_metasolver_tpu_torch.ops.group_norm import (
        _launch,
        group_norm_reference,
        launch_plan,
    )

    gen = torch.Generator(device=dev)

    def randn(shape, scale, seed):
        gen.manual_seed(seed)
        return torch.randn(shape, generator=gen, device=dev) * scale

    rows = [{"launch_floor_ms": floor}]
    for dtype in (torch.float32, torch.bfloat16):
        for n, h, w, c, act in SHAPES:
            x = (randn((n, h, w, c), 2.0, 6) + 0.5).to(dtype)
            scale = randn((c,), 0.3, 7) + 1.0
            bias = randn((c,), 0.5, 8)
            ref = group_norm_reference(x, scale, bias, GROUPS, act=act)
            refmax = ref.float().abs().max().item()
            bar = (2e-4 * max(1.0, refmax) if dtype == torch.float32
                   else 2.0 ** -6 * refmax)
            picked = launch_plan(n, h, w, c, GROUPS, dtype)
            results = []
            for plan in candidates(n, h, w, c, dtype):
                got = _launch(x, scale, bias, GROUPS, 1e-5, act, plan)
                err = (got.float() - ref.float()).abs().max().item()
                ms = time_ms(lambda: _launch(x, scale, bias, GROUPS, 1e-5,
                                             act, plan))
                row = {"shape": [n, h, w, c], "act": act,
                       "dtype": str(dtype).split(".")[-1],
                       "plan": plan._asdict(), "ms": ms, "max_abs_err": err,
                       "ok": err <= bar, "picked": plan == picked}
                results.append(row)
                rows.append(row)
            results.sort(key=lambda r: r["ms"])
            print(f"== {(n, h, w, c)} act={act} {dtype}: "
                  f"{len(results)} plans", flush=True)
            for r in results[:12] + [r for r in results[12:] if r["picked"]]:
                p = r["plan"]
                print(f"  {r['ms']:.5f} ms  {p['path']:8s} w{p['warps']} "
                      f"k{p['cluster']} r{p['regs']}  err {r['max_abs_err']:.2e}"
                      f"{'' if r['ok'] else ' FAIL'}"
                      f"{'  <- launch_plan' if r['picked'] else ''}",
                      flush=True)
            bad = [r for r in results if not r["ok"]]
            if bad:
                print(f"  {len(bad)} plans over the bar {bar:.3e}", flush=True)
            del x, ref
    if out_path:
        os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
        with open(out_path, "w") as fh:
            for r in rows:
                fh.write(json.dumps(r) + "\n")
    return 0


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", help="write every row as JSON lines here")
    ap.add_argument("--wrapper-only", action="store_true",
                    help="time only fused_group_norm_act at each shape")
    ap.add_argument("--package-root",
                    help="import the port from this checkout instead")
    ap.add_argument("--backward", action="store_true",
                    help="the backward's plans (or wrapper) instead")
    args = ap.parse_args()
    sys.exit(main(args.out, args.package_root, args.wrapper_only,
                  args.backward))
