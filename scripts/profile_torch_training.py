#!/usr/bin/env python3
"""Where a train step's time goes in the PyTorch port, on the card.

    python3 scripts/profile_torch_training.py
        [--model {flagship,flagship-adjoint,mnist,mnist-solver,
                  metanode10-gn,mnist-clean,mnist-fleet}]
        [--members S] [--trace-dir DIR] [batch ...]

``flagship`` (the default) runs the train step of ``bench.py:94-113``
(premetanode10, in_planes 64, GeLUpoly, RK2 u=0.5 8 steps with
Normal(0.0125) smoothing, FGSM-random 8/255 and 10/255, SGD momentum 0.9,
weight decay 5e-4, cyclic lr) in bf16, batch 256 by default, on seeded
normal images.  ``mnist`` runs the digits recipe of
``scripts/digits_smoothing_experiment.py:81-140`` (the MNIST MetaNODE at
dim 64, RK2 u=0.5 8 steps with Normal(0.0125) smoothing, PGD eps 0.3, lr
2/255, 7 iterations with a random start, RMSprop lr 1e-3, weight decay
5e-4) in f32, batch 128 by default, on seeded uniform images in [0, 1].
``metanode10-gn`` runs the flagship recipe on metanode10 (the basic-block
family) with GroupNorm of 32 groups in every slot and the exact GELU,
which kernel B3 fuses (``chip_smoke.py`` phase 18).  ``flagship-adjoint``
is the flagship step with ``integration_method="adjoint"`` (phase 21);
``mnist-solver`` the digits step's net, attack and optimizer with the
solver's u trained at lr_uv 0.01 by ``make_solver_train_step`` and no
smoothing (``mnist_runner --train_solver_params``, phase 22).
``mnist-clean`` is the u-sweep's step (``runners/u_sweep.py``: the MNIST
MetaNODE at dim 64, RK2 8 steps, RMSprop lr 1e-3, weight decay 5e-4,
clean training, f32, batch 128); ``mnist-fleet`` the same step as one
fleet of ``--members`` runs (default 16: u in 0.25, 0.5, 0.75, 1.0 by
seeds 1-4, ``training/fleet.py``, ``chip_smoke.py`` phase 24), batch 128 a
member, its img/s counted over all members.
Random weights from seed 0, seeded labels.  For each batch size, after a
warm-up
step, it times 5 steps without the profiler (host clock, median), then
traces 2 steps with ``torch.profiler`` (CPU and CUDA activities).  Prints
per traced step: the host-clock time, the device time summed over kernels,
the device busy share (their ratio; 1 minus it is the idle share), the
number of device operations, device time by phase of the step (the
kernels of the ops launched while a ``nodems.*`` range of
``training/train.py`` was open, by their CPU start), by kind (B1's forward and
dgrad kernels, the wgrad kernel, B3's forward and backward kernels, cuDNN's
convs, copies, other PyTorch kernels) and by kernel name (the 16 largest),
and the peak device memory.
With ``--trace-dir`` it also writes each chrome trace there.  Imports no
JAX; needs a CUDA device.
"""
import argparse
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

N_TRACED = 2
N_TIMED = 5
N_TOP = 16
CIFAR10_MEAN = (0.4914, 0.4822, 0.4465)  # JAX data/datasets.py:43-44
CIFAR10_STD = (0.2023, 0.1994, 0.2010)


def kind(name):
    """The kind of a device operation, by its kernel name."""
    if "nodems::" in name:  # B2 does not run in training
        if "gn_act_bwd" in name or "gn_param_grad" in name:
            return "B3 backward"
        if "gn_act" in name:
            return "B3 forward"
        return "wgrad kernel" if "wgrad" in name else "B1 forward and dgrad"
    if name.startswith(("Memcpy", "Memset")):
        return "copies"
    if any(k in name for k in ("cudnn", "xmma", "implicit_gemm", "conv",
                               "wgrad", "dgrad")):
        return "cuDNN convs"
    return "other PyTorch kernels"


def main(model_name, batches, trace_dir=None, members=16):
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    from neural_ode_metasolver_tpu_torch.models import build_model
    from neural_ode_metasolver_tpu_torch.ops import (
        SolverOptions,
        parse_solver_dsl,
    )
    from neural_ode_metasolver_tpu_torch.training import (
        AttackConfig,
        NoiseConfig,
        create_solver_train_state,
        create_train_state,
        cyclic_lr,
        make_optimizer,
        make_solver_train_step,
        make_train_step,
    )
    from neural_ode_metasolver_tpu_torch.training import fleet

    dev = torch.device("cuda")
    solvers = parse_solver_dsl("rk2,u,8,-1,0.5,-1")
    noise = NoiseConfig(noise_type="normal", sigma=0.0125, prob=1.0)
    state = None
    lead = ()  # the fleet's member axis of x and y
    if model_name in ("mnist-clean", "mnist-fleet"):
        dtype, image = torch.float32, (28, 28, 1)
        opt = make_optimizer("rmsprop", 1e-3, weight_decay=5e-4)
        if model_name == "mnist-clean":
            model = build_model("mnist", dim=64,
                                generator=torch.Generator().manual_seed(0))
            step = make_train_step(model, opt, solvers, SolverOptions())
        else:
            pairs = [(u, seed) for u in (0.25, 0.5, 0.75, 1.0)
                     for seed in (1, 2, 3, 4)]
            pairs = [pairs[i % len(pairs)] for i in range(members)]
            model = build_model("mnist", dim=64)
            gens = fleet.fleet_generators([sd for _, sd in pairs])
            state = fleet.create_fleet_state(model, opt, gens)
            dyn = fleet.stack_fleet_solvers([[solvers[0].replace(
                u=torch.tensor(u))] for u, _ in pairs])
            fstep = fleet.make_fleet_train_step(model, opt, solvers,
                                                SolverOptions())
            step = lambda st, x, y, g: fstep(st, x, y, gens, dyn)  # noqa
            lead = (members,)
        batches = batches or [128]
    elif model_name in ("mnist", "mnist-solver"):
        dtype, image = torch.float32, (28, 28, 1)
        model = build_model("mnist", dim=64,
                            generator=torch.Generator().manual_seed(0))
        opt = make_optimizer("rmsprop", 1e-3, weight_decay=5e-4)
        attack = AttackConfig(mode="at", eps=0.3, pgd_lr=2 / 255,
                              pgd_niter=7)
        if model_name == "mnist":
            step = make_train_step(model, opt, solvers, SolverOptions(),
                                   attack, noise)
        else:
            solver_opt = make_optimizer("sgd", 0.01)
            step = make_solver_train_step(model, opt, solver_opt, solvers,
                                          SolverOptions(), attack)
            state = create_solver_train_state(model, opt, solver_opt,
                                              solvers)
        batches = batches or [128]
    else:
        dtype, image = torch.bfloat16, (32, 32, 3)
        net = (dict(name="metanode10", norms=("GN",) * 3, num_gn_groups=32)
               if model_name == "metanode10-gn" else
               dict(name="premetanode10", acts=("GeLUpoly",) * 3))
        method = ("adjoint" if model_name == "flagship-adjoint"
                  else "backprop")
        model = build_model(net.pop("name"), in_planes=64,
                            generator=torch.Generator().manual_seed(0),
                            **net)
        opt = make_optimizer("sgd", cyclic_lr(1e-7, 0.1, 3186),
                             momentum=0.9, weight_decay=5e-4)
        step = make_train_step(
            model, opt, solvers, SolverOptions(),
            AttackConfig(mode="fgsm_random", eps=8 / 255, alpha=10 / 255,
                         mean=CIFAR10_MEAN, std=CIFAR10_STD),
            noise, compute_dtype=dtype, integration_method=method)
        batches = batches or [256]
    label = str(dtype).split(".")[-1]
    if state is None:
        state = create_train_state(model, opt)
    gen = torch.Generator().manual_seed(10)
    rows = []
    for batch in batches:
        g = torch.Generator().manual_seed(1)
        x = (torch.rand if image[-1] == 1 else torch.randn)(
            *lead, batch, *image, generator=g).to(dev)
        y = torch.randint(0, 10, (*lead, batch), generator=g).to(dev)
        images = batch * (lead[0] if lead else 1)
        state, _ = step(state, x, y, gen)  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        untraced = []
        for _ in range(N_TIMED):
            t0 = time.perf_counter()
            state, m = step(state, x, y, gen)
            torch.cuda.synchronize()
            untraced.append((time.perf_counter() - t0) * 1e3)
        untraced_ms = sorted(untraced)[N_TIMED // 2]
        peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(N_TRACED):
                state, m = step(state, x, y, gen)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3 / N_TRACED
        events = prof.events()
        by_name = {}
        n_device_ops = 0
        for e in events:  # device operations (not the ranges' GPU spans)
            if e.device_type == DeviceType.CUDA \
                    and not e.name.startswith("nodems."):
                by_name[e.name] = by_name.get(e.name, 0.0) \
                    + e.time_range.elapsed_us()
                n_device_ops += 1
        device_ms = sum(by_name.values()) / 1e3 / N_TRACED
        # a kernel belongs to the phase whose CPU-side nodems.* range was
        # open when the op that launched it started: the backward's ops run
        # on autograd's own thread, outside the range's thread, so neither
        # the range's own device time nor its GPU-side span sees them
        windows = [(e.time_range.start, e.time_range.end, e.name)
                   for e in events if e.device_type == DeviceType.CPU
                   and e.name.startswith("nodems.")]
        by_phase = {}
        for e in events:
            if e.device_type != DeviceType.CPU or not e.kernels:
                continue
            phase = next((n for t0, t1, n in windows
                          if t0 <= e.time_range.start < t1), "outside")
            by_phase[phase] = by_phase.get(phase, 0.0) + sum(
                k.duration for k in e.kernels) / 1e3 / N_TRACED
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:N_TOP]
        by_kind = {}
        for k, v in by_name.items():
            by_kind[kind(k)] = by_kind.get(kind(k), 0.0) + v / 1e3 / N_TRACED
        row = {
            "batch": batch, "untraced_median_ms": untraced_ms,
            "members": lead[0] if lead else None,
            "untraced_img_per_s": images / untraced_ms * 1e3,
            "wall_ms_per_step": wall_ms,
            "device_ms_per_step": device_ms,
            "device_busy_share": device_ms / wall_ms if wall_ms else None,
            "device_ops_per_step": n_device_ops / N_TRACED,
            "peak_memory_gib": peak_gib,
            "device_ms_by_phase": by_phase,
            "device_ms_by_kind": by_kind,
            "device_ms_by_kernel": {k: v / 1e3 / N_TRACED for k, v in top},
        }
        rows.append(row)
        if trace_dir is not None:
            os.makedirs(trace_dir, exist_ok=True)
            prof.export_chrome_trace(os.path.join(
                trace_dir,
                f"torch_training_{model_name}_{label}_b{batch}.trace.json"))
        print(f"{model_name} batch {batch} {label}: untraced median "
              f"{untraced_ms:.3f} ms over {N_TIMED} steps "
              f"({row['untraced_img_per_s']:.1f} img/s); traced "
              f"{wall_ms:.3f} ms per step (host clock), {device_ms:.3f} ms "
              f"of kernels, busy share {row['device_busy_share']:.3f}, "
              f"{row['device_ops_per_step']:g} device ops, peak memory "
              f"{peak_gib:.2f} GiB; last loss "
              f"{m['loss'].float().mean().item():.6f}"
              f"{f' (mean of {lead[0]} members)' if lead else ''}",
              flush=True)
        for k, v in sorted(by_phase.items()):
            print(f"  {v:9.3f} ms  (kernels of phase {k})")
        for k, v in sorted(by_kind.items(), key=lambda kv: -kv[1]):
            print(f"  {v:9.3f} ms  ({k})")
        for k, v in row["device_ms_by_kernel"].items():
            print(f"  {v:9.3f} ms  {k[:100]}")
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "model": model_name, "dtype": label, "rows": rows}))


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", choices=("flagship", "flagship-adjoint",
                                        "mnist", "mnist-solver",
                                        "metanode10-gn", "mnist-clean",
                                        "mnist-fleet"),
                    default="flagship")
    ap.add_argument("--members", type=int, default=16,
                    help="members of the mnist-fleet fleet")
    ap.add_argument("--trace-dir", default=None)
    ap.add_argument("batches", nargs="*", type=int)
    args = ap.parse_args()
    main(args.model, args.batches, args.trace_dir, args.members)
