"""MNIST robust-accuracy-vs-u sweep (port of runners/u_sweep.py): the
experiment behind the reference's README.md:46-50 figure (RK2
parametrization sweep, PGD eval eps=0.3, lr=2/255, 7 iterations, several
seeds).

For each u0 of the grid and each seed: train an MNIST MetaNODE with a
frozen RK2(u0) solver, evaluate clean and PGD robust accuracy, and write a
CSV of (u0, seed, clean_acc, robust_acc), the data of the mean +- sem
curve.  The JAX runner's flags, plus ``--device`` (default the card;
``cpu`` for the CPU).

Sequentially, each (u0, seed) run is a ``make_train_step`` run whose
solver comes in as ``dynamic_solvers``; one CPU generator seeded with the
seed draws the run's initial weights, every step's seeds and the PGD
eval's, in that order.  With ``--fleet`` the runs train as members of one
fleet (``training/fleet.py``): S runs advance in one step, every kernel
launched once for all of them, each member on its own run's generator,
batch order (seed * 1000 + epoch) and u.  Member m's params follow its
sequential run to float tolerance (the fleet's grouped convs and batched
head sum in another order), and its PGD eval draws its run's seeds, so
the two paths give the same estimator on nearly the same sample.

  python -m neural_ode_metasolver_tpu_torch.runners.u_sweep \\
      --u_grid 0.1,0.3,0.5,0.6667,0.8,1.0 --seeds 1,2,3 \\
      --nepochs 3 --data_root /path/to/mnist [--fleet]
"""
from __future__ import annotations

import argparse
import csv

import numpy as np
import torch

from ..backend import resolve_device
from ..data import batch_iterator, load_mnist, synthetic_dataset
from ..models.api import build_model
from ..ops import SolverOptions, create_solver
from ..training import (
    AttackConfig,
    accuracy,
    adversarial_accuracy,
    create_train_state,
    learning_rate_with_decay,
    make_optimizer,
    make_train_step,
)
from ..training.fleet import (
    create_fleet_state,
    fleet_generators,
    make_fleet_eval_step,
    make_fleet_train_step,
    stack_fleet_solvers,
    tile_fleet,
)
from ..utils import atomic_write, get_logger

__all__ = ["parse_args", "main", "FLEET_SAFE_CHUNK", "CSV_COLUMNS"]

CSV_COLUMNS = ["u0", "seed", "clean_acc", "robust_acc"]
EVAL_BATCH = 256  # the PGD eval's batch, as JAX's

# Members of one fleet when --fleet_chunk is unset, from the card's
# measurement (PERF.md section 6, "the fleet's size"; H100 80GB HBM3 at
# 700.00 W, chip_smoke.py phase 24): the u-sweep step (dim 64, batch 128 a
# member, f32, RK2 over 8 steps, clean) at 1, 4, 8, 16 and 32 members ran
# 3306-4956, 15716-19334, 24472-24966, 29603-29828 and 31210-31251 img/s
# over all members in two runs, at a peak of 0.26 to 4.90 GiB: the card is
# busy from 8 members on, throughput still rises to 32, and memory binds
# nowhere near it.  A larger grid is cut into equal chunks of at most this
# many members, the tail padded.
FLEET_SAFE_CHUNK = 32


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--u_grid",
                   type=lambda s: [float(i) for i in s.split(",")],
                   default=[0.1, 0.3, 0.5, 2 / 3, 0.8, 1.0])
    p.add_argument("--seeds",
                   type=lambda s: [int(i) for i in s.split(",")],
                   default=[1, 2, 3])
    p.add_argument("--n_steps", type=int, default=8)
    p.add_argument("--nepochs", type=int, default=3)
    p.add_argument("--batch_size", type=int, default=128)
    p.add_argument("--lr", type=float, default=0.001)
    p.add_argument("--optim", type=str, default="rmsprop")
    p.add_argument("--adv_training_mode", type=str, default="clean",
                   choices=["clean", "at"])
    p.add_argument("--eps", type=float, default=0.3)
    p.add_argument("--pgd_lr", type=float, default=2 / 255)
    p.add_argument("--pgd_niter", type=int, default=7)
    p.add_argument("--data_root", type=str, default=None)
    p.add_argument("--fallback_dataset", type=str, default="synthetic",
                   choices=["synthetic", "digits"])
    p.add_argument("--synthetic_train_size", type=int, default=2048)
    p.add_argument("--synthetic_test_size", type=int, default=512)
    p.add_argument("--dim", type=int, default=64)
    p.add_argument("--output_csv", type=str, default="mnist_u_sweep.csv")
    p.add_argument("--fleet", action="store_true",
                   help="train every (u, seed) run as a member of one "
                        "fleet (training/fleet.py) instead of one after "
                        "another: the same per-seed streams, one step "
                        "(each kernel one launch) for all members")
    p.add_argument("--fleet_chunk", type=int, default=None,
                   help="members per fleet (default: all, up to the "
                        "card's measured FLEET_SAFE_CHUNK; beyond it, one "
                        "equal chunk size in (FLEET_SAFE_CHUNK/2, "
                        "FLEET_SAFE_CHUNK] with the fewest padded "
                        "members)")
    p.add_argument("--device", type=str, default=None,
                   help="device to run on (default: the CUDA card; 'cpu' "
                        "for the CPU)")
    return p.parse_args(argv)


def _load_data(args, logger):
    if args.data_root:
        return (load_mnist(args.data_root, train=True),
                load_mnist(args.data_root, train=False))
    if args.fallback_dataset == "digits":
        from ..data import load_digits_dataset

        logger.warning("no --data_root: real sklearn handwritten digits")
        return load_digits_dataset(seed=0)
    logger.warning("no --data_root: synthetic data")
    return (synthetic_dataset(args.synthetic_train_size, (28, 28, 1),
                              seed=0),
            synthetic_dataset(args.synthetic_test_size, (28, 28, 1),
                              seed=1))


def _recipe(args, train_ds):
    """The optimizer, the reference solver and the attack configs every
    run shares."""
    batches_per_epoch = max(len(train_ds) // args.batch_size, 1)
    sched = learning_rate_with_decay(args.lr, args.batch_size,
                                     batches_per_epoch)
    opt = make_optimizer(args.optim, sched, weight_decay=5e-4)
    ref_solver = create_solver("rk2", "u", n_steps=args.n_steps, u0=0.5)
    train_attack = AttackConfig(mode=args.adv_training_mode, eps=args.eps,
                                pgd_lr=args.pgd_lr, pgd_niter=args.pgd_niter)
    pgd_attack = AttackConfig(mode="at", eps=args.eps, pgd_lr=args.pgd_lr,
                              pgd_niter=args.pgd_niter)
    return opt, ref_solver, train_attack, pgd_attack


def _u_solver(ref_solver, u0: float):
    """The reference solver with u = u0: only the u tensor changes (the
    JAX runner keeps the traced leaf; here it keeps one code path)."""
    return ref_solver.replace(u=torch.tensor(u0, dtype=torch.float32))


def main(argv=None):
    args = parse_args(argv)
    logger = get_logger("u_sweep.log", name="u_sweep")
    dev = resolve_device(args.device)
    train_ds, test_ds = _load_data(args, logger)
    opts = SolverOptions()
    opt, ref_solver, train_attack, pgd_attack = _recipe(args, train_ds)

    if args.fleet:
        rows = _run_fleet(args, dev, opt, ref_solver, opts, train_attack,
                          pgd_attack, train_ds, test_ds, logger)
        _write_csv(args.output_csv, rows)
        logger.info(f"wrote {len(rows)} rows to {args.output_csv}")
        return rows

    test = list(batch_iterator(test_ds, EVAL_BATCH, shuffle=False,
                               drop_last=False))
    rows = []
    for u0 in args.u_grid:
        solvers = [_u_solver(ref_solver, u0)]
        for seed in args.seeds:
            gen = torch.Generator().manual_seed(seed)
            model = build_model("mnist", dev, generator=gen, dim=args.dim)
            ts = create_train_state(model, opt)
            step = make_train_step(model, opt, [ref_solver], opts,
                                   attack_cfg=train_attack)
            for epoch in range(args.nepochs):
                for x, y in batch_iterator(train_ds, args.batch_size,
                                           seed=seed * 1000 + epoch,
                                           crop_padding=4):
                    ts, _ = step(ts, torch.as_tensor(x, device=dev),
                                 torch.as_tensor(y, device=dev).long(), gen,
                                 dynamic_solvers=solvers)
            clean_acc = accuracy(model, solvers, opts, test)
            robust_acc = adversarial_accuracy(model, solvers, opts, test,
                                              pgd_attack, gen)
            logger.info(f"u0={u0:.4f} seed={seed} clean={clean_acc:.4f} "
                        f"pgd={robust_acc:.4f}")
            rows.append({"u0": u0, "seed": seed, "clean_acc": clean_acc,
                         "robust_acc": robust_acc})

    _write_csv(args.output_csv, rows)
    logger.info(f"wrote {len(rows)} rows to {args.output_csv}")
    return rows


def _write_csv(path, rows):
    with atomic_write(path, newline="") as f:
        w = csv.DictWriter(f, fieldnames=CSV_COLUMNS)
        w.writeheader()
        w.writerows(rows)


def fleet_chunk_size(n_members: int, chunk=None, logger=None) -> int:
    """Members per fleet: ``chunk``, else all of them up to
    ``FLEET_SAFE_CHUNK``, else the equal chunk size in
    (FLEET_SAFE_CHUNK/2, FLEET_SAFE_CHUNK] with the fewest padded members,
    the larger on a tie (JAX ``u_sweep.py:206-238``)."""
    if chunk is not None and chunk < 1:
        raise ValueError(f"--fleet_chunk must be >= 1, got {chunk} (omit "
                         f"the flag to auto-chunk at the measured bound "
                         f"{FLEET_SAFE_CHUNK})")
    if chunk is not None:
        return chunk
    if n_members <= FLEET_SAFE_CHUNK:
        return n_members
    chunk = min(range(FLEET_SAFE_CHUNK, FLEET_SAFE_CHUNK // 2, -1),
                key=lambda c: (-(-n_members // c) * c - n_members, -c))
    if logger:
        logger.warning(
            f"--fleet_chunk unset with {n_members} members: auto-chunking "
            f"at {chunk} (measured bound {FLEET_SAFE_CHUNK}, PERF.md); pass "
            f"--fleet_chunk to override")
    return chunk


def _run_fleet(args, dev, opt, ref_solver, opts, train_attack, pgd_attack,
               train_ds, test_ds, logger):
    """The (u_grid x seeds) sweep as fleets of equal size: a short tail is
    padded with copies of its first member (one fleet size, one numerics
    stream), whose rows are dropped."""
    members = [(u0, seed) for u0 in args.u_grid for seed in args.seeds]
    chunk = fleet_chunk_size(len(members), args.fleet_chunk, logger)
    n_chunks = -(-len(members) // chunk)
    rows = []
    for lo in range(0, len(members), chunk):
        part = members[lo:lo + chunk]
        n_real = len(part)
        if n_real < chunk and n_chunks > 1:
            logger.info(f"padding tail chunk {n_real} -> {chunk} members "
                        f"to keep one numerics stream")
            part = part + [part[0]] * (chunk - n_real)
        if n_chunks > 1:
            logger.info(f"fleet chunk {lo // chunk + 1}/{n_chunks}: "
                        f"{n_real} members")
        rows += _run_fleet_members(args, dev, opt, ref_solver, opts,
                                   train_attack, pgd_attack, train_ds,
                                   test_ds, logger, part)[:n_real]
    return rows


def _run_fleet_members(args, dev, opt, ref_solver, opts, train_attack,
                       pgd_attack, train_ds, test_ds, logger, members):
    """Train and evaluate one fleet of (u0, seed) members."""
    n = len(members)
    model = build_model("mnist", dev, dim=args.dim)
    dyn = stack_fleet_solvers([[_u_solver(ref_solver, u0)]
                               for u0, _ in members])
    logger.info(f"fleet sweep: {n} members (of "
                f"{len(args.u_grid) * len(args.seeds)} in all) in one fleet")
    gens = fleet_generators([seed for _, seed in members])
    fts = create_fleet_state(model, opt, gens)
    step = make_fleet_train_step(model, opt, [ref_solver], opts,
                                 attack_cfg=train_attack)
    for epoch in range(args.nepochs):
        iters = [batch_iterator(train_ds, args.batch_size,
                                seed=seed * 1000 + epoch, crop_padding=4)
                 for _, seed in members]
        for batches in zip(*iters):
            x = torch.from_numpy(np.stack([b[0] for b in batches])).to(dev)
            y = torch.from_numpy(np.stack([b[1] for b in batches])).to(
                dev).long()
            fts, _ = step(fts, x, y, gens, dyn)

    clean_fn = make_fleet_eval_step(model, [ref_solver], opts)
    pgd_fn = make_fleet_eval_step(model, [ref_solver], opts,
                                  attack_cfg=pgd_attack)
    counts_c = torch.zeros(n, dtype=torch.long, device=dev)
    counts_a = torch.zeros(n, dtype=torch.long, device=dev)
    total = 0
    for x, y in batch_iterator(test_ds, EVAL_BATCH, shuffle=False,
                               drop_last=False):
        xs = tile_fleet(torch.as_tensor(x, device=dev), n)
        ys = tile_fleet(torch.as_tensor(y, device=dev).long(), n)
        counts_c += clean_fn(fts.params, fts.model_state, xs, ys,
                             dynamic_solvers=dyn)
        counts_a += pgd_fn(fts.params, fts.model_state, xs, ys, gens, dyn)
        total += int(y.shape[0])
    clean = counts_c.cpu().numpy() / max(total, 1)
    robust = counts_a.cpu().numpy() / max(total, 1)

    rows = []
    for i, (u0, seed) in enumerate(members):
        logger.info(f"u0={u0:.4f} seed={seed} clean={clean[i]:.4f} "
                    f"pgd={robust[i]:.4f}")
        rows.append({"u0": u0, "seed": seed,
                     "clean_acc": float(clean[i]),
                     "robust_acc": float(robust[i])})
    return rows


if __name__ == "__main__":
    main()
