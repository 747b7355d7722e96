"""MNIST training CLI (port of runners/mnist_runner.py; flag parity with
odenet_mnist/runner_new.py).

Example, on the card:
  python -m neural_ode_metasolver_tpu_torch.runners.mnist_runner \
      --solvers "rk2,u,8,-1,0.5,-1" --nepochs 3 --batch_size 128 \
      --data_root /path/to/mnist   # or omit for synthetic data

``--device cpu`` runs the plain PyTorch versions on the CPU; without a card
and without it the run raises.  The flags are the JAX runner's; those the
port does not run raise (``runners/common.py``).  ``--mesh data=-1`` with
``--coordinator``, ``--num_hosts`` and ``--process_id`` trains one run
data-parallel over that many processes, one device each; a ``model`` or
``sp`` axis trains tensor parallel or with the height sharded, over ranks
of one host (``--mesh pp=`` needs a CIFAR-family model and raises JAX's
message).

``--train_solver_params`` trains the solvers' (u, v) with the network
(``training/solver_training.py``; SGD at ``--lr_uv``), logs u each epoch
and writes ``save_dir/solver_trained``, as the JAX runner's joint loop
does; like it, it refuses ``--integration_method adjoint`` (the adjoint
gives u no gradient) and ``--profile_dir``.
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from ..backend import resolve_device
from ..data import (
    batch_iterator,
    data_backend,
    load_mnist,
    synthetic_dataset,
)
from ..data.download import ensure_dataset
from ..models.api import build_model
from ..ops import parse_solver_dsl
from ..training import (
    AttackConfig,
    MetricsLogger,
    accuracy,
    create_solver_train_state,
    learning_rate_with_decay,
    make_optimizer,
    make_solver_train_step,
    save_checkpoint,
    solvers_from_state,
)
from ..utils import count_parameters, fix_seeds, get_logger
from .common import (
    add_device_flag,
    add_multihost_flags,
    bool_flag,
    build_solver_options,
    check_unported_flags,
    device_batches,
    fit,
    setup_multihost,
)


def build_parser():
    p = argparse.ArgumentParser(description=__doc__)
    # solver / regime flags (runner.py:31-53)
    p.add_argument("--solvers", type=str, default="rk2,u,8,-1,0.5,-1")
    p.add_argument("--solver_mode", type=str, default="standalone",
                   choices=["standalone", "switch", "ensemble"])
    p.add_argument("--switch_probs",
                   type=lambda s: [float(i) for i in s.split(",")],
                   default=None)
    p.add_argument("--ensemble_weights",
                   type=lambda s: [float(i) for i in s.split(",")],
                   default=None)
    p.add_argument("--ensemble_prob", type=float, default=1.0)
    p.add_argument("--noise_type", type=str, default=None,
                   choices=[None, "cauchy", "normal"])
    p.add_argument("--noise_sigma", type=float, default=0.001)
    p.add_argument("--noise_prob", type=float, default=0.0)
    p.add_argument("--minimize_rk2_error", action="store_true")
    p.add_argument("--val_solver_modes",
                   type=lambda s: s.strip().split(","),
                   default=["standalone"])
    # architecture (runner.py:55-66)
    p.add_argument("--network", type=str, default="odenet",
                   choices=["odenet", "resnet"])
    p.add_argument("--downsampling_method", type=str, default="conv",
                   choices=["conv", "res"])
    p.add_argument("--activation", type=str, default="relu")
    p.add_argument("--in_channels", type=int, default=1)
    # optimization (runner.py:137-151)
    p.add_argument("--lr", type=float, default=0.1)
    p.add_argument("--optim", type=str, default="rmsprop",
                   choices=["sgd", "rmsprop", "adam"])
    p.add_argument("--momentum", type=float, default=0.9)
    p.add_argument("--weight_decay", type=float, default=0.0005)
    p.add_argument("--batch_size", type=int, default=128)
    p.add_argument("--test_batch_size", type=int, default=1000)
    p.add_argument("--nepochs", type=int, default=160)
    p.add_argument("--data_aug", type=bool_flag, default=True,
                   choices=[True, False])
    p.add_argument("--seed", type=int, default=502)
    # adversarial training/testing (runner_new.py:86-104)
    p.add_argument("--adv_training_mode", default="clean",
                   choices=["clean", "fgsm", "at"])
    p.add_argument("--eps_adv_training", type=float, default=0.3)
    p.add_argument("--pgd_lr_training", type=float, default=2 / 255)
    p.add_argument("--pgd_niter_training", type=int, default=7)
    p.add_argument("--adv_testing_mode", default="clean",
                   choices=["clean", "fgsm", "at"])
    p.add_argument("--eps_adv_testing", type=float, default=0.3)
    p.add_argument("--pgd_lr_testing", type=float, default=2 / 255)
    p.add_argument("--pgd_niter_testing", type=int, default=7)
    p.add_argument("--ss_loss", action="store_true")
    p.add_argument("--ss_loss_reg", type=float, default=0.1)
    p.add_argument("--data_noise_std", type=float, default=0.0)
    # io
    p.add_argument("--dataset", type=str, default="mnist",
                   choices=["mnist", "svhn"],
                   help="train/eval dataset (svhn = the reference's "
                        "get_svhn_loaders path: 32x32 RGB cropped digits)")
    p.add_argument("--download", action="store_true",
                   help="fetch the dataset into --data_root (default data/) "
                        "if missing — the torchvision download=True analog")
    p.add_argument("--data_root", type=str, default=None,
                   help="dir with MNIST IDX files; fallback data if unset")
    p.add_argument("--fallback_dataset", type=str, default="synthetic",
                   choices=["synthetic", "digits"],
                   help="without --data_root: synthetic blobs or sklearn's "
                        "real handwritten digits (offline)")
    p.add_argument("--save_dir", type=str, default="./experiment_mnist")
    p.add_argument("--debug", action="store_true")
    p.add_argument("--resume", action="store_true")
    # trainable solver coefficients (reference legacy lr_uv param group,
    # runner_old.py:184-185)
    p.add_argument("--train_solver_params", action="store_true",
                   help="optimize solver u/v jointly with the network")
    p.add_argument("--lr_uv", type=float, default=0.01,
                   help="learning rate for the solver-parameter group")
    p.add_argument("--integration_method", type=str, default="backprop",
                   choices=["backprop", "adjoint"],
                   help="gradient path through the ODE solve: backprop "
                   "through the RK steps, or the continuous adjoint")
    p.add_argument("--nan_backoff", type=float, default=None,
                   help="on non-finite grads: drop the update and dip the "
                   "effective step size by this factor (recovers over "
                   "subsequent finite steps)")
    p.add_argument("--skip_nonfinite", action="store_true",
                   help="skip (not apply) updates with non-finite "
                        "loss/grads; logs skipped_nonfinite metric")
    p.add_argument("--unroll", type=int, default=1,
                   help="the JAX scan's unroll factor; no effect in the "
                        "port, whose RK step loop is a Python loop")
    p.add_argument("--precision", type=str, default="f32",
                   choices=["f32", "bf16"],
                   help="compute precision (bf16 = mixed precision, the "
                        "apex-O1 analog; master params stay f32)")
    p.add_argument("--mesh", type=str, default=None,
                   help="device mesh over the process group, e.g. "
                        "'data=-1' (every rank), 'data=2,model=2' "
                        "(tensor parallelism), 'data=1,sp=2' (the "
                        "height sharded), 'data=1,pp=2' (GPipe over "
                        "the ODE-block stacks; CIFAR family)")
    p.add_argument("--compiler_option", action="append", default=None,
                   metavar="NAME=VALUE",
                   help="an XLA compiler flag of the JAX runner; raises "
                        "(the port compiles no XLA program)")
    p.add_argument("--profile_dir", type=str, default=None,
                   help="write a torch.profiler Chrome trace of "
                        "steady-state steps 1-3 (epoch 0) into this dir")
    p.add_argument("--prefetch", type=int, default=2,
                   help="batches copied to the card ahead of the train "
                        "step (0 disables; overlaps the copy with compute)")
    p.add_argument("--synthetic_train_size", type=int, default=4096)
    p.add_argument("--synthetic_test_size", type=int, default=1024)
    add_multihost_flags(p)
    add_device_flag(p)
    return p


def parse_args(argv=None):
    return build_parser().parse_args(argv)


def main(argv=None):
    """Train, validate and checkpoint; returns the final TrainState."""
    args = parse_args(argv)
    check_unported_flags(args)
    if args.train_solver_params:
        _check_solver_training_flags(args)
    rank = setup_multihost(args)  # before any device use
    dev = resolve_device(args.device)
    fix_seeds(args.seed)
    logger = get_logger(
        os.path.join(args.save_dir,
                     "logs" if rank == 0 else f"logs_p{rank}"),
        debug=args.debug, name="mnist")
    logger.info(str(vars(args)))

    if args.dataset == "svhn" and args.in_channels == 1:
        # SVHN is 32x32 RGB (reference get_svhn_loaders,
        # odenet_mnist/data.py:39-69); widen the stem unless overridden
        args.in_channels = 3
        logger.info("svhn: in_channels -> 3")
    image_shape = (28, 28, 1) if args.dataset == "mnist" else (32, 32, 3)

    solvers = parse_solver_dsl(args.solvers)
    model = build_model(
        "mnist", device=dev,
        generator=torch.Generator().manual_seed(args.seed),
        downsampling_method=args.downsampling_method,
        is_odenet=args.network == "odenet",
        activation_type=args.activation,
        in_channels=args.in_channels,
    )
    logger.info(f"Number of parameters: {count_parameters(model)}")

    if args.download:
        fetched = ensure_dataset(args.dataset, args.data_root)
        if fetched:
            args.data_root = fetched
    if args.data_root:
        if args.dataset == "svhn":
            from ..data import load_svhn

            train_ds = load_svhn(args.data_root, split="train")
            test_ds = load_svhn(args.data_root, split="test")
        else:
            train_ds = load_mnist(args.data_root, train=True)
            test_ds = load_mnist(args.data_root, train=False)
    elif args.fallback_dataset == "digits" and args.dataset == "mnist":
        from ..data import load_digits_dataset

        logger.warning("no --data_root: using sklearn handwritten digits")
        train_ds, test_ds = load_digits_dataset(seed=args.seed)
    else:
        logger.warning("no --data_root: falling back to synthetic data")
        train_ds = synthetic_dataset(args.synthetic_train_size, image_shape,
                                     seed=args.seed)
        test_ds = synthetic_dataset(args.synthetic_test_size, image_shape,
                                    seed=args.seed + 1)

    backend = data_backend("auto")
    logger.info(f"data backend: {backend}")
    crop = 4 if args.data_aug else 0

    def train_data(epoch):
        return batch_iterator(
            train_ds, args.batch_size, seed=args.seed + epoch,
            crop_padding=crop, backend=backend,
        )

    def eval_data():
        # keep the tail batch: eval covers every sample (reference MNIST
        # accuracy divides by len(dataset))
        return batch_iterator(
            test_ds, args.test_batch_size, shuffle=False, drop_last=False,
            backend=backend,
        )

    batches_per_epoch = len(train_ds) // args.batch_size
    sched = learning_rate_with_decay(
        args.lr, args.batch_size, batches_per_epoch,
        boundary_epochs=[60, 100, 140],
        decay_rates=[1, 0.1, 0.01, 0.001],
    )
    tx = make_optimizer(args.optim, sched, momentum=args.momentum,
                        weight_decay=args.weight_decay,
                        nonfinite_backoff=args.nan_backoff)

    config = {"args": vars(args), "solvers": args.solvers, "model": "mnist"}
    if args.train_solver_params:
        return _fit_with_trainable_solvers(model, solvers, tx, args, logger,
                                           train_data, eval_data, config)
    return fit(model, solvers, tx, args, logger, train_data, eval_data,
               test_data_factory=eval_data, config=config)


def _check_solver_training_flags(args) -> None:
    """The JAX runner's refusals of ``--train_solver_params``."""
    if getattr(args, "mesh", None):
        raise ValueError(
            "--mesh is not supported with --train_solver_params "
            "(the joint solver-parameter loop is single-device)")
    if args.integration_method != "backprop":
        raise ValueError(
            "--train_solver_params needs discretize-then-optimize "
            "gradients (the continuous adjoint treats the tableau as the "
            "integration method: u/v get no gradient; ops/adjoint.py)")
    if args.profile_dir:
        raise ValueError(
            "--profile_dir is not supported with --train_solver_params "
            "(the joint solver-parameter loop has no trace window); "
            "profile the frozen-solver step instead")


def _fit_with_trainable_solvers(model, solvers, tx, args, logger,
                                train_data, eval_data, config):
    """The joint (network, solver u/v) loop of the JAX runner: SGD at
    ``--lr_uv`` on u/v, per-epoch loss, accuracy and u in the log and in
    ``metrics.jsonl``, and the final state in ``save_dir/solver_trained``.
    Returns the final ``SolverTrainState``."""
    dev = model.device
    solver_tx = make_optimizer("sgd", args.lr_uv)
    opts = build_solver_options(args)
    attack_cfg = AttackConfig(
        mode=args.adv_training_mode, eps=args.eps_adv_training,
        pgd_lr=args.pgd_lr_training, pgd_niter=args.pgd_niter_training,
    )
    step = make_solver_train_step(model, tx, solver_tx, solvers, opts,
                                  attack_cfg=attack_cfg)
    generator = torch.Generator().manual_seed(args.seed)
    ts = create_solver_train_state(model, tx, solver_tx, solvers)
    mlog = MetricsLogger(args.save_dir, config=config) if args.save_dir \
        else None
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" \
        else (lambda: None)
    for epoch in range(args.nepochs):
        losses = []
        sync()
        t_epoch = time.perf_counter()
        for x, y in device_batches(train_data(epoch), dev, args.prefetch):
            ts, m = step(ts, x, y.long(), generator)
            losses.append(m["loss"])  # read back once, at the epoch's end
        losses = torch.stack(losses).tolist() if losses else []
        batch_time = (time.perf_counter() - t_epoch) / max(len(losses), 1)
        cur = solvers_from_state(solvers, ts.solver_params)
        acc = accuracy(model, cur, opts, eval_data(), generator=generator)
        us = [f"{float(s.u):.4f}" if s.u is not None else "-" for s in cur]
        logger.info(f"epoch {epoch} | loss {np.mean(losses):.4f} | acc "
                    f"{acc:.4f} | u = {us}")
        if mlog:
            rec = {"epoch": epoch, "train_loss": float(np.mean(losses)),
                   "accuracy": float(acc), "batch_time": batch_time}
            for i, s in enumerate(cur):
                if s.u is not None:
                    rec[f"solver{i}_u"] = float(s.u)
                if s.v is not None:
                    rec[f"solver{i}_v"] = float(s.v)
            mlog.log(rec, step=ts.step)
    if mlog:
        mlog.close()
    if args.save_dir:
        save_checkpoint(os.path.join(args.save_dir, "solver_trained"), ts,
                        config)
    return ts


if __name__ == "__main__":
    main()
