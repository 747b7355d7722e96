"""Robust-accuracy sweep CLI (port of runners/attacks_runner.py; parity with
odenet_mnist/attacks_runner.py + attacks_utils.py run_attack).

Globs checkpoint directories, rebuilds model, solvers and optimizer from
each checkpoint's sidecar (the reference rebuilds solvers from
``model_args.solvers[0]``, attacks_runner.py:65), restores the state,
evaluates a (mode x epsilon) attack grid, and writes a CSV of robust
accuracies (``checkpoint, mode, eps, accuracy``, as the JAX runner's):

  python -m neural_ode_metasolver_tpu_torch.runners.attacks_runner \
      --checkpoints_glob "./experiment_cifar/best_*" \
      --modes clean,fgsm,at --epsilons 0.01,0.03,0.1 --output_csv accs.csv

``--ensemble`` also evaluates all matched checkpoints as one
softmax-averaged model ensemble, attacked by FGSM2Ensemble.  Every
checkpoint is evaluated in f32, as the JAX runner does, whatever
``--precision`` it was trained in.  The log goes to ``attacks_runner.log``
beside the CSV.
``--device cpu`` runs on the CPU; without a card and without it the run
raises.
"""
from __future__ import annotations

import argparse
import csv
import glob
import itertools
import json
import os

import torch

from ..backend import resolve_device
from ..data import (
    CIFAR10_MEAN,
    CIFAR10_STD,
    batch_iterator,
    load_cifar10,
    load_mnist,
    synthetic_dataset,
)
from ..models.api import build_model
from ..ops import SolverOptions, parse_solver_dsl
from ..training import (
    AttackConfig,
    accuracy,
    accuracy_ensemble,
    adversarial_accuracy,
    adversarial_accuracy_ensemble,
    create_train_state,
    make_adversarial_predict,
    make_eval_step,
    restore_checkpoint,
)
from ..utils import fix_seeds, get_logger
from .cifar_runner import build_cifar_model
from .common import (
    add_device_flag,
    optimizer_from_saved_args,
)

# the args that fix an architecture: checkpoints ensemble only when equal
_ARCH_ARGS = ("network", "in_planes", "in_channels", "downsampling_method",
              "num_blocks", "is_odenet", "normalization_resblock",
              "normalization_odeblock", "normalization_bn1",
              "param_normalization_resblock", "param_normalization_odeblock",
              "param_normalization_bn1", "activation", "activation_resblock",
              "activation_odeblock", "activation_bn1")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--checkpoints_glob", type=str, required=True)
    p.add_argument("--modes", type=lambda s: s.split(","),
                   default=["clean", "fgsm", "at"])
    p.add_argument("--epsilons",
                   type=lambda s: [float(i) for i in s.split(",")],
                   default=[8 / 255])
    p.add_argument("--pgd_lr", type=float, default=2 / 255)
    p.add_argument("--pgd_niter", type=int, default=7)
    p.add_argument("--data_root", type=str, default=None)
    p.add_argument("--batch_size", type=int, default=256)
    p.add_argument("--max_batches", type=int, default=None,
                   help="cap eval batches (quick sweeps)")
    p.add_argument("--ensemble", action="store_true",
                   help="ALSO evaluate all matched checkpoints jointly as "
                        "a softmax-averaged model ensemble, attacked with "
                        "FGSM2Ensemble (reference run_attack2ensemble, "
                        "attacks_utils.py:68)")
    p.add_argument("--output_csv", type=str, default="robust_accuracy.csv")
    p.add_argument("--seed", type=int, default=502)
    add_device_flag(p)
    return p.parse_args(argv)


def _model_from_config(cfg, device):
    """(model, mean, std, image shape) of a checkpoint's sidecar."""
    margs = cfg.get("args", {})
    if cfg["model"] == "mnist":
        in_ch = margs.get("in_channels", 1)
        model = build_model(
            "mnist", device=device,
            downsampling_method=margs.get("downsampling_method", "conv"),
            is_odenet=margs.get("network", "odenet") == "odenet",
            in_channels=in_ch,
        )
        return model, None, None, (28, 28, in_ch)
    model = build_cifar_model({**margs, "network": cfg["model"]}, device)
    return model, CIFAR10_MEAN, CIFAR10_STD, (32, 32, 3)


def main(argv=None):
    """Returns the CSV's rows."""
    args = parse_args(argv)
    dev = resolve_device(args.device)
    seed = fix_seeds(args.seed)
    logger = get_logger(
        os.path.join(os.path.dirname(os.path.abspath(args.output_csv)),
                     "attacks_runner.log"), name="attacks")

    def row_generator(i: int) -> torch.Generator:
        # one stream per row, like the JAX runner's fold_in(key, row)
        return torch.Generator().manual_seed(seed * 1_000_003 + i)

    def batches(ds, mean, std):
        it = batch_iterator(ds, args.batch_size, shuffle=False,
                            drop_last=False, mean=mean, std=std)
        if args.max_batches:
            it = itertools.islice(it, args.max_batches)
        return it

    rows = []
    members_info = []  # (arch key, member, ds, mean, std)
    for base in sorted(glob.glob(args.checkpoints_glob)):
        # each checkpoint base dir holds step_XXXXXXXX subdirs
        step_dirs = sorted(glob.glob(os.path.join(base, "step_*")))
        if not step_dirs:
            continue
        with open(os.path.join(step_dirs[-1], "config.json")) as f:
            cfg = json.load(f)
        model, mean, std, shape = _model_from_config(cfg, dev)
        solvers = parse_solver_dsl(cfg["solvers"])
        margs = cfg.get("args", {})
        # the saved flags decide the optimizer state's layout
        template = create_train_state(model, optimizer_from_saved_args(margs))
        restore_checkpoint(base, template)

        if args.data_root:
            if cfg["model"] == "mnist":
                ds = load_mnist(args.data_root, train=False)
            else:
                ds = load_cifar10(args.data_root, train=False)
        else:
            ds = synthetic_dataset(1024, shape, seed=args.seed + 1)

        # evaluate under the regime the checkpoint was trained with
        opts = SolverOptions(
            solver_mode=margs.get("solver_mode", "standalone"),
            switch_probs=margs.get("switch_probs"),
            ensemble_prob=margs.get("ensemble_prob", 1.0),
            ensemble_weights=margs.get("ensemble_weights"),
        )
        for mode in args.modes:
            for eps in args.epsilons:
                gen = row_generator(len(rows))
                if mode == "clean":
                    acc = accuracy(
                        model, solvers, opts, batches(ds, mean, std),
                        predict=make_eval_step(model, solvers, opts),
                        generator=gen)
                else:
                    atk = AttackConfig(
                        mode="fgsm" if mode == "fgsm" else "at",
                        eps=eps, pgd_lr=args.pgd_lr,
                        pgd_niter=args.pgd_niter, mean=mean, std=std,
                    )
                    acc = adversarial_accuracy(
                        model, solvers, opts, batches(ds, mean, std), atk,
                        gen, predict=make_adversarial_predict(
                            model, solvers, opts, atk))
                logger.info(f"{base} | {mode} eps={eps:.4f} acc={acc:.4f}")
                rows.append({
                    "checkpoint": base, "mode": mode,
                    # clean rows carry no perturbation
                    "eps": 0.0 if mode == "clean" else eps,
                    "accuracy": acc,
                })
                if mode == "clean":
                    break  # eps is irrelevant for clean
        arch = (cfg["model"], tuple(sorted(
            (k, str(v)) for k, v in margs.items() if k in _ARCH_ARGS)))
        members_info.append((arch, (model, solvers, opts), ds, mean, std))

    if args.ensemble:
        if len(members_info) < 2:
            logger.warning("--ensemble needs >= 2 matched checkpoints")
        elif len({mi[0] for mi in members_info}) != 1:
            logger.warning("--ensemble skipped: checkpoints mix "
                           "architectures")
        else:
            _, _, ds, mean, std = members_info[-1]
            members = [mi[1] for mi in members_info]
            tag = f"ENSEMBLE({len(members)})"
            gen = row_generator(99991)
            acc = accuracy_ensemble(members, batches(ds, mean, std), gen)
            logger.info(f"{tag} | clean acc={acc:.4f}")
            rows.append({"checkpoint": tag, "mode": "ensemble_clean",
                         "eps": 0.0, "accuracy": acc})
            if any(m != "clean" for m in args.modes):
                for eps in args.epsilons:
                    adv = adversarial_accuracy_ensemble(
                        members, batches(ds, mean, std),
                        AttackConfig(mode="fgsm", eps=eps, mean=mean,
                                     std=std),
                        gen,
                    )
                    logger.info(f"{tag} | fgsm2ensemble eps={eps:.4f} "
                                f"acc={adv:.4f}")
                    rows.append({"checkpoint": tag,
                                 "mode": "ensemble_fgsm", "eps": eps,
                                 "accuracy": adv})

    with open(args.output_csv, "w", newline="") as f:
        writer = csv.DictWriter(
            f, fieldnames=["checkpoint", "mode", "eps", "accuracy"]
        )
        writer.writeheader()
        writer.writerows(rows)
    logger.info(f"wrote {len(rows)} rows to {args.output_csv}")
    return rows


if __name__ == "__main__":
    main()
