"""Shared runner engine: the epoch loop and the multi-regime validation
(port of runners/common.py).

  * per iteration: one train step (smoothing -> attack -> update) on a
    batch the prefetch has already copied to the card;
  * per epoch: for each mode in ``--val_solver_modes``, 'standalone' (the
    accuracy of each solver, a ``best_solver_<i>`` checkpoint when it
    improves) or 'switch'/'ensemble' (one accuracy under that regime, a
    ``best_<mode>`` checkpoint); the adversarial test under
    ``--adv_testing_mode``; the ``last`` checkpoint, written on a
    background thread;
  * the losses stay on the card until the epoch ends, so no step waits on
    a readback; ``metrics.jsonl`` gets the config line and the per-epoch
    records of the JAX runner.

Train steps run in the run's ``--precision``; validation and the
adversarial test evaluate in f32 whatever the flag, as the JAX runner
does.

Randomness: one CPU ``torch.Generator`` seeded with ``--seed`` serves the
steps, the regime draws of validation and the adversarial test's starts;
the initial weights come from ``build_model``'s generator, which the
runners seed with ``--seed`` too (the JAX runner's initial weights come
from its key; the two frameworks draw differently, so a run that must
start from given weights resumes from a checkpoint holding them).

Flags that raise: ``--mesh``, ``--pp_microbatches`` and the multi-host
flags (ROADMAP A21) and ``--compiler_option`` (no counterpart: the port
has no XLA compiler).  ``--download`` fetches the dataset into
``--data_root`` (``data/download.py::ensure_dataset``) and falls back to
the offline datasets where the fetch fails, as the JAX runners do.
``--integration_method adjoint`` reaches the train step, which
differentiates the ODE blocks by the continuous adjoint.  ``--unroll`` is a compile-time hint of the JAX scan; the port's
step loop is a Python loop, so it changes nothing, and the runner says so
in its log.
"""
from __future__ import annotations

import os
import time
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from ..backend import resolve_device
from ..data.prefetch import prefetch_to_device
from ..models.api import Model
from ..ops.regimes import SolverOptions
from ..ops.solver import ParametricSolver
from ..training import profiling
from ..training.checkpoint import (
    restore_checkpoint,
    save_checkpoint,
    wait_for_checkpoints,
)
from ..training.evaluate import (
    accuracy,
    adversarial_accuracy,
    make_adversarial_predict,
)
from ..training.logging import MetricsLogger
from ..training.metrics import nfe_per_forward
from ..training.optimizers import make_optimizer
from ..training.schedules import constant_lr, cyclic_momentum
from ..training.train import (
    AttackConfig,
    LossConfig,
    NoiseConfig,
    TrainState,
    create_train_state,
    make_eval_step,
    make_train_step,
)

__all__ = [
    "device_batches",
    "fit",
    "validate",
    "bool_flag",
    "build_solver_options",
    "parse_num_blocks",
    "optimizer_from_saved_args",
    "add_multihost_flags",
    "add_device_flag",
    "check_unported_flags",
    "compute_dtype_of",
]


def add_multihost_flags(p):
    """The JAX runners' multi-host flags; each raises (ROADMAP A21)."""
    p.add_argument("--coordinator", type=str, default=None,
                   help="multi-host coordinator address (ROADMAP A21: "
                        "raises)")
    p.add_argument("--num_hosts", type=int, default=None,
                   help="processes of a multi-host run (ROADMAP A21: "
                        "raises)")
    p.add_argument("--process_id", type=int, default=None,
                   help="this process's rank (ROADMAP A21: raises)")
    return p


def add_device_flag(p):
    """The port's one flag of its own."""
    p.add_argument("--device", type=str, default=None,
                   help="torch device; the default is the CUDA card (the "
                        "run raises without one); 'cpu' runs the plain "
                        "PyTorch versions")
    return p


def check_unported_flags(args) -> None:
    """Raise on every flag the port does not run, naming its ROADMAP
    label (or why it has none)."""
    def label(what, lab):
        raise NotImplementedError(f"{what} is not ported yet (ROADMAP {lab})")

    if getattr(args, "mesh", None):
        label("--mesh (sharded training)", "A21")
    if getattr(args, "pp_microbatches", 0):
        label("--pp_microbatches (pipeline parallelism)", "A21")
    for flag in ("coordinator", "num_hosts", "process_id"):
        if getattr(args, flag, None) is not None:
            label(f"--{flag} (multi-host training)", "A21")
    if getattr(args, "compiler_option", None):
        raise ValueError(
            "--compiler_option has no counterpart in the PyTorch port (it "
            "forwards XLA compiler flags; the port compiles no XLA "
            "program): drop the flag")


def compute_dtype_of(precision: str) -> Optional[torch.dtype]:
    """The compute dtype of a ``--precision`` value."""
    return torch.bfloat16 if precision == "bf16" else None


def bool_flag(s: str) -> bool:
    """Boolean CLI operand in the reference's ``type=eval`` style
    (``--data_aug True``): lowercase spellings and 1/0 parse too, anything
    else is an argparse usage error."""
    v = {"true": True, "false": False, "1": True, "0": False}.get(
        str(s).strip().lower()
    )
    if v is None:
        raise ValueError(f"expected True/False, got {s!r}")
    return v


def parse_num_blocks(nb):
    """``--num_blocks`` registry override -> tuple of (res, ode) pairs,
    from the CLI string ``"a,b;c,d"`` or a parsed sequence (as a sidecar
    stores it): the one parser of the training CLI and every restore
    path."""
    if isinstance(nb, str):
        try:
            parsed = tuple(
                tuple(int(v) for v in stage.split(","))
                for stage in nb.strip().split(";")
            )
        except ValueError:
            raise ValueError(
                f"--num_blocks: expected 'a,b;c,d' (ints, ';'-separated "
                f"(res, ode) stage pairs), got {nb!r}"
            ) from None
    else:
        parsed = tuple(tuple(int(v) for v in stage) for stage in nb)
    if not all(len(stage) == 2 for stage in parsed):
        raise ValueError(
            f"--num_blocks: every stage needs exactly (res, ode) — "
            f"got {nb!r}"
        )
    return parsed


def optimizer_from_saved_args(margs: dict):
    """The optimizer a checkpoint was trained with, from its saved args:
    the one place that knows how the flags map onto the optimizer state's
    layout (decay, clipping, accumulation, backoff, the momentum trace of
    a cyclic momentum), so every restore path builds a matching template.
    The lr value does not shape the state; a constant stands in."""
    momentum = margs.get("momentum", 0.9)
    if (margs.get("optim", "sgd") in ("sgd", "rmsprop")
            and margs.get("cycle_momentum", False)):
        momentum = cyclic_momentum(
            margs.get("step_size_up", 3186),
            margs.get("cyclic_lr_mode", "triangular2"),
            margs.get("base_momentum", 0.8),
            margs.get("max_momentum", 0.9),
        )
    return make_optimizer(
        margs.get("optim", "sgd"), constant_lr(0.1), momentum=momentum,
        weight_decay=margs.get("weight_decay", 0.0),
        grad_clip=margs.get("grad_clipping_threshold"),
        every_k=margs.get("zero_grad_every", 1),
        nonfinite_backoff=margs.get("nan_backoff"),
    )


def build_solver_options(args) -> SolverOptions:
    return SolverOptions(
        solver_mode=getattr(args, "solver_mode", "standalone"),
        switch_probs=getattr(args, "switch_probs", None),
        ensemble_prob=getattr(args, "ensemble_prob", 1.0),
        ensemble_weights=getattr(args, "ensemble_weights", None),
    )


def validate(
    model: Model,
    ts: TrainState,
    solvers: Sequence[ParametricSolver],
    args,
    eval_data_factory: Callable,
    generator: torch.Generator,
    logger,
    best: dict,
    save_dir: Optional[str],
    config: dict,
    epoch: int,
    predict_cache: Optional[dict] = None,
):
    """Run every requested validation mode; update ``best`` and write
    checkpoints on improvement (train_validate.py:250-342 semantics).
    ``predict_cache`` (owned by the caller) keeps the predictors across
    epochs."""
    cache = predict_cache if predict_cache is not None else {}

    def get_predict(tag, solvers_, opts_):  # f32, as the JAX runner
        if tag not in cache:
            cache[tag] = make_eval_step(model, solvers_, opts_)
        return cache[tag]

    for mode in getattr(args, "val_solver_modes", ["standalone"]):
        if mode == "standalone":
            opts = SolverOptions(solver_mode="standalone")
            for i, s in enumerate(solvers):
                acc = accuracy(model, [s], opts, eval_data_factory(),
                               predict=get_predict(f"standalone_{i}", [s],
                                                   opts))
                logger.info(
                    f"epoch {epoch} | standalone solver {i} "
                    f"(u0={s.u0}) acc {acc:.4f}"
                )
                tag = f"standalone_{i}"
                if acc > best.get(tag, 0.0):
                    best[tag] = acc
                    if save_dir:
                        save_checkpoint(
                            os.path.join(save_dir, f"best_solver_{i}"),
                            ts, {**config, "val_acc": acc, "solver_id": i},
                            block=False,
                        )
        elif mode in ("switch", "ensemble"):
            opts = SolverOptions(
                solver_mode=mode,
                switch_probs=getattr(args, "switch_probs", None),
                ensemble_prob=getattr(args, "ensemble_prob", 1.0),
                ensemble_weights=getattr(args, "ensemble_weights", None),
            )
            acc = accuracy(model, solvers, opts, eval_data_factory(),
                           predict=get_predict(mode, solvers, opts),
                           generator=generator)
            logger.info(f"epoch {epoch} | {mode} acc {acc:.4f}")
            if acc > best.get(mode, 0.0):
                best[mode] = acc
                if save_dir:
                    save_checkpoint(
                        os.path.join(save_dir, f"best_{mode}"),
                        ts, {**config, "val_acc": acc},
                        block=False,
                    )
        else:
            raise ValueError(f"unknown val solver mode {mode!r}")
    return best


def device_batches(batches, device: torch.device, prefetch: int):
    """(x, y) tensors on ``device``: through the prefetch (pinned memory,
    side stream, producer thread) when ``prefetch`` > 0."""
    if prefetch:
        return prefetch_to_device(batches, size=prefetch, device=device,
                                  thread=True)
    return ((torch.as_tensor(x).to(device), torch.as_tensor(y).to(device))
            for x, y in batches)


def fit(
    model: Model,
    solvers: Sequence[ParametricSolver],
    tx,
    args,
    logger,
    train_data_factory: Callable,  # (epoch) -> iterator of (x, y)
    eval_data_factory: Callable,  # () -> iterator
    test_data_factory: Optional[Callable] = None,
    config: Optional[dict] = None,
) -> TrainState:
    """The end-to-end training driver of the MNIST and CIFAR CLIs, on the
    model's device."""
    dev = resolve_device(model.device)
    generator = torch.Generator().manual_seed(getattr(args, "seed", 502))
    ts = create_train_state(model, tx)

    save_dir = getattr(args, "save_dir", None)
    if getattr(args, "resume", False) and save_dir:
        last_dir = os.path.join(save_dir, "last")
        try:
            ts, _ = restore_checkpoint(last_dir, ts)
            logger.info(f"resumed from {last_dir} at step {ts.step}")
        except FileNotFoundError:
            logger.info("no checkpoint to resume from; starting fresh")

    if getattr(args, "unroll", 1) != 1:
        logger.info(f"--unroll {args.unroll}: no effect in the PyTorch "
                    "port (its RK step loop is a Python loop)")
    solver_options = build_solver_options(args)
    attack_cfg = AttackConfig(
        mode=getattr(args, "adv_training_mode", "clean"),
        eps=getattr(args, "eps_adv_training", 8 / 255),
        alpha=getattr(args, "fgsm_random_step_size_training", 10 / 255),
        pgd_lr=getattr(args, "pgd_lr_training", 2 / 255),
        pgd_niter=getattr(args, "pgd_niter_training", 7),
        mean=getattr(args, "data_mean", None),
        std=getattr(args, "data_std", None),
    )
    noise_cfg = NoiseConfig(
        noise_type=getattr(args, "noise_type", None),
        sigma=getattr(args, "noise_sigma", 0.001),
        prob=getattr(args, "noise_prob", 0.0),
        minimize_rk2_error=getattr(args, "minimize_rk2_error", False),
    )
    loss_cfg = LossConfig(
        ss_loss=getattr(args, "ss_loss", False),
        ss_loss_reg=getattr(args, "ss_loss_reg", 0.1),
        data_noise_std=getattr(args, "data_noise_std", 0.0),
    )
    compute_dtype = compute_dtype_of(getattr(args, "precision", "f32"))
    step = make_train_step(
        model, tx, solvers, solver_options, attack_cfg, noise_cfg, loss_cfg,
        compute_dtype=compute_dtype,
        skip_nonfinite=getattr(args, "skip_nonfinite", False),
        integration_method=getattr(args, "integration_method", "backprop"),
    )
    config = dict(config or {})
    logger.info(
        "NFE/forward: %s",
        nfe_per_forward(solvers, solver_options, _count_ode_blocks(model)),
    )

    best: dict = {}
    predict_cache: dict = {}
    prefetch = getattr(args, "prefetch", 2)
    mlog = MetricsLogger(save_dir, config=config) if save_dir else None
    profile_dir = getattr(args, "profile_dir", None)
    profiling_on = False
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" \
        else (lambda: None)
    try:
        for epoch in range(getattr(args, "nepochs", 1)):
            batches = device_batches(train_data_factory(epoch), dev,
                                      prefetch)
            losses = []
            skipped = []
            n_batches = 0
            t_epoch = time.perf_counter()
            try:
                for x, y in batches:
                    ts, m = step(ts, x, y.long(), generator)
                    losses.append(m["loss"])
                    if "skipped_nonfinite" in m:
                        skipped.append(m["skipped_nonfinite"])
                    n_batches += 1
                    if profile_dir and epoch == 0:
                        # steady-state steps 1-3: step 0 builds the kernels
                        if n_batches == 1:
                            sync()
                            profiling.start_trace(profile_dir)
                            profiling_on = True
                        elif n_batches == 4 and profiling_on:
                            sync()
                            profiling.stop_trace()
                            profiling_on = False
                            logger.info(f"profiler trace (steps 1-3) in "
                                        f"{profile_dir}")
            finally:
                if profiling_on:
                    # a short epoch or an error inside the window: keep
                    # what was captured
                    sync()
                    profiling.stop_trace()
                    profiling_on = False
                    logger.info(f"profiler trace in {profile_dir}")
            # one readback per epoch
            losses = torch.stack(losses).tolist() if losses else []
            skipped = float(torch.stack(skipped).sum()) if skipped else 0.0
            if not n_batches:
                logger.warning(
                    f"epoch {epoch}: no training batches "
                    f"(dataset smaller than batch_size with drop_last?)"
                )
            else:
                epoch_bt = (time.perf_counter() - t_epoch) / n_batches
                logger.info(
                    f"epoch {epoch} | train loss {np.mean(losses):.4f} | "
                    f"batch time {epoch_bt:.3f}s"
                    + (f" | skipped_nonfinite {skipped:.0f}" if skipped
                       else "")
                )
                if mlog:
                    mlog.log(
                        {"epoch": epoch,
                         "train_loss": float(np.mean(losses)),
                         "batch_time": epoch_bt,
                         **{k: float(v) for k, v in m.items()},
                         "epoch_skipped_nonfinite": skipped},
                        step=ts.step,
                    )
            best = validate(
                model, ts, solvers, args, eval_data_factory, generator,
                logger, best, save_dir, config, epoch,
                predict_cache=predict_cache,
            )
            if mlog and best:
                mlog.log(
                    {"epoch": epoch,
                     **{f"best_{tag}": float(v) for tag, v in best.items()}},
                    step=ts.step,
                )
            adv_mode = getattr(args, "adv_testing_mode", "clean")
            if adv_mode != "clean" and test_data_factory is not None:
                test_attack = AttackConfig(
                    mode="fgsm" if adv_mode == "fgsm" else "at",
                    eps=getattr(args, "eps_adv_testing", 8 / 255),
                    pgd_lr=getattr(args, "pgd_lr_testing", 2 / 255),
                    pgd_niter=getattr(args, "pgd_niter_testing", 7),
                    mean=getattr(args, "data_mean", None),
                    std=getattr(args, "data_std", None),
                )
                if "adv_predict" not in predict_cache:  # f32, as JAX
                    predict_cache["adv_predict"] = make_adversarial_predict(
                        model, solvers, solver_options, test_attack)
                adv_acc = adversarial_accuracy(
                    model, solvers, solver_options, test_data_factory(),
                    test_attack, generator,
                    predict=predict_cache["adv_predict"],
                )
                logger.info(
                    f"epoch {epoch} | adversarial test acc {adv_acc:.4f}")
                if mlog:
                    mlog.log({"epoch": epoch, "adv_test_acc": adv_acc},
                             step=ts.step)
            if save_dir:
                # the copy to the host happens here; the write overlaps
                # the next epoch
                save_checkpoint(os.path.join(save_dir, "last"), ts, config,
                                block=False)
    finally:
        if save_dir:
            wait_for_checkpoints()
    if mlog:
        mlog.log({"best": max(best.values()) if best else 0.0}, step=ts.step)
        mlog.close()
    return ts


def _count_ode_blocks(model: Model) -> int:
    cfg = model.cfg
    if hasattr(cfg, "num_blocks"):
        return sum(n_ode for _, n_ode in cfg.num_blocks)
    return 1 if getattr(cfg, "is_odenet", True) else 0
