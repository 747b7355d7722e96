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

``--mesh data=N`` trains data-parallel over N processes, one device each
(``parallel/mesh.py``): every rank iterates the same seeded batch stream
and keeps its contiguous 1/N of each global batch, the step reduces the
gradients over the ranks, validation and the adversarial test run on each
process over the full test set, as JAX's do, and rank 0 alone writes the
checkpoints and ``metrics.jsonl`` while the others wait at a barrier at
each epoch's end.  ``--coordinator``, ``--num_hosts`` and ``--process_id``
form the process group (``setup_multihost``, JAX's validation and
messages); the backend is NCCL when every rank owns a CUDA device of its
own, gloo otherwise.  A ``model``, ``sp`` or ``pp`` axis
(``make_parallel_train_step(model_axis=, spatial_axis=)``, the model's
``PipelineConfig`` with ``--pp_microbatches``) runs with JAX's checks and
messages (validation and the adversarial test run on the same axes: the
tp forward, the pipelined stacks, each batch's rows split over sp); as
JAX's multi-host runner refuses them, the port refuses them when the
ranks span more than one host.  The flag that raises:
``--compiler_option`` (no counterpart: the port has no XLA compiler).  ``--download`` fetches the dataset into
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
from ..models.api import Model, make_cifar_model
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
from ..parallel.mesh import (
    barrier,
    batch_sharding,
    initialize_distributed,
    make_mesh,
    make_parallel_train_step,
    num_hosts,
    rank as process_rank,
    world_size,
)
from ..parallel.pipeline import PipelineConfig

__all__ = [
    "device_batches",
    "fit",
    "validate",
    "bool_flag",
    "build_solver_options",
    "parse_num_blocks",
    "optimizer_from_saved_args",
    "add_multihost_flags",
    "setup_multihost",
    "parse_mesh_spec",
    "add_device_flag",
    "check_unported_flags",
    "compute_dtype_of",
]


def add_multihost_flags(p):
    """The multi-host flags of the training CLIs: they form the process
    group of a data-parallel run (``setup_multihost``)."""
    p.add_argument("--coordinator", type=str, default=None,
                   help="process-group coordinator address (host:port, a "
                        "free port on rank 0's host); with --num_hosts > "
                        "1, every process passes the same value")
    p.add_argument("--num_hosts", type=int, default=None,
                   help="total number of processes in the run, one device "
                        "each (with --coordinator alone, WORLD_SIZE and "
                        "RANK are read from the environment, as torchrun "
                        "sets them)")
    p.add_argument("--process_id", type=int, default=None,
                   help="this process's rank in [0, num_hosts)")
    return p


def setup_multihost(args):
    """Form the process group from the CLI flags.  MUST run before any
    device use.  Returns this process's rank (0 when single-host); sets
    ``args.device`` to the rank's device when the flag was not given."""
    if not (args.coordinator or (args.num_hosts or 0) > 1
            or args.process_id is not None):
        return 0
    # Valid flag shapes: --coordinator alone (WORLD_SIZE and RANK come
    # from the environment), or the full triple.  Anything else would
    # leave a rank waiting for peers that never come — reject with the
    # missing flag named (the messages are the JAX runner's).
    if args.coordinator is None:
        given = [n for n, v in (("--num_hosts", args.num_hosts),
                                ("--process_id", args.process_id))
                 if v is not None]
        raise ValueError(
            f"{' '.join(given)} given without --coordinator; pass "
            f"--coordinator too (auto-detecting TPU pod/Slurm envs), or "
            f"the full --coordinator/--num_hosts/--process_id triple")
    if (args.num_hosts is None) != (args.process_id is None):
        missing = ("--process_id" if args.process_id is None
                   else "--num_hosts")
        raise ValueError(
            f"--num_hosts/--process_id must be passed together "
            f"(or both omitted for auto-detection); missing: {missing}")
    if not getattr(args, "mesh", None):
        raise ValueError(
            "multi-host training needs --mesh (e.g. --mesh data=-1 to "
            "span every device of every host)")
    dev = initialize_distributed(args.coordinator, args.num_hosts,
                                 args.process_id,
                                 device=getattr(args, "device", None))
    args.device = str(dev)
    return process_rank()


def parse_mesh_spec(spec: Optional[str]) -> Optional[dict]:
    """Parse ``--mesh`` strings like ``"data=8"`` / ``"data=4,model=2"`` /
    ``"data=2,sp=2"`` into an axis-size dict (None/empty -> None).
    ``data`` is required; ``-1`` sizes mean "all remaining devices"
    (resolved by ``parallel.make_mesh``)."""
    if not spec:
        return None
    axes = {}
    known = ("data", "model", "sp", "pp")
    for part in spec.split(","):
        name, _, size = part.partition("=")
        name = name.strip()
        if not name or not size:
            raise ValueError(
                f"bad --mesh entry {part!r}; expected axis=size")
        if name not in known:
            # an unrecognized axis would silently replicate over its
            # devices (only these names are wired into the sharded step)
            raise ValueError(
                f"unknown mesh axis {name!r}; supported: {known}")
        n = int(size)
        if n < 1 and n != -1:
            raise ValueError(
                f"mesh axis {name!r} size must be >= 1 (or -1 for "
                f"'all remaining devices'), got {n}")
        axes[name] = n
    if "data" not in axes:
        raise ValueError(f"--mesh must include a data axis, got {spec!r}")
    return axes


def add_device_flag(p):
    """The port's one flag of its own."""
    p.add_argument("--device", type=str, default=None,
                   help="torch device; the default is the CUDA card (the "
                        "run raises without one); 'cpu' runs the plain "
                        "PyTorch versions")
    return p


def check_unported_flags(args) -> None:
    """Raise on every flag the port does not run, saying why."""
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
    spatial=None,
):
    """Run every requested validation mode; update ``best`` and write
    checkpoints on improvement (train_validate.py:250-342 semantics).
    ``predict_cache`` (owned by the caller) keeps the predictors across
    epochs; ``spatial`` (the mesh's sp axis) splits each batch's rows."""
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
                                                   opts), spatial=spatial)
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
                           generator=generator, spatial=spatial)
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


def device_batches(batches, device: torch.device, prefetch: int,
                   sharding=None):
    """(x, y) tensors on ``device``: through the prefetch (pinned memory,
    side stream, producer thread) when ``prefetch`` > 0; with ``sharding``
    (``parallel.batch_sharding``) each batch cut to this rank's rows on
    the host first."""
    if prefetch:
        return prefetch_to_device(batches, size=prefetch, device=device,
                                  thread=True, sharding=sharding)
    cut = (lambda b: b) if sharding is None else sharding.local
    return (tuple(torch.as_tensor(a).to(device) for a in cut((x, y)))
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
    mesh_spec = parse_mesh_spec(getattr(args, "mesh", None))
    mesh = make_mesh(mesh_spec) if mesh_spec else None
    if mesh_spec and "pp" in mesh_spec:
        model = _pipeline_model(model, mesh, args, logger)
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
    # Data parallelism: every process runs this same fit() in lockstep;
    # rank r keeps its contiguous 1/N of each (identically seeded, hence
    # identically ordered) global batch, so the step sees the global batch
    # of a one-process run
    sharding = spatial = None
    if mesh_spec:
        logger.info(f"mesh: {mesh.shape} over {mesh.size} devices"
                    + (f", backend {torch.distributed.get_backend()}"
                       if torch.distributed.is_initialized() else ""))
        if getattr(args, "batch_size", 0) % mesh.shape["data"]:
            raise ValueError(
                f"batch_size {args.batch_size} must be divisible by the "
                f"data axis size ({mesh.shape['data']})"
            )
        step = make_parallel_train_step(
            step, mesh, ts, data_axis="data",
            model_axis="model" if "model" in mesh_spec else None,
            spatial_axis="sp" if "sp" in mesh_spec else None)
        sharding = batch_sharding(mesh)
        spatial = mesh.shard("sp") if "sp" in mesh_spec else None
    nproc, rank = world_size(), process_rank()
    multihost = nproc > 1
    if multihost:
        if not mesh_spec:
            raise ValueError(
                "multi-host training needs --mesh (e.g. data=-1)")
        if num_hosts() > 1 and any(ax != "data" for ax in mesh_spec):
            raise ValueError(
                "multi-host runners shard the data axis only; model/sp/pp "
                "meshes are single-host (their param/halo placements are "
                "not wired through host_local_batch_to_global)")
        if getattr(args, "batch_size", 0) % nproc:
            raise ValueError(
                f"batch_size {args.batch_size} must be divisible by the "
                f"process count ({nproc})")
    config = dict(config or {})
    logger.info(
        "NFE/forward: %s",
        nfe_per_forward(solvers, solver_options, _count_ode_blocks(model)),
    )

    best: dict = {}
    predict_cache: dict = {}
    prefetch = getattr(args, "prefetch", 2)
    # rank 0 alone appends to metrics.jsonl and writes the checkpoints
    mlog = (MetricsLogger(save_dir, config=config)
            if save_dir and rank == 0 else None)
    profile_dir = getattr(args, "profile_dir", None)
    profiling_on = False
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" \
        else (lambda: None)
    try:
        for epoch in range(getattr(args, "nepochs", 1)):
            batches = device_batches(train_data_factory(epoch), dev,
                                      prefetch, sharding)
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
                predict_cache=predict_cache, spatial=spatial,
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
                    predict=predict_cache["adv_predict"], spatial=spatial,
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
            if multihost:
                # rank 0's saves are committed (a multi-rank save blocks)
                barrier()
    finally:
        if save_dir:
            wait_for_checkpoints()
    if multihost:
        barrier()
    if mlog:
        mlog.log({"best": max(best.values()) if best else 0.0}, step=ts.step)
        mlog.close()
    return ts


def _pipeline_model(model: Model, mesh, args, logger) -> Model:
    """The model rebuilt (``make_cifar_model(pipeline=)``, its params and
    state copied) so that its same-shape ODE-block stacks route through
    GPipe over the mesh's pp axis (layers whose block count does not
    divide the stage count, and the ss-loss/adjoint paths, fall back to
    the sequential loop), with the JAX runner's checks and messages."""
    if not hasattr(model.cfg, "num_blocks"):
        raise ValueError(
            "--mesh pp= needs a cifar-family model (stacked "
            "same-shape ODE blocks); the MNIST net has one block")
    pcfg = PipelineConfig(mesh=mesh, axis="pp",
                          n_microbatches=getattr(args, "pp_microbatches", 0),
                          batch_axis="data")
    batch = getattr(args, "batch_size", 0)
    if batch % pcfg.microbatches or (batch // pcfg.microbatches) \
            % mesh.shape["data"]:
        raise ValueError(
            f"batch_size {args.batch_size} must split into "
            f"{pcfg.microbatches} microbatches each divisible by "
            f"the data axis size ({mesh.shape['data']})")
    if not any(n_ode > 1 and n_ode % pcfg.stages == 0
               for _, n_ode in model.cfg.num_blocks):
        logger.warning(
            f"--mesh pp={pcfg.stages}: no layer in "
            f"num_blocks={list(model.cfg.num_blocks)} has an "
            f"ODE-block stack divisible into {pcfg.stages} stages; "
            "the pp devices are reserved but every layer runs "
            "sequentially (use --num_blocks to deepen the stacks, "
            "e.g. premetanode18/34)")
    piped = make_cifar_model(model.cfg, model.device, pipeline=pcfg,
                             init_scheme=getattr(args, "init", None))
    piped.load_state_dict(model.state_dict())
    return piped


def _count_ode_blocks(model: Model) -> int:
    cfg = model.cfg
    if hasattr(cfg, "num_blocks"):
        return sum(n_ode for _, n_ode in cfg.num_blocks)
    return 1 if getattr(cfg, "is_odenet", True) else 0
