"""Local hyperparameter sweep driver (port of runners/sweep.py): the
egress-free replacement for the reference's wandb sweeps, over the port's
runners.

The reference drives sweeps by letting the wandb agent override solver DSL
tokens and the cyclic-LR endpoints in-process
(``examples/cifar10/train_and_attack.py:330-361``,
``update_solvers_with_sweep_params`` / ``set_max_base_lr``).  This runner
reproduces those exact override hooks from a local grid config: the cross
product of the configured values is enumerated, each combination is
applied to the base CLI args through the same token-level semantics, the
target runner's ``main`` (the port's ``mnist_runner`` or
``cifar_runner``) is invoked per run into its own ``save_dir``, and a
summary CSV collects each run's best validation accuracy from its
``metrics.jsonl``, with the JAX driver's columns.  A failing run is
recorded with its error and the sweep goes on.  It is host-only: the runs
use the card unless ``--device cpu`` is given (passed through to every
run).

Config file (JSON) — either a wandb-style ``{"parameters": {k: {"values":
[...]}}}`` block or a plain ``{k: [...]}`` mapping.  Recognized keys match
the reference's sweep surface: ``wnb_method``, ``wnb_parameterization``,
``wnb_n_steps``, ``wnb_u``, ``wnb_v`` (solver overrides), ``max_lr``,
``base_lr``, ``max_lr_reduction`` (LR overrides); any OTHER key is passed
through as ``--<key> <value>`` to the target runner.

  python -m neural_ode_metasolver_tpu_torch.runners.sweep \\
      --runner cifar --config sweep.json --sweep_dir runs/sweep1 -- \\
      --nepochs 2 --solvers rk2,u,8,-1,0.5,-1 --fallback_dataset synthetic
"""
from __future__ import annotations

import argparse
import csv
import itertools
import json
import os
from typing import Any, Dict, List, Optional, Sequence

__all__ = [
    "update_solvers_with_sweep_params",
    "set_max_base_lr",
    "expand_grid",
    "run_sweep",
    "main",
]

_SOLVER_KEYS = (
    "wnb_method", "wnb_parameterization", "wnb_n_steps", "wnb_u", "wnb_v",
)
_LR_KEYS = ("max_lr", "base_lr", "max_lr_reduction")


def update_solvers_with_sweep_params(
    solvers: List[List[str]], config: Dict[str, Any]
) -> None:
    """Token-level solver override, in place — exact semantics of
    ``train_and_attack.py:330-348`` (method/parameterization/n_steps by
    position, u/v by NEGATIVE position, None values skipped)."""
    for solver in solvers:
        if config.get("wnb_method") is not None:
            solver[0] = str(config["wnb_method"])
        if config.get("wnb_parameterization") is not None:
            solver[1] = str(config["wnb_parameterization"])
        if config.get("wnb_n_steps") is not None:
            solver[2] = str(config["wnb_n_steps"])
        if config.get("wnb_u") is not None:
            solver[-2] = str(config["wnb_u"])
        if config.get("wnb_v") is not None:
            solver[-1] = str(config["wnb_v"])


def set_max_base_lr(config: Dict[str, Any]) -> tuple:
    """(max_lr, base_lr) from the sweep config — exact 3-branch semantics
    of ``train_and_attack.py:350-361``."""
    max_lr = config.get("max_lr")
    base_lr = config.get("base_lr")
    if max_lr is not None and base_lr is not None:
        return max_lr, base_lr
    if max_lr is not None:
        reduction = config.get("max_lr_reduction")
        if reduction is None:
            raise ValueError(
                "max_lr without base_lr needs max_lr_reduction"
            )
        return max_lr, max_lr / reduction
    if base_lr is not None:
        return base_lr, base_lr
    raise ValueError("Either max_lr or base_lr should be defined")


def expand_grid(config: Dict[str, Any]) -> List[Dict[str, Any]]:
    """Cross product of a sweep config.  Accepts the wandb layout
    (``{"parameters": {k: {"values": [...]}}}`` with optional
    ``{"value": x}`` singletons) or a plain ``{k: list-or-scalar}``."""
    params = config.get("parameters", config)
    axes: Dict[str, List[Any]] = {}
    for k, spec in params.items():
        if isinstance(spec, dict):
            if "values" in spec:
                axes[k] = list(spec["values"])
            elif "value" in spec:
                axes[k] = [spec["value"]]
            else:
                raise ValueError(f"parameter {k!r} needs 'values' or 'value'")
        elif isinstance(spec, (list, tuple)):
            axes[k] = list(spec)
        else:
            axes[k] = [spec]
    keys = sorted(axes)
    return [
        dict(zip(keys, combo))
        for combo in itertools.product(*(axes[k] for k in keys))
    ]


def _zero_arity_flags(runner: str) -> set:
    """Option strings of the runner's store_true flags — booleans that
    take NO operand. The reference-parity CLIs mix store_true flags
    (e.g. mnist --ss_loss) with type=eval booleans that REQUIRE an
    operand (cifar --ss_loss True); emitting the wrong form kills the
    grid point with an argparse SystemExit."""
    parser = _runner_module(runner).build_parser()
    return {
        opt
        for a in parser._actions
        if a.nargs == 0
        for opt in a.option_strings
    }


def _apply_overrides(
    base_argv: List[str], combo: Dict[str, Any], run_dir: str,
    runner: str = "cifar",
) -> List[str]:
    """Base runner argv + one grid point's overrides."""
    argv = list(base_argv)
    zero_arity = _zero_arity_flags(runner)

    def set_flag(flag: str, value: Any):
        if isinstance(value, bool) and flag in zero_arity:
            # store_true flags take no operand: present iff True
            if value and flag not in argv:
                argv.append(flag)
            elif not value and flag in argv:
                argv.remove(flag)
            return
        if flag in argv:
            i = argv.index(flag)
            if i + 1 < len(argv) and not argv[i + 1].startswith("--"):
                argv[i + 1] = str(value)
            else:
                # flag present with no operand (trailing, or followed by
                # another flag): insert rather than clobber the neighbor
                argv.insert(i + 1, str(value))
        else:
            argv.extend([flag, str(value)])

    if any(combo.get(k) is not None for k in _SOLVER_KEYS):
        si = argv.index("--solvers") if "--solvers" in argv else -1
        if si >= 0 and si + 1 < len(argv) \
                and not argv[si + 1].startswith("--"):
            dsl = argv[si + 1]
        else:
            dsl = "rk2,u,8,-1,0.5,-1"
        tokens = [s.split(",") for s in dsl.split(";")]
        update_solvers_with_sweep_params(tokens, combo)
        set_flag("--solvers", ";".join(",".join(t) for t in tokens))

    if any(combo.get(k) is not None for k in _LR_KEYS):
        max_lr, base_lr = set_max_base_lr(combo)
        if runner == "cifar":
            # cifar uses the cyclic schedule's endpoints; max_lr == base_lr
            # already yields the reference's flat-schedule semantics
            set_flag("--max_lr", max_lr)
            set_flag("--base_lr", base_lr)
        else:
            # mnist has a single flat --lr
            set_flag("--lr", max_lr)

    for k, v in combo.items():
        if k in _SOLVER_KEYS or k in _LR_KEYS or v is None:
            continue
        set_flag(f"--{k}", v)

    set_flag("--save_dir", run_dir)
    return argv


def _runner_module(name: str):
    if name == "cifar":
        from . import cifar_runner

        return cifar_runner
    if name == "mnist":
        from . import mnist_runner

        return mnist_runner
    raise ValueError(f"unknown runner {name!r} (expected cifar|mnist)")


def _runner_main(name: str):
    return _runner_module(name).main


def _best_metric(run_dir: str) -> Optional[float]:
    path = os.path.join(run_dir, "metrics.jsonl")
    best = None
    if not os.path.exists(path):
        return None
    with open(path) as f:
        for line in f:
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                continue
            for k, v in rec.items():
                # 'best' (final summary) and per-epoch 'best_<mode>' /
                # 'best_solver_<i>' records written by fit/validate
                if k == "best" or k.startswith("best_"):
                    v = float(v)
                    best = v if best is None else max(best, v)
    return best


def run_sweep(
    runner: str,
    config: Dict[str, Any],
    sweep_dir: str,
    base_argv: Sequence[str] = (),
    logger=None,
) -> List[Dict[str, Any]]:
    """Run the full grid; returns one summary record per run."""
    os.makedirs(sweep_dir, exist_ok=True)
    combos = expand_grid(config)
    target = _runner_main(runner)
    records = []
    summary = os.path.join(sweep_dir, "sweep_summary.csv")
    # all combos share the same key set, so the header is known up front
    # and the summary can be written incrementally: a crashing grid point
    # (bad combo, OOM, divergence assert) must not lose the completed runs
    keys = sorted({"run", "run_dir", "best", "error"}
                  | {k for c in combos for k in c})

    def write_summary():
        with open(summary, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=keys)
            w.writeheader()
            w.writerows(records)

    for i, combo in enumerate(combos):
        run_dir = os.path.join(sweep_dir, f"run_{i:03d}")
        argv = _apply_overrides(list(base_argv), combo, run_dir, runner)
        if logger:
            logger.info(f"sweep run {i}/{len(combos)}: {combo}")
        rec = {"run": i, "run_dir": run_dir, **combo, "error": ""}
        try:
            target(argv)
            rec["best"] = _best_metric(run_dir)
        except SystemExit as e:  # argparse rejection of a bad combo
            rec.update(best=None, error=f"SystemExit({e.code})")
            if logger:
                logger.error(f"sweep run {i} argv rejected: {argv}")
        except Exception as e:  # noqa: BLE001 - one run must not kill the grid
            rec.update(best=None, error=f"{type(e).__name__}: {e}")
            if logger:
                logger.error(f"sweep run {i} failed: {e!r}")
        records.append(rec)
        write_summary()
    return records


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--runner", choices=["cifar", "mnist"], required=True)
    p.add_argument("--config", required=True,
                   help="JSON sweep config (wandb-style or plain grid)")
    p.add_argument("--sweep_dir", default="sweep_runs")
    p.add_argument("--device", default=None,
                   help="device of every run (default: the card; 'cpu' "
                        "for the CPU), passed on as the runners' --device")
    p.add_argument("base_args", nargs=argparse.REMAINDER,
                   help="args after -- go to the target runner verbatim")
    args = p.parse_args(argv)

    with open(args.config) as f:
        config = json.load(f)
    base = args.base_args
    if base and base[0] == "--":
        base = base[1:]
    if args.device is not None:
        base = [a for i, a in enumerate(base)
                if a != "--device" and (i == 0 or base[i - 1] != "--device")]
        base += ["--device", args.device]

    from ..utils import get_logger

    logger = get_logger(os.path.join(args.sweep_dir, "logs"), name="sweep")
    records = run_sweep(args.runner, config, args.sweep_dir, base, logger)
    for r in records:
        logger.info(str(r))
    return records


if __name__ == "__main__":
    main()
