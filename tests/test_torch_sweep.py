"""The port's sweep driver (``runners/sweep.py``) against the JAX
package's: its pure functions on the same inputs give equal outputs, and
the grid drives the port's ``mnist_runner --device cpu`` end to end (the
cases of ``tests/test_sweep.py``): the summary's columns, an LR override
and a failing grid point that the sweep records and survives."""
import csv
import glob
import json
import os

import pytest

from neural_ode_metasolver_tpu.runners import sweep as jsweep
from neural_ode_metasolver_tpu_torch.runners import sweep as psweep
from tests.test_torch_runners import one_torch_thread  # noqa: F401

BASE = ["--solvers", "rk2,u,2,-1,0.5,-1", "--nepochs", "1",
        "--batch_size", "16", "--test_batch_size", "16",
        "--synthetic_train_size", "32", "--synthetic_test_size", "16",
        "--device", "cpu"]


def test_update_solvers_and_lr_hooks_match_jax():
    configs = [{"wnb_method": "rk2", "wnb_u": 1.0}, {"wnb_n_steps": None},
               {"wnb_parameterization": "uv", "wnb_v": 0.25,
                "wnb_n_steps": 4}]
    for cfg in configs:
        a = [["rk4", "uv", "2", "-1", "0.3", "0.6"],
             ["rk2", "u", "8", "-1", "0.5", "-1"]]
        b = [list(t) for t in a]
        psweep.update_solvers_with_sweep_params(a, cfg)
        jsweep.update_solvers_with_sweep_params(b, cfg)
        assert a == b
    for cfg in ({"max_lr": 0.1, "base_lr": 1e-5},
                {"max_lr": 0.1, "max_lr_reduction": 100.0},
                {"base_lr": 0.01}):
        assert psweep.set_max_base_lr(cfg) == jsweep.set_max_base_lr(cfg)
    for cfg in ({}, {"max_lr": 0.1}):
        with pytest.raises(ValueError):
            psweep.set_max_base_lr(cfg)


def test_expand_grid_matches_jax():
    for cfg in ({"parameters": {"wnb_u": {"values": [0.5, 1.0]},
                                "max_lr": {"value": 0.1}}},
                {"wnb_u": [0.5, 1.0], "nepochs": 2, "seed": [1, 2, 3]}):
        assert psweep.expand_grid(cfg) == jsweep.expand_grid(cfg)
    with pytest.raises(ValueError):
        psweep.expand_grid({"parameters": {"x": {}}})


@pytest.mark.parametrize("runner", ["mnist", "cifar"])
def test_apply_overrides_match_jax(runner):
    """The same argv from the same grid points; the zero-arity flags come
    from the port's own parsers, which declare JAX's store_true flags."""
    assert psweep._zero_arity_flags(runner) >= \
        jsweep._zero_arity_flags(runner)
    cases = [([], {"max_lr": 0.1, "max_lr_reduction": 100.0}),
             ([], {"base_lr": 0.01}),
             (["--resume"], {"ss_loss": True, "resume": False}),
             (["--save_dir"], {}),
             (["--solvers"], {"wnb_u": 0.6}),
             (["--solvers", "--debug"], {"wnb_u": 0.6}),
             (["--flagx", "--nepochs", "2"], {"flagx": 0.5}),
             (["--solvers", "rk2,u,8,-1,0.25,-1"], {"wnb_u": 0.75})]
    for base, combo in cases:
        if runner == "cifar" and "ss_loss" in combo:
            continue  # cifar's --ss_loss takes an operand in both packages
        assert psweep._apply_overrides(base, combo, "d", runner) == \
            jsweep._apply_overrides(base, combo, "d", runner)


def test_sweep_mnist_end_to_end(tmp_path):
    """Two grid points through the port's mnist_runner: a run directory
    and a summary row each, with JAX's columns."""
    records = psweep.run_sweep("mnist", {"wnb_u": [0.5, 1.0]},
                               str(tmp_path / "sweep"), base_argv=BASE)
    assert len(records) == 2
    for r in records:
        assert glob.glob(os.path.join(r["run_dir"], "last", "step_*"))
        assert r["best"] is not None and not r["error"]
    with open(tmp_path / "sweep" / "sweep_summary.csv") as f:
        reader = csv.DictReader(f)
        rows = list(reader)
    assert reader.fieldnames == ["best", "error", "run", "run_dir", "wnb_u"]
    assert sorted(float(r["wnb_u"]) for r in rows) == [0.5, 1.0]


def test_sweep_cli_lr_override_and_failing_run(tmp_path):
    """The CLI with ``--device cpu``: an LR override reaches the runner's
    logged args (mnist maps it onto --lr), and an unknown solver method
    fails its grid point, which the summary records while the sweep goes
    on."""
    cfg = tmp_path / "sweep.json"
    cfg.write_text(json.dumps({"parameters": {
        "base_lr": {"value": 0.002},
        "solvers": {"values": ["rk9,u,2,-1,0.5,-1", "rk2,u,2,-1,0.5,-1"]},
    }}))
    base = [a for a in BASE if a not in ("--device", "cpu")]
    records = psweep.main(["--runner", "mnist", "--config", str(cfg),
                           "--sweep_dir", str(tmp_path / "out"),
                           "--device", "cpu", "--"] + base)
    assert len(records) == 2
    failed = [r for r in records if r["error"]]
    ok = [r for r in records if not r["error"]]
    assert len(failed) == 1 and failed[0]["best"] is None
    assert len(ok) == 1 and ok[0]["best"] is not None
    with open(os.path.join(ok[0]["run_dir"], "metrics.jsonl")) as f:
        args_logged = json.loads(f.readline())["args"]
    assert float(args_logged["lr"]) == 0.002
    assert args_logged["device"] == "cpu"
    with open(tmp_path / "out" / "sweep_summary.csv") as f:
        rows = list(csv.DictReader(f))
    assert sorted(bool(r["error"]) for r in rows) == [False, True]
