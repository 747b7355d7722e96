"""The PyTorch port's MNIST training CLI and attack CLI against the JAX
package's, on the CPU, and the flags of all three port CLIs.

Parity: both ``mnist_runner``s run the same argv (SGD lr 0.01, clean, no
noise, 2 epochs of 4 steps at dim 64, an RK2 solve of 2 steps); the port
starts from the JAX runner's initial params, converted and written as a
port ``last`` checkpoint at step 0 that ``--resume`` restores.  Per-epoch
train loss within 1e-4 relative, validation counts equal, final params
within 1e-4 of max|p|.  Then ``attacks_runner`` over the JAX run's final
params (the JAX checkpoint, and the same params converted into a port
checkpoint): clean counts equal, FGSM within 1 of N.

The JAX side runs as its own tests run it (``tests/conftest.py``: the CPU,
x64 on); its params are f32."""
import csv
import json
import os
import re

import jax
import numpy as np
import pytest
import torch

from neural_ode_metasolver_tpu.models.api import build_model as j_build_model
from neural_ode_metasolver_tpu.runners import attacks_runner as j_attacks
from neural_ode_metasolver_tpu.runners import cifar_runner as j_cifar
from neural_ode_metasolver_tpu.runners import mnist_runner as j_mnist
from neural_ode_metasolver_tpu.runners.common import (
    optimizer_from_saved_args as j_optimizer_from_saved_args,
)
from neural_ode_metasolver_tpu.training import (
    create_train_state as j_create_train_state,
    restore_checkpoint as j_restore_checkpoint,
)
from neural_ode_metasolver_tpu_torch.models import (
    build_model,
    cifar_params_from_jax,
    cifar_state_from_jax,
    mnist_params_from_jax,
)
from neural_ode_metasolver_tpu_torch.runners import attacks_runner
from neural_ode_metasolver_tpu_torch.runners import cifar_runner
from neural_ode_metasolver_tpu_torch.runners import mnist_runner
from neural_ode_metasolver_tpu_torch.runners.common import (
    optimizer_from_saved_args,
)
from neural_ode_metasolver_tpu_torch.training import (
    create_train_state,
    save_checkpoint,
)

@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for these tiny CPU shapes: with the suite's
    workers sharing the cores, OpenMP's barriers stall every small op (a
    runner test here took 564 s beside three other workers, 6 s with one
    thread).  Imported by the other new port test files."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


MNIST_ARGV = ["--solvers", "rk2,u,2,-1,0.5,-1", "--nepochs", "2",
              "--batch_size", "8", "--test_batch_size", "16",
              "--synthetic_train_size", "32", "--synthetic_test_size", "16",
              "--optim", "sgd", "--lr", "0.01"]
VAL_LINE = re.compile(r"epoch (\d+) \| standalone solver 0 \(u0=[^)]*\) acc "
                      r"([0-9.]+)")


def jax_initial_params(name, seed, **overrides):
    """The params the JAX runner's ``fit`` starts from: its model's init
    at the first split of ``key(seed)``."""
    jmodel = j_build_model(name, **overrides)
    _, k_init = jax.random.split(jax.random.key(seed))
    params, _ = jmodel.init(k_init)
    return jax.tree_util.tree_map(np.asarray, params)


def seed_port_run(save_dir, name, np_params, tx, np_state=None,
                  **overrides):
    """Write ``np_params`` (a JAX tree), and ``np_state`` (a JAX CIFAR model
    state, where the config has one), as the port's ``last`` checkpoint at
    step 0, with the optimizer state ``tx`` makes, for ``--resume``."""
    convert = mnist_params_from_jax if name == "mnist" else \
        cifar_params_from_jax
    model = build_model(name, device="cpu", **overrides)
    sd = convert(np_params)
    if np_state is not None:
        sd.update(cifar_state_from_jax(np_state))
    model.load_state_dict(sd)
    save_checkpoint(os.path.join(save_dir, "last"),
                    create_train_state(model, tx))


def read_run(save_dir):
    """(per-epoch train losses, per-epoch validation accuracies)."""
    with open(os.path.join(save_dir, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    losses = [r["train_loss"] for r in recs if "train_loss" in r]
    with open(os.path.join(save_dir, "logs")) as f:
        accs = {int(m.group(1)): float(m.group(2))
                for m in VAL_LINE.finditer(f.read())}
    return losses, [accs[e] for e in sorted(accs)]


def jax_final_params(save_dir, name, **overrides):
    """The JAX run's ``last`` params as the port's names -> numpy."""
    with open(sorted(
            os.path.join(save_dir, "last", d)
            for d in os.listdir(os.path.join(save_dir, "last")))[-1]
            + "/config.json") as f:
        margs = json.load(f)["args"]
    template = j_create_train_state(j_build_model(name, **overrides),
                                    j_optimizer_from_saved_args(margs),
                                    jax.random.key(0))
    jts, _ = j_restore_checkpoint(os.path.join(save_dir, "last"), template)
    convert = mnist_params_from_jax if name == "mnist" else \
        cifar_params_from_jax
    return {k: v.numpy() for k, v in convert(
        jax.tree_util.tree_map(np.asarray, jts.params)).items()}, jts


def assert_runs_agree(jdir, pdir, pts, name, n_val, **overrides):
    jl, ja = read_run(jdir)
    pl, pa = read_run(pdir)
    assert len(jl) == len(pl) == len(ja) == len(pa) == 2
    np.testing.assert_allclose(pl, jl, rtol=1e-4)
    assert [round(a * n_val) for a in pa] == [round(a * n_val) for a in ja]
    jp, _ = jax_final_params(jdir, name, **overrides)
    assert set(jp) == set(pts.params)
    # max|p| over the whole model: the GroupNorm biases start at 0 and
    # hold about 6e-5 after 8 steps, and their gap between the frameworks
    # (1.9e-8, rounding of the gradients) is 3x a bar of 1e-4 of their own
    # max but 1e-3 of the model's bar
    bar = 1e-4 * max(np.abs(v).max() for v in jp.values())
    for k, v in jp.items():
        np.testing.assert_allclose(pts.params[k].detach().numpy(), v,
                                   rtol=0, atol=bar, err_msg=k)
    return jp


@pytest.fixture(scope="module")
def mnist_runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("mnist_runs")
    jdir, pdir = str(root / "jax"), str(root / "port")
    j_mnist.main(MNIST_ARGV + ["--save_dir", jdir])
    seed_port_run(pdir, "mnist", jax_initial_params("mnist", 502),
                  optimizer_from_saved_args({"optim": "sgd",
                                             "weight_decay": 5e-4}))
    pts = mnist_runner.main(MNIST_ARGV + ["--save_dir", pdir, "--resume",
                                          "--device", "cpu"])
    return root, jdir, pdir, pts


def test_mnist_runner_matches_jax(mnist_runs):
    _, jdir, pdir, pts = mnist_runs
    assert pts.step == 8 and pts.opt_state["count"] == 8
    assert_runs_agree(jdir, pdir, pts, "mnist", 16)
    with open(os.path.join(pdir, "logs")) as f:
        log = f.read()
    assert "resumed from" in log and "at step 0" in log
    assert "data backend: native" in log
    for d in ("last/step_00000004", "last/step_00000008"):
        assert os.path.isfile(os.path.join(pdir, d, "state"))
        assert os.path.isfile(os.path.join(pdir, d, "config.json"))
    assert os.listdir(os.path.join(pdir, "best_solver_0"))
    with open(os.path.join(pdir, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    with open(os.path.join(jdir, "metrics.jsonl")) as f:
        jrecs = [json.loads(line) for line in f]
    assert recs[0]["_type"] == "config" and recs[0]["model"] == "mnist"
    # the same records, with the same keys, as the JAX runner writes
    assert [sorted(r) for r in recs[1:]] == [sorted(r) for r in jrecs[1:]]


def test_attacks_runner_matches_jax(mnist_runs, tmp_path, monkeypatch):
    root, jdir, _, _ = mnist_runs
    monkeypatch.chdir(tmp_path)  # the JAX runner logs into the cwd
    jp, jts = jax_final_params(jdir, "mnist")
    step_dir = sorted(os.listdir(os.path.join(jdir, "last")))[-1]
    with open(os.path.join(jdir, "last", step_dir, "config.json")) as f:
        cfg = json.load(f)
    # the same params as a port checkpoint, with the JAX sidecar
    model = build_model("mnist", device="cpu")
    model.load_state_dict({k: torch.tensor(v) for k, v in jp.items()})
    state = create_train_state(model,
                               optimizer_from_saved_args(cfg["args"]),
                               step=int(jts.step))
    save_checkpoint(str(tmp_path / "conv" / "last"), state, cfg)
    argv = ["--modes", "clean,fgsm", "--epsilons", "0.1", "--batch_size",
            "16", "--max_batches", "2"]
    j_attacks.main(argv + ["--checkpoints_glob",
                           os.path.join(jdir, "last"),
                           "--output_csv", str(tmp_path / "j.csv")])
    rows = attacks_runner.main(argv + [
        "--checkpoints_glob", str(tmp_path / "conv" / "last"),
        "--output_csv", str(tmp_path / "p.csv"), "--device", "cpu"])
    out = {}
    for tag in ("j", "p"):
        with open(tmp_path / f"{tag}.csv") as f:
            out[tag] = list(csv.DictReader(f))
    assert [r["mode"] for r in out["p"]] == [r["mode"] for r in out["j"]] \
        == ["clean", "fgsm"]
    assert list(out["p"][0]) == ["checkpoint", "mode", "eps", "accuracy"]
    assert [float(r["eps"]) for r in out["p"]] == [0.0, 0.1]
    n = 32
    clean_j, fgsm_j = (round(float(r["accuracy"]) * n) for r in out["j"])
    clean_p, fgsm_p = (round(float(r["accuracy"]) * n) for r in out["p"])
    assert clean_p == clean_j
    assert abs(fgsm_p - fgsm_j) <= 1
    assert len(rows) == 2
    assert os.path.exists(tmp_path / "attacks_runner.log")


def test_attacks_runner_model_ensemble(mnist_runs, tmp_path):
    """``--ensemble`` over the port run's ``last`` and ``best_solver_0``:
    both are read, and the ensemble rows follow the per-checkpoint ones."""
    _, _, pdir, _ = mnist_runs
    rows = attacks_runner.main([
        "--checkpoints_glob", os.path.join(pdir, "*"), "--modes",
        "clean,fgsm", "--epsilons", "0.1", "--batch_size", "16",
        "--max_batches", "1", "--ensemble", "--device", "cpu",
        "--output_csv", str(tmp_path / "e.csv")])
    assert [r["mode"] for r in rows] == ["clean", "fgsm"] * 2 + [
        "ensemble_clean", "ensemble_fgsm"]
    assert rows[-1]["checkpoint"] == "ENSEMBLE(2)"
    assert all(0.0 <= r["accuracy"] <= 1.0 for r in rows)


_REFUSED = [
    # without a process group of that size, JAX's validation errors
    (mnist_runner, ["--mesh", "data=2"], ValueError,
     r"mesh \{'data': 2\} != 1 devices"),
    (mnist_runner, ["--coordinator", "localhost:1"], ValueError,
     "multi-host training needs --mesh"),
    (mnist_runner, ["--num_hosts", "2"], ValueError,
     "--num_hosts given without --coordinator"),
    (mnist_runner, ["--process_id", "0"], ValueError,
     "--process_id given without --coordinator"),
    (mnist_runner, ["--train_solver_params", "--integration_method",
                    "adjoint"], ValueError, "discretize-then-optimize"),
    (mnist_runner, ["--train_solver_params", "--profile_dir", "p"],
     ValueError, "--profile_dir"),
    (mnist_runner, ["--compiler_option", "a=b"], ValueError,
     "--compiler_option"),
    (cifar_runner, ["--mesh", "data=2,pp=2"], ValueError,
     r"mesh \{'data': 2, 'pp': 2\} != 1 devices"),
    (mnist_runner, ["--train_solver_params", "--mesh", "data=2"],
     ValueError, "--mesh is not supported with --train_solver_params"),
    (mnist_runner, ["--mesh", "data=2,model=2"], ValueError,
     r"mesh \{'data': 2, 'model': 2\} != 1 devices"),
    (cifar_runner, ["--mesh", "data=2,sp=2"], ValueError,
     r"mesh \{'data': 2, 'sp': 2\} != 1 devices"),
    # JAX's pp checks, on a one-rank pp axis
    (mnist_runner, ["--mesh", "data=1,pp=1"], ValueError,
     "--mesh pp= needs a cifar-family model"),
    (cifar_runner, ["--mesh", "data=1,pp=1", "--pp_microbatches", "3",
                    "--batch_size", "16"], ValueError,
     r"batch_size 16 must split into 3 microbatches each divisible by the "
     r"data axis size \(1\)"),
]


@pytest.mark.parametrize("runner,argv,exc,label", _REFUSED,
                         ids=[f"{r.__name__.split('.')[-1]}{' '.join(a)}"
                              for r, a, _, _ in _REFUSED])
def test_refused_flags_raise_with_their_label(runner, argv, exc, label,
                                              tmp_path):
    with pytest.raises(exc, match=label):
        runner.main(argv + ["--device", "cpu", "--save_dir",
                            str(tmp_path)])
    assert not (tmp_path / "metrics.jsonl").exists()


def test_pp_microbatches_without_a_pp_axis_is_accepted(tmp_path):
    """``--pp_microbatches`` without a ``pp`` axis runs and changes
    nothing, as in JAX: the run equals the same run without the flag."""
    argv = ["--network", "premetanode10", "--in_planes", "4", "--solvers",
            "rk2,u,1,-1,0.5,-1", "--nepochs", "1", "--batch_size", "8",
            "--test_batch_size", "8", "--synthetic_train_size", "16",
            "--synthetic_test_size", "8", "--device", "cpu"]
    a = cifar_runner.main(argv + ["--pp_microbatches", "2", "--save_dir",
                                  str(tmp_path / "a")])
    b = cifar_runner.main(argv + ["--save_dir", str(tmp_path / "b")])
    assert a.step == b.step >= 1
    assert all(torch.equal(a.params[k], b.params[k]) for k in a.params)


@pytest.mark.parametrize("pair", [(j_mnist.build_parser, mnist_runner),
                                  (j_cifar.build_parser, cifar_runner)],
                         ids=["mnist", "cifar"])
def test_every_jax_flag_parses_with_its_default_and_choices(pair):
    jparser, port = pair
    jp, pp = jparser(), port.build_parser()
    jacts = {a.dest: a for a in jp._actions if a.dest != "help"}
    pacts = {a.dest: a for a in pp._actions if a.dest != "help"}
    assert set(pacts) - set(jacts) == {"device"}
    assert set(jacts) <= set(pacts)
    for dest, ja in jacts.items():
        pa = pacts[dest]
        assert pa.option_strings == ja.option_strings, dest
        assert pa.default == ja.default, dest
        assert pa.choices == ja.choices, dest
        assert pa.nargs == ja.nargs and type(pa) is type(ja), dest
    jv, pv = vars(jp.parse_args([])), vars(pp.parse_args([]))
    assert {k: v for k, v in pv.items() if k != "device"} == jv
    assert pv["device"] is None
    ja = vars(j_attacks.parse_args(["--checkpoints_glob", "x"]))
    pa = vars(attacks_runner.parse_args(["--checkpoints_glob", "x"]))
    assert {k: v for k, v in pa.items() if k != "device"} == ja


def test_runners_need_a_card_or_an_explicit_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the no-card path cannot run")
    for runner in (mnist_runner, cifar_runner):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            runner.main(["--save_dir", str(tmp_path)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        attacks_runner.main(["--checkpoints_glob", str(tmp_path / "x"),
                             "--output_csv", str(tmp_path / "a.csv")])
