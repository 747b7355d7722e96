"""The port's examples (``examples/torch/``) on the CPU: each script as a
subprocess at tiny sizes with ``--device cpu``, the CIFAR one restoring a
one-epoch ``cifar_runner`` checkpoint of the port, and the MNIST one on
the shipped checkpoint (carried into the port's format by
``scripts/convert_shipped_mnist_checkpoint.py``) against JAX's
``accuracy`` on the same images."""
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from tests.test_torch_runners import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(REPO, "examples", "torch")
SHIPPED = os.path.join(REPO, "examples", "checkpoints",
                       "mnist_digits_smoothing")
CONVERTED = os.path.join(REPO, "examples", "checkpoints",
                         "mnist_digits_smoothing_torch")
TINY = ["--batch_size", "8", "--n_eval", "16", "--n_steps", "2"]
REGIMES = ("standalone", "switch [0.6,0.4]", "solver ens [0.6,0.4]",
           "model ensembling")


def _run(script, args, expect_ok=True):
    """Run an example in a fresh interpreter with one intra-op thread (the
    suite's workers share the cores); returns its stdout and its last
    line's JSON record."""
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, os.path.join(EXAMPLES, script)]
                          + args, cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=300)
    if not expect_ok:
        return proc
    assert proc.returncode == 0, (proc.stdout[-2000:], proc.stderr[-2000:])
    return proc.stdout, json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("script,args", [
    ("mnist_build_and_evaluate.py", TINY),
    ("cifar10_build_and_evaluate.py", TINY + ["--in_planes", "8"]),
    ("cifar10_build_and_evaluate.py",
     TINY + ["--in_planes", "8", "--precision", "bf16"]),
    ("learn_solver_coefficient.py", ["--steps", "10"]),
])
def test_example_runs_on_the_cpu(script, args):
    out, record = _run(script, args + ["--device", "cpu"])
    assert record["device"] == "cpu"
    if script.startswith("cifar10"):
        assert set(record["regimes"]) == set(REGIMES)
        for label in REGIMES:
            assert label in out
        for row in record["regimes"].values():
            assert 0.0 <= row["clean"] <= 1.0 and 0.0 <= row["fgsm"] <= 1.0
    elif script.startswith("mnist"):
        assert "random init" in out and set(record["sn_test"]) == {
            "1", "2", "4", "8"}
    else:
        assert record["steps"] == 10 and np.isfinite(record["final_loss"])
        assert record["u"] != record["u0"]  # u moved


@pytest.mark.parametrize("script", ["mnist_build_and_evaluate.py",
                                    "cifar10_build_and_evaluate.py",
                                    "learn_solver_coefficient.py"])
def test_example_needs_a_card_or_an_explicit_cpu(script):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the no-card path cannot run")
    proc = _run(script, [], expect_ok=False)
    assert proc.returncode != 0 and "no CUDA device" in proc.stderr


def test_cifar_example_restores_a_port_runner_checkpoint(tmp_path):
    """A one-epoch ``cifar_runner`` run of the port under its default
    optimizer flags (SGD with the cyclic momentum trace): the example
    rebuilds the optimizer from the sidecar and restores ``last``."""
    from neural_ode_metasolver_tpu_torch.runners import cifar_runner

    save = str(tmp_path / "exp")
    cifar_runner.main([
        "--network", "premetanode10", "--in_planes", "8",
        "--solvers", "rk2,u,2,-1,0.5,-1", "--nepochs", "1",
        "--batch_size", "8", "--test_batch_size", "8",
        "--synthetic_train_size", "32", "--synthetic_test_size", "16",
        "--val_perc", "0.25", "--save_dir", save, "--device", "cpu"])
    out, record = _run("cifar10_build_and_evaluate.py",
                       ["--checkpoint", os.path.join(save, "last"),
                        "--in_planes", "8", "--device", "cpu"] + TINY)
    assert "loaded checkpoint" in out
    assert set(record["regimes"]) == set(REGIMES)


def _restore_shipped_jax():
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    try:
        from convert_shipped_mnist_checkpoint import restore_jax
    finally:
        sys.path.pop(0)
    return restore_jax(SHIPPED)


@pytest.mark.skipif(not os.path.isdir(SHIPPED),
                    reason="shipped artifact not present")
def test_mnist_example_on_the_shipped_checkpoint_matches_jax():
    """The converted checkpoint holds the shipped params bit for bit; the
    example's clean accuracy on it equals JAX's ``accuracy`` of the shipped
    checkpoint on the same 16 images (rk4 u3, 2 steps)."""
    from neural_ode_metasolver_tpu.data import (
        batch_iterator as j_batch_iterator,
        synthetic_dataset as j_synthetic_dataset,
    )
    from neural_ode_metasolver_tpu.models.api import build_model as j_build
    from neural_ode_metasolver_tpu.ops import SolverOptions as JOpts
    from neural_ode_metasolver_tpu.ops import create_solver as j_create
    from neural_ode_metasolver_tpu.training import accuracy as j_accuracy
    from neural_ode_metasolver_tpu_torch.models import mnist_params_from_jax

    ts, _ = _restore_shipped_jax()
    saved = torch.load(os.path.join(CONVERTED, "step_00000396", "state"),
                       map_location="cpu", weights_only=True)
    want = mnist_params_from_jax(ts.params)
    assert set(saved["params"]) == set(want)
    for k, v in want.items():
        assert torch.equal(saved["params"][k], v), k
    assert saved["step"] == int(ts.step)

    _, record = _run("mnist_build_and_evaluate.py",
                     ["--checkpoint", CONVERTED, "--device", "cpu"] + TINY)
    ds = j_synthetic_dataset(16, (28, 28, 1), seed=1)
    solver = j_create("rk4", "u3", n_steps=2, u0=np.float32(1 / 3))
    acc = j_accuracy(j_build("mnist", dim=64),
                     jax.tree_util.tree_map(jax.numpy.asarray, ts.params),
                     ts.model_state, [solver], JOpts(),
                     j_batch_iterator(ds, 8, shuffle=False))
    assert record["clean_acc"] == acc
