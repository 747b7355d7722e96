"""The runners' trainable solver coefficients and continuous adjoint
against the JAX runners', on the CPU.

``mnist_runner --train_solver_params --lr_uv 0.01``: both runners train the
MNIST MetaNODE (dim 64, RK2 u=0.5 in 2 steps, SGD lr 0.01, batch 8, 2
epochs of 4 steps on synthetic digits) from the JAX runner's initial
params, which the port's model is built with here (the joint loop, like
JAX's, has no ``--resume``).  Per-epoch train loss within 1e-4 relative,
the logged u within 1e-5, the ``solver_trained`` checkpoint written.
``cifar_runner --integration_method adjoint``: premetanode10 at in_planes
8 for one epoch from the JAX runner's initial params (a ``last``
checkpoint at step 0 that ``--resume`` restores), train loss within 1e-4
relative."""
import json
import os

import numpy as np

from neural_ode_metasolver_tpu.runners import cifar_runner as j_cifar
from neural_ode_metasolver_tpu.runners import mnist_runner as j_mnist
from neural_ode_metasolver_tpu_torch.models import mnist_params_from_jax
from neural_ode_metasolver_tpu_torch.runners import cifar_runner
from neural_ode_metasolver_tpu_torch.runners import mnist_runner
from neural_ode_metasolver_tpu_torch.runners.common import (
    optimizer_from_saved_args,
)
from neural_ode_metasolver_tpu_torch.training import SolverTrainState
from test_torch_runners import (  # noqa: F401 (an autouse fixture)
    MNIST_ARGV,
    jax_initial_params,
    one_torch_thread,
    seed_port_run,
)
from test_torch_runners_cifar import CIFAR_ARGV


def _records(save_dir):
    with open(os.path.join(save_dir, "metrics.jsonl")) as f:
        return [r for r in map(json.loads, f) if "train_loss" in r]


def test_mnist_runner_train_solver_params_matches_jax(tmp_path,
                                                      monkeypatch):
    argv = MNIST_ARGV + ["--train_solver_params", "--lr_uv", "0.01"]
    jdir, pdir = str(tmp_path / "jax"), str(tmp_path / "port")
    j_mnist.main(argv + ["--save_dir", jdir])
    sd = mnist_params_from_jax(jax_initial_params("mnist", 502))
    build = mnist_runner.build_model

    def build_from_jax(name, **kw):
        model = build(name, **kw)
        model.load_state_dict(sd)
        return model

    monkeypatch.setattr(mnist_runner, "build_model", build_from_jax)
    pts = mnist_runner.main(argv + ["--save_dir", pdir, "--device", "cpu"])
    assert isinstance(pts, SolverTrainState) and pts.step == 8
    jrecs, precs = _records(jdir), _records(pdir)
    assert [r["epoch"] for r in precs] == [r["epoch"] for r in jrecs] \
        == [0, 1]
    np.testing.assert_allclose([r["train_loss"] for r in precs],
                               [r["train_loss"] for r in jrecs], rtol=1e-4)
    np.testing.assert_allclose([r["solver0_u"] for r in precs],
                               [r["solver0_u"] for r in jrecs], rtol=0,
                               atol=1e-5)
    assert precs[-1]["solver0_u"] != 0.5
    assert precs[-1]["solver0_u"] == pts.solver_params[0]["u"].item()
    assert set(jrecs[0]) <= set(precs[0])
    steps = os.listdir(os.path.join(pdir, "solver_trained"))
    assert steps == ["step_00000008"]
    with open(os.path.join(pdir, "logs")) as f:
        assert "epoch 1 | loss" in f.read()


def test_cifar_runner_adjoint_matches_jax(tmp_path):
    argv = CIFAR_ARGV + ["--integration_method", "adjoint", "--nepochs", "1"]
    jdir, pdir = str(tmp_path / "jax"), str(tmp_path / "port")
    j_cifar.main(argv + ["--save_dir", jdir])
    margs = vars(cifar_runner.parse_args(argv))
    seed_port_run(pdir, "premetanode10",
                  jax_initial_params("premetanode10", 602, in_planes=8),
                  optimizer_from_saved_args(margs), in_planes=8)
    pts = cifar_runner.main(argv + ["--save_dir", pdir, "--resume",
                                    "--device", "cpu"])
    assert pts.step == 4
    jl = [r["train_loss"] for r in _records(jdir)]
    pl = [r["train_loss"] for r in _records(pdir)]
    assert len(jl) == len(pl) == 1
    np.testing.assert_allclose(pl, jl, rtol=1e-4)
