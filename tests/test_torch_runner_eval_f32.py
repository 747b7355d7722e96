"""The port's runners evaluate in f32 whatever ``--precision`` says, as the
JAX runners do (JAX ``runners/common.py``: ``validate`` builds
``make_eval_step`` and the adversarial test ``make_adversarial_predict``
with no compute dtype; ``attacks_runner`` likewise).

A tiny ``--precision bf16`` ``cifar_runner`` run on the CPU (premetanode10
at in_planes 8, an RK2 solve of 2 steps, three bf16 train steps, then
validation and an FGSM test, which draws nothing): its logged ``val_acc``
(the ``best_solver_0`` sidecar) and ``adv_test_acc`` equal, as counts,
what JAX's f32 ``accuracy`` and ``adversarial_accuracy`` give on the
run's final params and the same batches.  The run resumes from JAX's
initial params with the classifier's bias set to 1 and its kernel scaled
by 0.05: the logits then sit near 1, a few 1e-4 apart, where f32 keeps
them apart and bf16 (one ulp 2^-7) ties them, so an evaluation in bf16
moves most argmaxes and fails the test.
"""
import json
import os
from collections.abc import Mapping

import jax
import jax.numpy as jnp
import numpy as np

from neural_ode_metasolver_tpu.data import (
    batch_iterator,
    synthetic_dataset,
    train_val_split,
)
from neural_ode_metasolver_tpu.models.api import build_model as j_build_model
from neural_ode_metasolver_tpu.ops import SolverOptions as JSolverOptions
from neural_ode_metasolver_tpu.ops import parse_solver_dsl as j_parse
from neural_ode_metasolver_tpu.training import AttackConfig as JAttackConfig
from neural_ode_metasolver_tpu.training import accuracy as j_accuracy
from neural_ode_metasolver_tpu.training import (
    adversarial_accuracy as j_adversarial_accuracy,
)
from neural_ode_metasolver_tpu_torch.runners import cifar_runner
from neural_ode_metasolver_tpu_torch.runners.common import (
    optimizer_from_saved_args,
)
from test_torch_runners import (  # noqa: F401 (an autouse fixture)
    jax_initial_params,
    one_torch_thread,
    seed_port_run,
)

MEAN, STD = (0.4914, 0.4822, 0.4465), (0.2023, 0.1994, 0.2010)
SEED, N_TRAIN, N_TEST, BATCH = 602, 96, 48, 16
ARGV = ["--in_planes", "8", "--solvers", "rk2,u,2,-1,0.5,-1",
        "--nepochs", "1", "--batch_size", str(BATCH), "--test_batch_size",
        str(BATCH), "--synthetic_train_size", str(N_TRAIN),
        "--synthetic_test_size", str(N_TEST), "--val_perc", "0.5",
        "--precision", "bf16", "--adv_testing_mode", "fgsm",
        "--eps_adv_testing", str(8 / 255), "--device", "cpu"]


def _jax_tree(node, path, named):
    """The JAX parameter tree ``node`` with each leaf taken from the
    port's ``named`` tensors by its path (the inverse of
    ``cifar_params_from_jax``)."""
    if isinstance(node, Mapping):
        return {k: None if v is None else _jax_tree(v, f"{path}.{k}", named)
                for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return type(node)(_jax_tree(v, f"{path}.{i}", named)
                          for i, v in enumerate(node))
    return jnp.asarray(named[path].detach().float().numpy())


def test_bf16_cifar_runner_evaluates_in_f32_as_jax(tmp_path):
    save = str(tmp_path / "run")
    init = jax_initial_params("premetanode10", SEED, in_planes=8)
    init["fc"] = {"kernel": init["fc"]["kernel"] * 0.05,
                  "bias": np.ones_like(init["fc"]["bias"])}
    seed_port_run(save, "premetanode10", init, optimizer_from_saved_args(
        vars(cifar_runner.parse_args(ARGV))), in_planes=8)
    ts = cifar_runner.main(ARGV + ["--save_dir", save, "--resume"])
    assert ts.step == (N_TRAIN // 2) // BATCH  # bf16 train steps ran
    with open(os.path.join(save, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    (adv_acc,) = [r["adv_test_acc"] for r in recs if "adv_test_acc" in r]
    best = os.path.join(save, "best_solver_0")
    with open(os.path.join(best, sorted(os.listdir(best))[-1],
                           "config.json")) as f:
        val_acc = json.load(f)["val_acc"]

    # JAX in f32 on the run's final params and the runner's batches
    jmodel = j_build_model("premetanode10", in_planes=8)
    template, state = jmodel.init(jax.random.key(0))
    params = _jax_tree(jax.tree_util.tree_map(np.asarray, template),
                       "params", ts.params)
    solvers = j_parse("rk2,u,2,-1,0.5,-1")
    opts = JSolverOptions(solver_mode="standalone")
    _, val_ds = train_val_split(synthetic_dataset(N_TRAIN, (32, 32, 3),
                                                  seed=SEED), 0.5, seed=SEED)
    test_ds = synthetic_dataset(N_TEST, (32, 32, 3), seed=SEED + 1)

    def batches(ds):
        return batch_iterator(ds, BATCH, shuffle=False, drop_last=False,
                              mean=MEAN, std=STD)

    want_val = j_accuracy(jmodel, params, state, solvers, opts,
                          batches(val_ds))
    want_adv = j_adversarial_accuracy(
        jmodel, params, state, solvers, opts, batches(test_ds),
        JAttackConfig(mode="fgsm", eps=8 / 255, mean=MEAN, std=STD),
        jax.random.key(1))
    n_val = len(val_ds)
    assert round(val_acc * n_val) == round(want_val * n_val)
    assert round(adv_acc * N_TEST) == round(want_adv * N_TEST)
