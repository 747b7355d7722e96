"""The PyTorch port's CIFAR training CLI and the CIFAR ss-loss against the
JAX package's, on the CPU.

Parity: both ``cifar_runner``s run the same argv (premetanode10 at
in_planes 8, an RK2 solve of 2 steps, clean SGD with the default cyclic lr
and momentum, 2 epochs of 4 steps); the port starts from the JAX runner's
initial params through a ``last`` checkpoint at step 0.  Per-epoch train
loss within 1e-4 relative, validation counts equal, final params within
1e-4 of max|p|.  The ss-loss: ``apply_cifar(ss_loss=True)`` (and
``ss_loss_abs``) and its parameter gradients against JAX's.  Then a port
run of the flagship recipe's options (FGSM-random, smoothing, bf16) with
the optimizer wrappers, which writes its checkpoints and resumes."""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neural_ode_metasolver_tpu.models.api import build_model as j_build_model
from neural_ode_metasolver_tpu.models.nn import (
    apply_init_scheme as j_apply_init_scheme,
)
from neural_ode_metasolver_tpu.ops import SolverOptions as JSolverOptions
from neural_ode_metasolver_tpu.ops import create_solver as j_create_solver
from neural_ode_metasolver_tpu.runners import cifar_runner as j_cifar
from neural_ode_metasolver_tpu_torch.models import (
    build_model,
    cifar_params_from_jax,
    cifar_state_from_jax,
)
from neural_ode_metasolver_tpu_torch.ops import create_solver
from neural_ode_metasolver_tpu_torch.runners import attacks_runner
from neural_ode_metasolver_tpu_torch.runners import cifar_runner
from neural_ode_metasolver_tpu_torch.runners.common import (
    optimizer_from_saved_args,
)
from neural_ode_metasolver_tpu_torch.training import (
    create_train_state,
    restore_checkpoint,
)
from test_torch_runners import (  # noqa: F401 (an autouse fixture)
    assert_runs_agree,
    jax_final_params,
    jax_initial_params,
    one_torch_thread,
    seed_port_run,
)

CIFAR_ARGV = ["--in_planes", "8", "--solvers", "rk2,u,2,-1,0.5,-1",
              "--nepochs", "2", "--batch_size", "16", "--test_batch_size",
              "8", "--synthetic_train_size", "80", "--synthetic_test_size",
              "8"]


def test_cifar_runner_matches_jax(tmp_path):
    jdir, pdir = str(tmp_path / "jax"), str(tmp_path / "port")
    j_cifar.main(CIFAR_ARGV + ["--save_dir", jdir])
    margs = vars(cifar_runner.parse_args(CIFAR_ARGV))
    seed_port_run(pdir, "premetanode10",
                  jax_initial_params("premetanode10", 602, in_planes=8),
                  optimizer_from_saved_args(margs), in_planes=8)
    pts = cifar_runner.main(CIFAR_ARGV + ["--save_dir", pdir, "--resume",
                                          "--device", "cpu"])
    assert pts.step == 8 and pts.opt_state["count"] == 8
    assert_runs_agree(jdir, pdir, pts, "premetanode10", 8, in_planes=8)
    with open(os.path.join(pdir, "metrics.jsonl")) as f:
        cfg = json.loads(f.readline())
    assert cfg["model"] == "premetanode10"
    assert cfg["args"]["data_mean"] == [0.4914, 0.4822, 0.4465]


@pytest.mark.parametrize("ss_abs", [False, True])
def test_cifar_ss_loss_matches_jax(ss_abs):
    """JAX ``odenet_cifar10.py:372-385``: logits, the ss-loss and the
    gradients of xent + 0.1 ss with respect to every parameter."""
    jmodel = j_build_model("premetanode10", in_planes=8)
    params, state = jmodel.init(jax.random.key(1))
    params = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float32),
                                    params)
    x = np.random.RandomState(0).rand(3, 32, 32, 3).astype(np.float32)
    y = np.array([1, 4, 7])
    jsolvers = [j_create_solver("rk2", "u", n_steps=2, u0=np.float32(0.5))]

    def jloss(p):
        logits, _, aux = jmodel.apply(p, state, jnp.asarray(x), jsolvers,
                                      JSolverOptions(), ss_loss=True,
                                      ss_loss_abs=ss_abs)
        xent = -jnp.mean(jax.nn.log_softmax(logits)[jnp.arange(3), y])
        return xent + 0.1 * aux["ss_loss"], (logits, aux["ss_loss"])

    (_, (jl, jss)), jg = jax.value_and_grad(jloss, has_aux=True)(params)
    pmodel = build_model("premetanode10", device="cpu", in_planes=8)
    pmodel.load_state_dict(cifar_params_from_jax(
        jax.tree_util.tree_map(np.asarray, params)))
    psolvers = [create_solver("rk2", "u", n_steps=2, u0=0.5)]
    pl, aux = pmodel(torch.tensor(x), psolvers, ss_loss=True,
                     ss_loss_abs=ss_abs, return_aux=True, train=True)
    loss = torch.nn.functional.cross_entropy(pl, torch.tensor(y)) \
        + 0.1 * aux["ss_loss"]
    names = [k for k, _ in pmodel.named_parameters()]
    pg = torch.autograd.grad(loss, list(pmodel.parameters()))
    np.testing.assert_allclose(pl.detach().numpy(), np.asarray(jl),
                               rtol=1e-5, atol=1e-5)
    ss = float(aux["ss_loss"].detach())
    assert ss > 0
    np.testing.assert_allclose(ss, float(jss), rtol=1e-5)
    jgrads = {k: v.numpy() for k, v in cifar_params_from_jax(
        jax.tree_util.tree_map(np.asarray, jg)).items()}
    for name, g in zip(names, pg):
        bar = 1e-4 * max(1e-6, np.abs(jgrads[name]).max())
        np.testing.assert_allclose(g.numpy(), jgrads[name], rtol=0,
                                   atol=bar, err_msg=name)
    # off: the aux is 0 and the logits unchanged
    pl0, aux0 = pmodel(torch.tensor(x), psolvers, return_aux=True)
    assert float(aux0["ss_loss"]) == 0.0
    torch.testing.assert_close(pl0, pl.detach(), rtol=0, atol=0)


def test_cifar_runner_flagship_options_write_checkpoints(tmp_path):
    """FGSM-random with smoothing in bf16 and the ss-loss, under the
    optimizer wrappers (clipping, every 2, the backoff), an FGSM test each
    epoch: finite losses, the checkpoints, and a resume that continues the
    step count; the attack CLI restores the wrapped optimizer's state."""
    save = str(tmp_path / "run")
    argv = CIFAR_ARGV + [
        "--adv_training_mode", "fgsm_random", "--noise_type", "normal",
        "--noise_sigma", "0.0125", "--noise_prob", "1.0", "--precision",
        "bf16", "--ss_loss", "True", "--grad_clipping_threshold", "1.0",
        "--zero_grad_every", "2", "--nan_backoff", "0.5",
        "--adv_testing_mode", "fgsm", "--activation_resblock", "GeLUpoly",
        "--save_dir", save, "--device", "cpu"]
    ts = cifar_runner.main(argv)
    assert ts.step == 8 and ts.opt_state["emits"] == 4
    with open(os.path.join(save, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    losses = [r["train_loss"] for r in recs if "train_loss" in r]
    assert len(losses) == 2 and np.isfinite(losses).all()
    assert all(r["ss_loss"] > 0 for r in recs if "train_loss" in r)
    assert len([r for r in recs if "adv_test_acc" in r]) == 2
    assert len(os.listdir(os.path.join(save, "last"))) == 2
    # a best checkpoint exists once a validation accuracy beat 0
    best = max(r.get("best_standalone_0", 0.0) for r in recs)
    assert os.path.isdir(os.path.join(save, "best_solver_0")) == (best > 0)
    ts2 = cifar_runner.main(argv[:argv.index("--nepochs") + 1] + ["1"]
                            + argv[argv.index("--nepochs") + 2:]
                            + ["--resume"])
    assert ts2.step == 12 and ts2.opt_state["count"] == 12
    rows = attacks_runner.main([
        "--checkpoints_glob", os.path.join(save, "last"), "--modes",
        "clean,at", "--epsilons", "0.03", "--pgd_niter", "1",
        "--batch_size", "8", "--max_batches", "1", "--device", "cpu",
        "--output_csv", str(tmp_path / "a.csv")])
    assert [r["mode"] for r in rows] == ["clean", "at"]


# the architecture flags of the JAX runner (cifar_runner.py:48-73): one
# step an epoch (18 training images at batch 16, 2 validate)
ARCH_ARGV = ["--in_planes", "8", "--solvers", "rk2,u,1,-1,0.5,-1",
             "--nepochs", "2", "--batch_size", "16", "--test_batch_size",
             "8", "--synthetic_train_size", "20", "--synthetic_test_size",
             "8"]
ARCH_CASES = {
    "GN": ["--network", "metanode10", "--normalization_resblock", "GN",
           "--normalization_odeblock", "GN", "--normalization_bn1", "GN",
           "--num_gn_groups", "4"],
    "BN+SN+orthogonal": [
        "--network", "premetanode10", "--normalization_resblock", "BN",
        "--normalization_bn1", "BN", "--param_normalization_resblock", "SN",
        "--param_normalization_odeblock", "SN", "--init", "orthogonal"],
    "ResNet-IN-WN-xavier": [
        "--network", "metanode6", "--is_odenet", "False",
        "--normalization_resblock", "IN", "--normalization_bn1", "LN",
        "--param_normalization_resblock", "WN",
        "--param_normalization_bn1", "WN", "--activation_resblock", "ReLU",
        "--init", "xavier"],
}


def _jax_runner_init(margs):
    """The params and state the JAX runner's ``fit`` starts from: its
    model's init at the first split of ``key(seed)``, re-initialized by
    ``--init`` at ``fold_in(k_init, 1)`` (JAX cifar_runner.py:235-247)."""
    jmodel = j_cifar_model(margs)
    _, k_init = jax.random.split(jax.random.key(margs["seed"]))
    params, state = jmodel.init(k_init)
    if margs["init"]:
        params = j_apply_init_scheme(jax.random.fold_in(k_init, 1), params,
                                     margs["init"])
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    return to_np(params), to_np(state)


def _arch_overrides(margs):
    return dict(
        is_odenet=margs["is_odenet"], in_planes=margs["in_planes"],
        norms=(margs["normalization_resblock"],
               margs["normalization_odeblock"], margs["normalization_bn1"]),
        num_gn_groups=margs["num_gn_groups"],
        param_norms=(margs["param_normalization_resblock"],
                     margs["param_normalization_odeblock"],
                     margs["param_normalization_bn1"]),
        acts=(margs["activation_resblock"], margs["activation_odeblock"],
              margs["activation_bn1"]))


def j_cifar_model(margs):
    return j_build_model(margs["network"], **_arch_overrides(margs))


@pytest.mark.parametrize("case", list(ARCH_CASES))
def test_cifar_runner_architecture_flags_match_jax(case, tmp_path):
    """Each flag set parses and builds in both runners and trains two
    epochs of one step: per-epoch train loss within 1e-4 relative,
    validation counts equal, final params within 1e-4 of max|p| and the
    model state within 3e-4 of JAX's; then the ``last`` checkpoint
    restores the run's model state bit for bit (what ``--resume`` loads)
    and it differs from where the run started wherever BN or SN keep
    one."""
    argv = ARCH_ARGV + ARCH_CASES[case]
    jdir, pdir = str(tmp_path / "jax"), str(tmp_path / "port")
    j_cifar.main(argv + ["--save_dir", jdir])
    margs = vars(cifar_runner.parse_args(argv))
    np_params, np_state = _jax_runner_init(margs)
    overrides = _arch_overrides(margs)
    seed_port_run(pdir, margs["network"], np_params,
                  optimizer_from_saved_args(margs), np_state, **overrides)
    pts = cifar_runner.main(argv + ["--save_dir", pdir, "--resume",
                                    "--device", "cpu"])
    assert pts.step == 2
    assert_runs_agree(jdir, pdir, pts, margs["network"], 2, **overrides)
    _, jts = jax_final_params(jdir, margs["network"], **overrides)
    js = cifar_state_from_jax(jax.tree_util.tree_map(np.asarray,
                                                     jts.model_state))
    assert set(js) == set(pts.model_state)
    for k, v in js.items():
        np.testing.assert_allclose(pts.model_state[k].numpy(), v.numpy(),
                                   atol=3e-4, err_msg=k)
    fresh = build_model(margs["network"], device="cpu", **overrides)
    template = create_train_state(fresh, optimizer_from_saved_args(margs))
    restored, _ = restore_checkpoint(os.path.join(pdir, "last"), template)
    assert restored.step == 2
    start = cifar_state_from_jax(np_state)
    for k, v in pts.model_state.items():
        assert torch.equal(restored.model_state[k], v), k
        assert not torch.equal(v, start[k]), k
    assert "BN" not in case or any("mean" in k for k in start)
