"""Tensor parallelism (a ``model`` mesh axis) of the PyTorch port on the
CPU, against the JAX package's unsharded step.

Four gloo ranks form a ``data=2, model=2`` mesh (JAX's tests use
``data=4, model=2`` over 8 virtual devices) and run one step of a small
premetanode10 from JAX's init through ``make_parallel_train_step(...,
model_axis="model")`` under SGD with momentum, RMSprop, MultiSteps
(``every_k=2``) and the non-finite backoff, then a ``SolverTrainState``
step, and two steps of a GN + WN and a BN + SN net against one process;
each rank gathers its params back to the global tree.  A no-grad
exact-GELU NF forward runs B2 on the gathered kernels.  The test
process runs JAX's unsharded step on the same inputs (mirrors
``tests/test_parallel.py:83-108``, ``:140-245``, ``:360-365`` and
``:476-500``).  This file is its own worker (``tests/torch_mesh.py``).
"""
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_mesh import REPO, b2_forward, run_ranks, worker_main  # noqa: E402

if REPO not in sys.path:
    sys.path.insert(0, REPO)

P, B, HW = 16, 8, 16
LOSS_RTOL, P_ATOL, P_RTOL = 5e-5, 5e-5, 5e-4  # JAX's tp bars (:104-107)
RMS_ATOL = 2e-2  # JAX's rmsprop bar (:204)
OPTIMIZERS = {
    "sgd": ("sgd", dict(momentum=0.9)),
    "rmsprop": ("rmsprop", {}),
    "multisteps": ("sgd", dict(momentum=0.9, every_k=2)),
    "backoff": ("sgd", dict(momentum=0.9, nonfinite_backoff=0.5)),
}
# GN (B3's plain version) with WN, and BN with SN: the norms' sharded
# affines gathered, the param norms on the gathered kernel
NORM_NETS = {"gn_wn": dict(norms=("GN",) * 3, num_gn_groups=4,
                           param_norms=("WN",) * 3),
             "bn_sn": dict(norms=("BN",) * 3, param_norms=("SN",) * 3)}


def _global_params(ts):
    """The global param tree by name: each tp slice gathered."""
    from neural_ode_metasolver_tpu_torch.parallel.mesh import tp_sharding_of

    out = {}
    for k, p in ts.params.items():
        rule = tp_sharding_of(p)
        out[k] = (p if rule is None else rule.gather(p)).detach().clone()
    return out


def norm_steps(inputs, mesh=None):
    """Two FGSM-random steps of each NORM_NETS net at in_planes 8, on the
    tp axis of ``mesh`` or in one process: loss and global params."""
    from neural_ode_metasolver_tpu_torch.models import build_model
    from neural_ode_metasolver_tpu_torch.ops import create_solver
    from neural_ode_metasolver_tpu_torch.parallel import (
        batch_sharding, make_parallel_train_step)
    from neural_ode_metasolver_tpu_torch.training import (
        AttackConfig, create_train_state, make_optimizer, make_train_step)

    x, y = torch.tensor(inputs["x"]), torch.tensor(inputs["y"])
    if mesh is not None:
        x, y = batch_sharding(mesh).local((x, y))
    out = {}
    for name, kw in NORM_NETS.items():
        net = build_model("premetanode10", device="cpu", in_planes=8,
                          generator=torch.Generator().manual_seed(5), **kw)
        opt = make_optimizer("sgd", 0.05, momentum=0.9)
        ts = create_train_state(net, opt)
        step = make_train_step(
            net, opt, [create_solver("rk2", "u", n_steps=2, u0=0.5)],
            attack_cfg=AttackConfig(mode="fgsm_random", eps=8 / 255,
                                    alpha=10 / 255))
        if mesh is not None:
            step = make_parallel_train_step(step, mesh, ts,
                                            model_axis="model")
        for i in range(2):
            ts, m = step(ts, x, y, torch.Generator().manual_seed(20 + i))
        out[name] = {"loss": float(m["loss"]), "params": _global_params(ts),
                     "state": {k: v.clone() for k, v in
                               net.named_buffers()}}
    return out


def run(inputs, world, rank):
    from neural_ode_metasolver_tpu_torch.models import build_model
    from neural_ode_metasolver_tpu_torch.ops import create_solver
    from neural_ode_metasolver_tpu_torch.parallel import (
        batch_sharding, make_mesh, make_parallel_train_step)
    from neural_ode_metasolver_tpu_torch.parallel.mesh import tp_sharding_of
    from neural_ode_metasolver_tpu_torch.training import (
        create_solver_train_state, create_train_state, make_optimizer,
        make_solver_train_step, make_train_step)

    mesh = make_mesh({"data": 2, "model": 2})
    rows = batch_sharding(mesh).local
    x, y = torch.tensor(inputs["x"]), torch.tensor(inputs["y"])
    solvers = [create_solver("rk2", "u", n_steps=2, u0=0.5)]
    out = {"norms": norm_steps(inputs, mesh),
           "b2": b2_forward(rows(x), mesh, "tp")}
    for name, (opt_name, kw) in OPTIMIZERS.items():
        net = build_model("premetanode10", device="cpu", in_planes=P)
        net.load_state_dict(inputs["params"])
        opt = make_optimizer(opt_name, 0.05, **kw)
        ts = create_train_state(net, opt)
        step = make_parallel_train_step(make_train_step(net, opt, solvers),
                                        mesh, ts, model_axis="model")
        ts, m = step(ts, rows(x), rows(y), torch.Generator().manual_seed(2))
        local = {k: tuple(p.shape) for k, p in ts.params.items()}
        out[name] = {"loss": float(m["loss"]),
                     "grad_norm": float(m["grad_norm"]),
                     "params": _global_params(ts), "local": local,
                     "opt_state": ts.opt_state,
                     "marked": sorted(k for k, p in ts.params.items()
                                      if tp_sharding_of(p) is not None)}
    net = build_model("premetanode10", device="cpu", in_planes=P)
    net.load_state_dict(inputs["params"])
    opt, sopt = make_optimizer("sgd", 0.05), make_optimizer("sgd", 0.01)
    sts = create_solver_train_state(net, opt, sopt, solvers)
    step = make_parallel_train_step(
        make_solver_train_step(net, opt, sopt, solvers), mesh, sts,
        model_axis="model")
    sts, m = step(sts, rows(x), rows(y), torch.Generator().manual_seed(1))
    out["solver"] = {"loss": float(m["loss"]), "step": sts.step,
                     "u": float(m["solver0_u"]),
                     "params": _global_params(sts)}
    return out


def _one_process_solver_step(inputs):
    from neural_ode_metasolver_tpu_torch.models import build_model
    from neural_ode_metasolver_tpu_torch.ops import create_solver
    from neural_ode_metasolver_tpu_torch.training import (
        create_solver_train_state, make_optimizer, make_solver_train_step)

    net = build_model("premetanode10", device="cpu", in_planes=P)
    net.load_state_dict(inputs["params"])
    solvers = [create_solver("rk2", "u", n_steps=2, u0=0.5)]
    opt, sopt = make_optimizer("sgd", 0.05), make_optimizer("sgd", 0.01)
    sts = create_solver_train_state(net, opt, sopt, solvers)
    sts, m = make_solver_train_step(net, opt, sopt, solvers)(
        sts, torch.tensor(inputs["x"]), torch.tensor(inputs["y"]),
        torch.Generator().manual_seed(1))
    return {"loss": float(m["loss"]), "u": float(m["solver0_u"]),
            "params": {k: v.detach().clone() for k, v in sts.params.items()}}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """JAX's unsharded step for each optimizer, and the port's four ranks
    on a data=2, model=2 mesh."""
    import jax
    import jax.numpy as jnp

    from neural_ode_metasolver_tpu.models.api import build_model as jbuild
    from neural_ode_metasolver_tpu.ops import SolverOptions as JOpts
    from neural_ode_metasolver_tpu.ops import create_solver as jsolver
    from neural_ode_metasolver_tpu.training import (
        create_train_state as jstate, make_optimizer as jopt,
        make_train_step as jstep)
    from neural_ode_metasolver_tpu_torch.models import cifar_params_from_jax

    torch.set_num_threads(1)
    jmodel = jbuild("premetanode10", in_planes=P)
    rs = np.random.RandomState(1)
    x = rs.randn(B, HW, HW, 3).astype(np.float32)
    y = np.zeros(B, np.int64)
    solvers = [jsolver("rk2", "u", n_steps=2, u0=np.float32(0.5))]
    ref, params0 = {}, None
    for name, (opt_name, kw) in OPTIMIZERS.items():
        tx = jopt(opt_name, 0.05, **kw)
        ts = jstate(jmodel, tx, jax.random.key(0))
        params0 = ts.params
        raw = jstep(jmodel, tx, solvers, JOpts(), jit_compile=False,
                    donate=False)
        ts2, m = jax.jit(raw)(ts, jnp.asarray(x), jnp.asarray(y),
                              jax.random.key(2))
        ref[name] = {"loss": float(m["loss"]),
                     "params": cifar_params_from_jax(jax.tree_util.tree_map(
                         lambda a: np.asarray(a, np.float32), ts2.params))}
    inputs = {"params": cifar_params_from_jax(jax.tree_util.tree_map(
                  np.asarray, params0)), "x": x, "y": y}
    ranks = run_ranks(__file__, 4, inputs,
                      tmp_path_factory.mktemp("tp"))
    return dict(ref=ref, ranks=ranks, inputs=inputs,
                one_solver=_one_process_solver_step(inputs),
                one_norms=norm_steps(inputs),
                one_b2=b2_forward(torch.tensor(x)))


def _close(got, want, atol, rtol):
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   atol=atol, rtol=rtol, err_msg=k)


def _spec_mesh():
    """A data=4, model=2 mesh as rank 0 sees it; the rules need no group."""
    from neural_ode_metasolver_tpu_torch.parallel import Mesh

    return Mesh({"data": 4, "model": 2}, {}, 0)


def test_shard_params_tp_specs():
    """Conv kernels shard their output channels (mirrors JAX
    ``test_shard_params_tp_specs``), on the nested tree and on a train
    state's flat names alike."""
    from neural_ode_metasolver_tpu_torch.models import build_model
    from neural_ode_metasolver_tpu_torch.parallel import shard_params_tp

    net = build_model("premetanode10", device="cpu", in_planes=P)
    sh = shard_params_tp(net.detached_params(), _spec_mesh(), "model")
    assert sh["conv1"]["kernel"].spec == (None, None, None, "model")
    assert sh["fc"]["kernel"].spec == (None, "model")
    assert sh["fc"]["bias"].spec == ("model",)
    flat = shard_params_tp(dict(net.named_parameters()), _spec_mesh())
    assert flat["params.conv1.kernel"].spec == (None, None, None, "model")


def test_shard_opt_state_tp_structure_matching():
    """A param-mirroring subtree inherits the param rules; a divisible
    bookkeeping vector and the counts replicate (mirrors JAX
    ``test_shard_opt_state_tp_structure_matching``)."""
    from neural_ode_metasolver_tpu_torch.models import build_model
    from neural_ode_metasolver_tpu_torch.parallel import shard_opt_state_tp

    net = build_model("premetanode10", device="cpu", in_planes=P)
    params = net.detached_params()
    mirror = torch.utils._pytree.tree_map(torch.zeros_like, params)
    fake = (mirror, {"loss_history": torch.zeros(8), "count": 0})
    mirror_sh, book_sh = shard_opt_state_tp(fake, params, _spec_mesh(),
                                            "model")
    assert mirror_sh["conv1"]["kernel"].spec == (None, None, None, "model")
    assert book_sh["loss_history"].spec == ()
    assert book_sh["count"].spec == ()


def test_shard_params_tp_ignores_unnamed_divisible_leaves():
    """Only leaves named kernel/bias/scale shard (mirrors JAX
    ``test_shard_params_tp_ignores_unnamed_divisible_leaves``); the
    slice and gather helpers round-trip a tree on one rank."""
    from neural_ode_metasolver_tpu_torch.parallel import (
        gather_tree, shard_params_tp, shard_tree)

    tree = {"block": {"kernel": torch.arange(3 * 3 * 4 * 8.).reshape(
                3, 3, 4, 8), "bias": torch.arange(8.)},
            "buffer": torch.zeros(4, 8), "running_var": torch.zeros(8)}
    sh = shard_params_tp(tree, _spec_mesh(), "model")
    assert sh["block"]["kernel"].spec == (None, None, None, "model")
    assert sh["block"]["bias"].spec == ("model",)
    assert sh["buffer"].spec == ()
    assert sh["running_var"].spec == ()
    local = shard_tree(tree, sh)  # rank 0: the first half of each dim
    assert local["block"]["kernel"].shape == (3, 3, 4, 4)
    assert torch.equal(local["block"]["bias"], torch.arange(4.))
    assert torch.equal(local["buffer"], tree["buffer"])
    assert gather_tree(tree, shard_params_tp(tree, _spec_mesh(), "data")) \
        ["buffer"] is tree["buffer"]


@pytest.mark.parametrize("name", list(OPTIMIZERS))
def test_tp_step_matches_jax_unsharded(runs, name):
    """One tp step on data=2, model=2 against JAX's unsharded step:
    loss at rtol 5e-5, every param leaf at atol 5e-5 rtol 5e-4 (RMSprop:
    atol 2e-2, its first update being ~lr sign(g)); every rank gathers
    the same params; the tp leaves are this rank's halves (mirrors JAX
    ``test_tp_sharded_step_runs_and_matches``, ``test_tp_with_rmsprop``,
    ``test_tp_with_multisteps``, ``test_tp_with_nonfinite_backoff``)."""
    ref = runs["ref"][name]
    atol = RMS_ATOL if name == "rmsprop" else P_ATOL
    for res in runs["ranks"]:
        got = res[name]
        assert got["loss"] == pytest.approx(ref["loss"], rel=LOSS_RTOL)
        _close(got["params"], ref["params"], atol, P_RTOL)
        assert got["local"]["params.conv1.kernel"] == (3, 3, 3, P // 2)
        assert got["local"]["params.fc.kernel"] == (8 * P // 4, 5)
        assert "params.layer1.ode.0.conv1.kernel" in got["marked"]
    a, b = (r[name]["params"] for r in runs["ranks"][:2])
    assert all(torch.equal(a[k], b[k]) for k in a)


def test_tp_opt_state_shards_mirrors_and_replicates_counts(runs):
    """Momentum, RMS nu and MultiSteps' acc hold this rank's slices; the
    counts and the backoff's scale stay numbers every rank shares."""
    for res in runs["ranks"]:
        sgd = res["sgd"]["opt_state"]
        bufs = [v for v in sgd.values() if isinstance(v, dict)]
        assert bufs and all(
            tuple(b["params.conv1.kernel"].shape) == (3, 3, 3, P // 2)
            for b in bufs)
        ms = res["multisteps"]["opt_state"]
        assert ms["mini_step"] == 1 and ms["emits"] == 0
        assert tuple(ms["acc"]["params.fc.bias"].shape) == (5,)
        bo = res["backoff"]["opt_state"]
        assert bo["n_skipped"] == 0 and isinstance(bo["scale"], float)
        assert res["sgd"]["opt_state"]["count"] == 1


def test_tp_wraps_solver_train_state(runs):
    """A SolverTrainState step under the tp axis runs, advances and
    equals one process's step (mirrors JAX
    ``test_tp_wraps_solver_train_state``)."""
    one = runs["one_solver"]
    for res in runs["ranks"]:
        got = res["solver"]
        assert np.isfinite(got["loss"]) and got["step"] == 1
        assert got["loss"] == pytest.approx(one["loss"], rel=LOSS_RTOL)
        assert got["u"] == pytest.approx(one["u"], rel=1e-5)
        _close(got["params"], one["params"], P_ATOL, P_RTOL)


@pytest.mark.parametrize("name", list(NORM_NETS))
def test_tp_norms_and_param_norms_match_one_process(runs, name):
    """GN with WN and BN with SN under the tp axis: two FGSM-random steps
    equal one process's (loss rtol 5e-5, params and the model state, BN's
    running statistics and SN's vectors, atol 5e-5 rtol 5e-4)."""
    one = runs["one_norms"][name]
    for res in runs["ranks"]:
        got = res["norms"][name]
        assert got["loss"] == pytest.approx(one["loss"], rel=LOSS_RTOL)
        _close(got["params"], one["params"], P_ATOL, P_RTOL)
        _close(got["state"], one["state"], P_ATOL, P_RTOL)
        assert bool(got["state"]) == (name == "bn_sn")  # GN/WN keep none


def test_tp_no_grad_forward_runs_b2_on_gathered_kernels(runs):
    """A no-grad exact-GELU NF forward under the tp axis gathers each ODE
    block's kernels and runs B2 once a block on the whole channels, as
    one process does; its logits equal one process's (atol 1e-5, rtol
    1e-4) on this rank's rows of the data axis."""
    one = runs["one_b2"]
    assert len(one["b2_inputs"]) == 2
    for r, res in enumerate(runs["ranks"]):
        got = res["b2"]
        assert got["b2_inputs"] == [(B // 2,) + s[1:]
                                    for s in one["b2_inputs"]]
        rows = slice((r // 2) * (B // 2), (r // 2 + 1) * (B // 2))
        np.testing.assert_allclose(got["logits"].numpy(),
                                   one["logits"][rows].numpy(),
                                   atol=1e-5, rtol=1e-4)


if __name__ == "__main__" and sys.argv[1] == "worker":
    worker_main(run)
