"""Spatial parallelism (an ``sp`` mesh axis) of the PyTorch port on the
CPU, against the JAX package's unsharded step and the port's one-process
step.

Four gloo ranks form a ``data=2, sp=2`` mesh (JAX's test uses ``data=4,
sp=2`` over 8 virtual devices): each keeps its rows of the batch and of
the height through ``make_parallel_train_step(..., spatial_axis="sp")``.
Scenarios: a small premetanode10 and its GroupNorm variant (B3's plain
version under sp, on the gathered rows with the whole height's
statistics) from JAX's init, one clean SGD step each against JAX's
unsharded step with every param leaf compared (mirrors
``tests/test_parallel.py:110-138``); the flagship recipe's draws (FGSM
with a random start, data noise) and BatchNorm in every slot over two
steps, and the MNIST net (its downsampling on whole images, the ODE block
on the rows), against the port's one-process step; a no-grad exact-GELU NF
forward, whose ODE blocks run B2 on the gathered rows, against one
process's.  This file is its own worker (``tests/torch_mesh.py``).
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
LOSS_RTOL, P_ATOL, P_RTOL = 5e-5, 5e-5, 5e-4  # JAX's sp bars (:130-137)
NETS = {"nf": {}, "gn": dict(norms=("GN",) * 3, num_gn_groups=4)}


def _params(model):
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def scenarios(inputs, mesh=None):
    """Every scenario; ``mesh`` (data x sp over the ranks) makes each step
    parallel on this rank's rows, None runs one process."""
    from neural_ode_metasolver_tpu_torch.models import build_model
    from neural_ode_metasolver_tpu_torch.ops import create_solver
    from neural_ode_metasolver_tpu_torch.parallel import (
        batch_sharding, make_parallel_train_step)
    from neural_ode_metasolver_tpu_torch.training import (
        AttackConfig, LossConfig, create_train_state, make_optimizer,
        make_train_step)

    rows = (lambda t: t) if mesh is None else batch_sharding(mesh).local
    par = ((lambda step: step) if mesh is None else
           (lambda step: make_parallel_train_step(step, mesh,
                                                  spatial_axis="sp")))
    solvers = [create_solver("rk2", "u", n_steps=2, u0=0.5)]
    x, y = torch.tensor(inputs["x"]), torch.tensor(inputs["y"])
    out = {}
    for name, kw in NETS.items():
        net = build_model("premetanode10", device="cpu", in_planes=P, **kw)
        net.load_state_dict(inputs[name])
        opt = make_optimizer("sgd", 0.05, momentum=0.9)
        ts = create_train_state(net, opt)
        ts, m = par(make_train_step(net, opt, solvers))(
            ts, rows(x), rows(y), torch.Generator().manual_seed(2))
        out[name] = {"loss": float(m["loss"]), **_params(net)}

    # the draws at the global shape, BN's statistics over data x sp
    net = build_model("premetanode10", device="cpu", in_planes=8,
                      norms=("BN",) * 3,
                      generator=torch.Generator().manual_seed(3))
    opt = make_optimizer("sgd", 0.05, momentum=0.9)
    ts = create_train_state(net, opt)
    step = par(make_train_step(
        net, opt, solvers, attack_cfg=AttackConfig(
            mode="fgsm_random", eps=8 / 255, alpha=10 / 255),
        loss_cfg=LossConfig(ss_loss=True, data_noise_std=0.01)))
    for i in range(2):
        ts, m = step(ts, rows(x), rows(y), torch.Generator().manual_seed(9 + i))
    out["bn"] = {"loss": float(m["loss"]), "ss_loss": float(m["ss_loss"]),
                 **_params(net)}

    # MNIST: the downsampling on whole images, the ODE block on the rows
    mx = torch.tensor(inputs["mx"])
    net = build_model("mnist", device="cpu", dim=8,
                      generator=torch.Generator().manual_seed(4))
    opt = make_optimizer("sgd", 0.05, momentum=0.9)
    ts = create_train_state(net, opt)
    ts, m = par(make_train_step(
        net, opt, solvers, attack_cfg=AttackConfig(
            mode="at", eps=0.3, pgd_lr=0.05, pgd_niter=1)))(
        ts, rows(mx), rows(y), torch.Generator().manual_seed(6))
    out["mnist"] = {"loss": float(m["loss"]), **_params(net)}
    return out


def run(inputs, world, rank):
    from neural_ode_metasolver_tpu_torch.parallel import make_mesh

    from neural_ode_metasolver_tpu_torch.parallel import batch_sharding

    mesh = make_mesh({"data": 2, "sp": 2})
    out = scenarios(inputs, mesh)
    out["b2"] = b2_forward(batch_sharding(mesh).local(
        torch.tensor(inputs["x"])), mesh, "sp")
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """JAX's unsharded step for both nets, the port's scenarios in one
    process and on four ranks."""
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
    rs = np.random.RandomState(1)
    x = rs.randn(B, HW, HW, 3).astype(np.float32)
    y = np.zeros(B, np.int64)
    inputs = {"x": x, "y": y,
              "mx": rs.rand(B, 28, 28, 1).astype(np.float32)}
    solvers = [jsolver("rk2", "u", n_steps=2, u0=np.float32(0.5))]
    ref = {}
    conv = lambda t: cifar_params_from_jax(jax.tree_util.tree_map(  # noqa
        lambda a: np.asarray(a, np.float32), t))
    for name, kw in NETS.items():
        jmodel = jbuild("premetanode10", in_planes=P, **kw)
        tx = jopt("sgd", 0.05, momentum=0.9)
        ts = jstate(jmodel, tx, jax.random.key(0))
        inputs[name] = conv(ts.params)
        raw = jstep(jmodel, tx, solvers, JOpts(), jit_compile=False,
                    donate=False)
        ts2, m = jax.jit(raw)(ts, jnp.asarray(x), jnp.asarray(y),
                              jax.random.key(2))
        ref[name] = {"loss": float(m["loss"]), **conv(ts2.params)}
    ranks = run_ranks(__file__, 4, inputs, tmp_path_factory.mktemp("sp"))
    return dict(ref=ref, ranks=ranks, one=scenarios(inputs),
                one_b2=b2_forward(torch.tensor(x)))


def _close(got, want, atol=P_ATOL, rtol=P_RTOL):
    keys = [k for k in want if k not in ("loss", "ss_loss")]
    assert keys and set(keys) <= set(got)
    for k in keys:
        np.testing.assert_allclose(np.asarray(got[k]), np.asarray(want[k]),
                                   atol=atol, rtol=rtol, err_msg=k)


@pytest.mark.parametrize("name", list(NETS))
def test_sp_spatial_sharding_matches_jax_unsharded(runs, name):
    """data=2 x sp=2 against JAX's unsharded step: loss at rtol 5e-5 and
    every param leaf at atol 5e-5 rtol 5e-4 (mirrors JAX
    ``test_sp_spatial_sharding_matches_single_device``); the GN net runs
    B3's plain version on the gathered rows under sp."""
    ref = runs["ref"][name]
    for res in runs["ranks"]:
        got = res[name]
        assert got["loss"] == pytest.approx(ref["loss"], rel=LOSS_RTOL)
        _close(got, ref)
        _close(got, runs["one"][name])


def test_sp_draws_and_batch_norm_match_one_process(runs):
    """FGSM's random start and the data noise drawn at the global shape
    and sliced by batch and height rows, the ss-loss's norms summed over
    the rows, BN's statistics over data x sp: two steps on four ranks
    equal one process's."""
    one = runs["one"]["bn"]
    for res in runs["ranks"]:
        got = res["bn"]
        for k in ("loss", "ss_loss"):
            assert got[k] == pytest.approx(one[k], rel=LOSS_RTOL)
        assert any(k.endswith(".var") for k in got)
        _close(got, one)


def test_sp_mnist_matches_one_process(runs):
    """The MNIST net under sp (whole-image downsampling, the 6x6 map's
    rows split for the ODE block and the head) equals one process's
    PGD step."""
    one = runs["one"]["mnist"]
    for res in runs["ranks"]:
        assert res["mnist"]["loss"] == pytest.approx(one["loss"],
                                                     rel=LOSS_RTOL)
        _close(res["mnist"], one)


def test_sp_no_grad_forward_runs_b2_on_gathered_rows(runs):
    """A no-grad exact-GELU NF forward under the sp axis gathers each ODE
    block's rows and runs B2 once a block on the whole height, as one
    process does, each rank keeping its rows; the logits equal one
    process's (atol 1e-5, rtol 1e-4) on this rank's rows of the data
    axis."""
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
