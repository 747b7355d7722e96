"""A fleet's members over a mesh axis, on the CPU: two gloo ranks each
carry half of an 8-member fleet (``shard_fleet``) and advance them with
the unchanged fleet step, with no collective; the members' metrics
gathered in member order (``gather_fleet``) and every member's params
equal the unsharded fleet's (mirrors JAX
``tests/test_fleet.py::test_fleet_shards_over_mesh``, 143-170).  This file
is its own worker (``tests/torch_mesh.py``).
"""
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_mesh import REPO, run_ranks, worker_main  # noqa: E402

if REPO not in sys.path:
    sys.path.insert(0, REPO)

S, BS = 8, 4


def fleet_steps(inputs, mesh=None):
    """Two steps of the 8-member fleet, whole or this rank's members;
    returns (the gathered losses of each step, this rank's params)."""
    from neural_ode_metasolver_tpu_torch.models import build_model
    from neural_ode_metasolver_tpu_torch.ops import create_solver
    from neural_ode_metasolver_tpu_torch.training import (
        create_fleet_state, fleet_generators, gather_fleet, make_optimizer,
        make_fleet_train_step, shard_fleet, stack_fleet_solvers)

    model = build_model("mnist", device="cpu", dim=8)
    opt = make_optimizer("sgd", 0.05)
    seeds = list(range(S))
    base = create_solver("rk2", "u", n_steps=2, u0=0.5)
    fts = create_fleet_state(model, opt, fleet_generators(seeds))
    x, y = torch.tensor(inputs["x"]), torch.tensor(inputs["y"])
    gens = fleet_generators([100 + s for s in seeds])
    dyn = stack_fleet_solvers([[base.with_params(u=0.5 + 0.05 * m)]
                               for m in range(S)])
    if mesh is not None:
        fts, x, y, gens, dyn = shard_fleet((fts, x, y, gens, dyn), mesh)
    step = make_fleet_train_step(model, opt, [base])
    losses = []
    for _ in range(2):
        fts, m = step(fts, x, y, gens, dyn)
        losses.append(m["loss"] if mesh is None
                      else gather_fleet(m, mesh)["loss"])
    return losses, {k: v.detach().clone() for k, v in fts.params.items()}


def run(inputs, world, rank):
    from neural_ode_metasolver_tpu_torch.parallel import make_mesh

    mesh = make_mesh({"fleet": world})
    losses, params = fleet_steps(inputs, mesh)
    return {"losses": losses, "params": params, "rank": rank}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    torch.set_num_threads(1)
    rs = np.random.RandomState(0)
    inputs = {"x": rs.rand(S, BS, 28, 28, 1).astype(np.float32),
              "y": rs.randint(0, 10, (S, BS)).astype(np.int64)}
    ranks = run_ranks(__file__, 2, inputs, tmp_path_factory.mktemp("fleet"))
    return dict(ranks=ranks, one=fleet_steps(inputs))


def test_fleet_shards_over_mesh(runs):
    """Each rank advances its 4 members; the gathered per-member losses
    of both steps equal the unsharded fleet's at rtol 2e-5 (JAX's bar),
    and member m's params on its rank equal the unsharded fleet's member
    m's."""
    losses, params = runs["one"]
    for res in runs["ranks"]:
        assert len(res["losses"]) == 2
        for got, want in zip(res["losses"], losses):
            assert got.shape == (S,)
            np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-5)
        r = res["rank"]
        for k, v in res["params"].items():
            assert v.shape[0] == S // 2
            np.testing.assert_allclose(
                v.numpy(), params[k][r * S // 2:(r + 1) * S // 2].numpy(),
                rtol=2e-5, atol=1e-7, err_msg=k)


def test_shard_fleet_cuts_members_only():
    """``shard_fleet`` on one rank of a two-rank axis (the rule needs no
    group): tensors, per-member count lists and generators, stacked u cut
    to the rank's members; the step number and a solver list's length
    stay."""
    from neural_ode_metasolver_tpu_torch.ops import create_solver
    from neural_ode_metasolver_tpu_torch.parallel import Mesh
    from neural_ode_metasolver_tpu_torch.training import (
        TrainState, shard_fleet, stack_fleet_solvers)

    mesh = Mesh({"fleet": 2}, {}, 1)
    base = create_solver("rk2", "u", n_steps=2, u0=0.5)
    dyn = stack_fleet_solvers([[base.with_params(u=0.1 * m)]
                               for m in range(4)])
    gens = [torch.Generator().manual_seed(m) for m in range(4)]
    ts = TrainState(3, {"w": torch.arange(8.).reshape(4, 2)},
                    {"count": [1, 2, 3, 4], "trace": {"w": torch.ones(4, 2)}})
    ts2, gens2, dyn2 = shard_fleet((ts, gens, dyn), mesh)
    assert ts2.step == 3
    assert torch.equal(ts2.params["w"], torch.arange(4., 8.).reshape(2, 2))
    assert ts2.opt_state["count"] == [3, 4]
    assert gens2 == gens[2:]
    assert len(dyn2) == 1
    np.testing.assert_allclose(dyn2[0].u.numpy(), [0.2, 0.3], rtol=1e-6)


if __name__ == "__main__" and sys.argv[1] == "worker":
    worker_main(run)
