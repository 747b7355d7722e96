"""Ensemble parallelism of the PyTorch port on the CPU against the JAX
package: ``ensemble_integrate`` (the members on one axis, custom grids,
the homogeneity checks) and the mesh-sharded ensemble evaluation
(``accuracy_ensemble`` and ``adversarial_accuracy_ensemble`` with
``mesh=``), each against JAX's counterpart and the port's member loop, and
a two-process gloo run with an ``ensemble`` axis of 2 against the one-rank
result.

This file is its own worker: ``python tests/test_torch_parallel_ensemble.py
worker PORT RANK IN OUT`` (no JAX, one torch thread).  The MNIST MetaNODE
at dim 16 with JAX's init (``models/convert.py``), RK2 in 2 steps, four
members from JAX's ``solver_ensemble_by_noising`` (std 0.2) whose u the
port's members take, 48 seeded images labelled by JAX's standalone
predictions.
"""
import os
import sys

import numpy as np
import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
if REPO not in sys.path:
    sys.path.insert(0, REPO)
if HERE not in sys.path:
    sys.path.insert(0, HERE)

from test_torch_parallel_dp import free_port, launch  # noqa: E402

ATOL = 1e-6  # JAX's ensemble bars (test_parallel.py:247, :650)
PROB_BAR = 1e-4  # the port's f32 logit bar against JAX
DIM, N, EPS = 16, 48, 0.1


def _rhs(t, y):
    return -0.7 * y + 0.1 * torch.sin(t)


def _y0():
    return np.random.RandomState(0).randn(4, 8).astype(np.float32)


# --------------------------------------------------- ensemble_integrate


def test_ensemble_integrate_matches_loop():
    """Weighted members on one axis against the port's member loop and
    JAX's vmapped ``ensemble_integrate``, each member's own stage times
    reaching the rhs."""
    import jax.numpy as jnp

    from neural_ode_metasolver_tpu.ops import create_solver as jsolver
    from neural_ode_metasolver_tpu.parallel import (
        ensemble_integrate as j_ensemble_integrate)
    from neural_ode_metasolver_tpu_torch.ops import create_solver
    from neural_ode_metasolver_tpu_torch.parallel import ensemble_integrate

    us, weights = (0.5, 0.7, 1.0), [0.5, 0.3, 0.2]
    y0 = _y0()
    solvers = [create_solver("rk2", "u", n_steps=4, u0=u) for u in us]
    out = ensemble_integrate(solvers, _rhs, torch.tensor(y0), weights)
    loop = sum(w * s.integrate_final(_rhs, torch.tensor(y0))
               for w, s in zip(weights, solvers))
    jout = j_ensemble_integrate(
        [jsolver("rk2", "u", n_steps=4, u0=np.float32(u)) for u in us],
        lambda t, y: -0.7 * y + 0.1 * jnp.sin(t), jnp.asarray(y0), weights)
    np.testing.assert_allclose(out.numpy(), loop.numpy(), atol=ATOL)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=ATOL)


@pytest.mark.parametrize("method", ["rk2", "rk4"])
def test_ensemble_integrate_sharded(method):
    """With a mesh of one rank on the ``ensemble`` axis the result is the
    unsharded one bit for bit (no collective runs), and both match JAX's
    sharded run on its 4x2 mesh (mirrors ``:262``)."""
    import jax
    import jax.numpy as jnp

    from neural_ode_metasolver_tpu.ops import create_solver as jsolver
    from neural_ode_metasolver_tpu.parallel import (
        ensemble_integrate as j_ensemble_integrate, make_mesh as j_make_mesh)
    from neural_ode_metasolver_tpu_torch.ops import create_solver
    from neural_ode_metasolver_tpu_torch.parallel import (
        ensemble_integrate, make_mesh)

    us = (0.4, 0.5, 0.6, 0.7)
    param = "u" if method == "rk2" else "u3"
    solvers = [create_solver(method, param, n_steps=4, u0=u) for u in us]
    y0 = torch.ones(8, 16)
    rhs = lambda t, y: -0.5 * y  # noqa: E731
    mesh = make_mesh({"ensemble": 1})
    out = ensemble_integrate(solvers, rhs, y0, mesh=mesh)
    assert torch.equal(out, ensemble_integrate(solvers, rhs, y0))
    jmesh = j_make_mesh({"ensemble": 4, "data": 2})
    jsolvers = [jsolver(method, param, n_steps=4, u0=np.float32(u))
                for u in us]
    jout = jax.jit(lambda y: j_ensemble_integrate(
        jsolvers, lambda t, yy: -0.5 * yy, y, mesh=jmesh,
        member_axis="ensemble"))(jnp.ones((8, 16), jnp.float32))
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=ATOL)


def test_ensemble_integrate_rejects_heterogeneous():
    """Mixed step counts and an euler ensemble raise ValueError, as JAX's
    (mirrors ``:282``)."""
    from neural_ode_metasolver_tpu_torch.ops import create_solver
    from neural_ode_metasolver_tpu_torch.parallel import ensemble_integrate

    rhs = lambda t, y: y  # noqa: E731
    mixed = [create_solver("rk2", "u", n_steps=4, u0=0.5),
             create_solver("rk2", "u", n_steps=8, u0=0.5)]
    with pytest.raises(ValueError, match="homogeneous"):
        ensemble_integrate(mixed, rhs, torch.ones(2))
    frozen = [mixed[0], mixed[0].unfreeze()]
    with pytest.raises(ValueError, match="homogeneous"):
        ensemble_integrate(frozen, rhs, torch.ones(2))
    with pytest.raises(ValueError, match="parametric solver family"):
        ensemble_integrate([create_solver("euler", n_steps=2)] * 2, rhs,
                           torch.ones(2))


def test_ensemble_integrate_custom_grid():
    """custom_grid takes precedence over n_steps, as the solver's grid
    does; mixed grids raise (mirrors ``:650``)."""
    import jax.numpy as jnp

    from neural_ode_metasolver_tpu.ops import create_solver as jsolver
    from neural_ode_metasolver_tpu.parallel import (
        ensemble_integrate as j_ensemble_integrate)
    from neural_ode_metasolver_tpu_torch.ops import create_solver
    from neural_ode_metasolver_tpu_torch.parallel import ensemble_integrate

    grid = (0.0, 0.25, 1.0)
    solvers = [create_solver("rk2", "u", n_steps=4, u0=u).replace(
        n_steps=None, custom_grid=grid) for u in (0.5, 1.0)]
    y0 = np.random.RandomState(0).rand(3, 4).astype(np.float32)
    rhs = lambda t, y: -y  # noqa: E731
    out = ensemble_integrate(solvers, rhs, torch.tensor(y0), [0.6, 0.4])
    loop = sum(w * s.integrate_final(rhs, torch.tensor(y0))
               for w, s in zip([0.6, 0.4], solvers))
    jout = j_ensemble_integrate(
        [jsolver("rk2", "u", n_steps=4, u0=np.float32(u)).replace(
            n_steps=None, custom_grid=grid) for u in (0.5, 1.0)],
        rhs, jnp.asarray(y0), [0.6, 0.4])
    np.testing.assert_allclose(out.numpy(), loop.numpy(), atol=ATOL)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=ATOL)
    mixed = [solvers[0], solvers[1].replace(custom_grid=(0.0, 1.0))]
    with pytest.raises(ValueError, match="homogeneous"):
        ensemble_integrate(mixed, rhs, torch.tensor(y0))


# ------------------------------------------ mesh-sharded ensemble eval


def _port_members(params, us):
    from neural_ode_metasolver_tpu_torch.models import build_model
    from neural_ode_metasolver_tpu_torch.ops import (SolverOptions,
                                                     create_solver)

    model = build_model("mnist", device="cpu", dim=DIM)
    model.load_state_dict(params)
    base = create_solver("rk2", "u", n_steps=2, u0=0.5)
    return [(model, [base.replace(u=torch.tensor(u, dtype=torch.float32))],
             SolverOptions()) for u in us]


def _batches(inputs):
    x, y = inputs["x"], inputs["y"]
    return [(x[i:i + 16], y[i:i + 16]) for i in range(0, N, 16)]


def port_results(inputs, mesh):
    """Clean and FGSM accuracy, the first batch's averaged and attacked
    probabilities, and a sharded ``ensemble_integrate``, under ``mesh``."""
    from neural_ode_metasolver_tpu_torch.ops import create_solver
    from neural_ode_metasolver_tpu_torch.parallel import ensemble_integrate
    from neural_ode_metasolver_tpu_torch.training import (
        AttackConfig, accuracy_ensemble, adversarial_accuracy_ensemble,
        make_ensemble_attacked_probs, make_ensemble_probs)

    members = _port_members(inputs["params"], inputs["us"])
    atk = AttackConfig(mode="fgsm", eps=EPS)
    x0 = torch.tensor(inputs["x"][:16])
    y0 = torch.tensor(inputs["y"][:16])
    solvers = [create_solver("rk2", "u", n_steps=4, u0=u)
               for u in (0.4, 0.5, 0.6, 0.7)]
    return {
        "acc": accuracy_ensemble(members, _batches(inputs), mesh=mesh),
        "adv": adversarial_accuracy_ensemble(
            members, _batches(inputs), atk, torch.Generator().manual_seed(2),
            mesh=mesh),
        "adv_remat": adversarial_accuracy_ensemble(
            members, _batches(inputs), atk, torch.Generator().manual_seed(2),
            mesh=mesh, remat=True),
        "probs": make_ensemble_probs(members, mesh=mesh)(x0),
        "attacked": make_ensemble_attacked_probs(members, atk, mesh=mesh)(
            x0, y0),
        "integrate": ensemble_integrate(solvers, _rhs,
                                        torch.tensor(_y0()), mesh=mesh),
    }


def worker(port, rank, in_path, out_path):
    torch.set_num_threads(1)
    from neural_ode_metasolver_tpu_torch.parallel import (
        initialize_distributed, make_mesh)

    initialize_distributed(f"localhost:{port}", 2, rank, device="cpu")
    inputs = torch.load(in_path, weights_only=False)
    out = port_results(inputs, make_mesh({"ensemble": 2}))
    torch.save(out, out_path)
    torch.distributed.destroy_process_group()


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    import jax
    import jax.numpy as jnp

    from neural_ode_metasolver_tpu.models.api import build_model as jbuild
    from neural_ode_metasolver_tpu.ops import SolverOptions as JOpts
    from neural_ode_metasolver_tpu.ops import create_solver as jsolver
    from neural_ode_metasolver_tpu.ops import (
        solver_ensemble_by_noising as j_noising)
    from neural_ode_metasolver_tpu_torch.models import mnist_params_from_jax

    jmodel = jbuild("mnist", dim=DIM)
    params, state = jmodel.init(jax.random.key(0))
    base = jsolver("rk2", "u", n_steps=2, u0=np.float32(0.5))
    x = np.random.RandomState(7).rand(N, 28, 28, 1).astype(np.float32)
    logits = jmodel.apply(params, state, jnp.asarray(x), [base], JOpts(),
                          train=False)[0]
    y = np.asarray(jnp.argmax(logits, -1)).astype(np.int64)
    noised = j_noising(base, jax.random.key(5), ensemble_size=4, std=0.2,
                       noise_type="normal")
    jmembers = [(params, state, [s], JOpts()) for s in noised]
    inputs = {"params": mnist_params_from_jax(jax.tree_util.tree_map(
                  np.asarray, params)),
              "us": [float(s.u) for s in noised], "x": x, "y": y}
    return dict(jmodel=jmodel, jmembers=jmembers, inputs=inputs,
                tmp=tmp_path_factory.mktemp("ens"))


def test_mesh_sharded_ensemble_eval_matches_loop(setup):
    """The members on the member axis (a one-rank ``ensemble`` mesh)
    against the port's member loop and against JAX's mesh path on its
    4-device mesh: clean and FGSM accuracies at 1e-6 (FGSM against JAX:
    one image of 48 may flip on a sign step of an ulp-sized gradient, as in
    ``test_torch_regime_eval``), averaged probabilities at 1e-4; remat
    changes nothing; heterogeneous members raise (mirrors
    ``test_training.py:371``)."""
    import jax
    import jax.numpy as jnp

    from neural_ode_metasolver_tpu.parallel import make_mesh as jmake_mesh
    from neural_ode_metasolver_tpu.training import (
        AttackConfig as JAttack, accuracy_ensemble as j_acc,
        adversarial_accuracy_ensemble as j_adv,
        make_ensemble_probs as j_probs)
    from neural_ode_metasolver_tpu_torch.ops import create_solver
    from neural_ode_metasolver_tpu_torch.parallel import make_mesh
    from neural_ode_metasolver_tpu_torch.training import (
        AttackConfig, accuracy_ensemble, adversarial_accuracy_ensemble)

    s, inputs = setup, setup["inputs"]
    torch.set_num_threads(1)
    mesh = make_mesh({"ensemble": 1})
    res = port_results(inputs, mesh)
    members = _port_members(inputs["params"], inputs["us"])
    loop_acc = accuracy_ensemble(members, _batches(inputs))
    loop_adv = adversarial_accuracy_ensemble(
        members, _batches(inputs), AttackConfig(mode="fgsm", eps=EPS),
        torch.Generator().manual_seed(2))
    assert res["acc"] == pytest.approx(loop_acc, abs=1e-6)
    assert res["adv"] == pytest.approx(loop_adv, abs=1e-6)
    assert res["adv_remat"] == pytest.approx(loop_adv, abs=1e-6)

    jmesh = jmake_mesh({"ensemble": 4}, jax.devices()[:4])
    jdata = [(jnp.asarray(a), jnp.asarray(b)) for a, b in _batches(inputs)]
    j_clean = j_acc(s["jmodel"], s["jmembers"], iter(jdata), mesh=jmesh)
    j_fgsm = j_adv(s["jmodel"], s["jmembers"], iter(jdata),
                   JAttack(mode="fgsm", eps=EPS), jax.random.key(2),
                   mesh=jmesh)
    assert res["acc"] == pytest.approx(j_clean, abs=1e-6)
    assert abs(round(res["adv"] * N) - round(j_fgsm * N)) <= 1
    jp = j_probs(s["jmodel"], s["jmembers"], mesh=jmesh)(
        s["jmembers"], jdata[0][0], [None] * 4)
    np.testing.assert_allclose(res["probs"].numpy(), np.asarray(jp),
                               atol=PROB_BAR)

    het = members[:1] + [(members[0][0], [create_solver(
        "rk2", "u", n_steps=4, u0=0.7)], members[0][2])]
    with pytest.raises(ValueError, match="homogeneous"):
        accuracy_ensemble(het, _batches(inputs), mesh=mesh)


def test_two_ranks_on_the_ensemble_axis_equal_one(setup):
    """Two gloo ranks, two members each: accuracies, averaged and attacked
    probabilities and ``ensemble_integrate`` equal the one-rank mesh's."""
    from neural_ode_metasolver_tpu_torch.parallel import make_mesh

    tmp = setup["tmp"]
    in_path = str(tmp / "inputs.pt")
    torch.save(setup["inputs"], in_path)
    port = free_port()
    outs = [str(tmp / f"rank{r}.pt") for r in range(2)]
    launch([[__file__, "worker", str(port), str(r), in_path, outs[r]]
            for r in range(2)])
    torch.set_num_threads(1)
    one = port_results(setup["inputs"], make_mesh({"ensemble": 1}))
    for o in outs:
        two = torch.load(o, weights_only=False)
        for k in ("acc", "adv", "adv_remat"):
            assert two[k] == pytest.approx(one[k], abs=1e-6), k
        for k in ("probs", "attacked", "integrate"):
            np.testing.assert_allclose(two[k].numpy(), one[k].numpy(),
                                       atol=ATOL, err_msg=k)


if __name__ == "__main__" and sys.argv[1:2] == ["worker"]:
    worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5])
