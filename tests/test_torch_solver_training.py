"""Trainable solver coefficients in the port (``training/solver_training.py``)
against the JAX package's, and the JAX tests' bars on the port, on the CPU.

Parity: ``make_solver_train_step`` and JAX's from the same params (the MNIST
MetaNODE at dim 16, batch 8, SGD momentum 0.9 on the net, SGD at lr_uv on
u/v), two steps under the clean attack and under FGSM (eps 0.1; FGSM draws
nothing), for RK2 (u) and RK3 (u, v) over 2 steps: loss within 1e-5, u and
v within 1e-6, ``solver_grad_norm`` within 1e-4 relative, params within
1e-4 of max|p|.  Then the port alone: u moves and stays in [1e-3, 1] from
boundary starts, rk3's u and v both train, rk4's u never parks at 1,
``solvers_from_state`` round-trips, a frozen solver's u gets no gradient,
``dynamic_solvers`` equals a step built with those solvers bit for bit, and
a ``SolverTrainState`` checkpoint restores bit for bit."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neural_ode_metasolver_tpu.models.api import build_model as j_build_model
from neural_ode_metasolver_tpu.ops import SolverOptions as JSolverOptions
from neural_ode_metasolver_tpu.ops import create_solver as j_create_solver
from neural_ode_metasolver_tpu.training import (
    AttackConfig as JAttackConfig,
    create_solver_train_state as j_create_solver_train_state,
    make_optimizer as j_make_optimizer,
    make_solver_train_step as j_make_solver_train_step,
)
from neural_ode_metasolver_tpu_torch.models import (
    build_model,
    mnist_params_from_jax,
)
from neural_ode_metasolver_tpu_torch.ops import SolverOptions, create_solver
from neural_ode_metasolver_tpu_torch.training import (
    AttackConfig,
    create_solver_train_state,
    create_train_state,
    make_eval_step,
    make_optimizer,
    make_solver_train_step,
    make_train_step,
    restore_checkpoint,
    save_checkpoint,
    solvers_from_state,
)
from test_torch_runners import one_torch_thread  # noqa: F401 (autouse)

DIM, B = 16, 8
OPTS = SolverOptions()


def _batch(seed, n=B):
    rs = np.random.RandomState(seed)
    return (rs.rand(n, 28, 28, 1).astype(np.float32),
            rs.randint(0, 10, size=n))


SPECS = {"rk2": ("rk2", "u", 0.5, None), "rk3": ("rk3", "uv", 0.3, 0.7)}
PARITY = [("clean", "rk2"), ("fgsm", "rk2"), ("clean", "rk3")]


@pytest.mark.parametrize("mode,solver", PARITY,
                         ids=[f"{m}-{s}" for m, s in PARITY])
def test_solver_train_step_matches_jax(mode, solver):
    method, par, u0, v0 = SPECS[solver]
    jsolvers = [j_create_solver(method, par, n_steps=2, u0=np.float32(u0),
                                v0=None if v0 is None else np.float32(v0))]
    psolvers = [create_solver(method, par, n_steps=2, u0=u0, v0=v0)]
    jmodel = j_build_model("mnist", dim=DIM)
    jtx, jstx = (j_make_optimizer("sgd", 0.05, momentum=0.9),
                 j_make_optimizer("sgd", 0.01))
    jts = j_create_solver_train_state(jmodel, jtx, jstx, jsolvers,
                                      jax.random.key(0))
    jstep = j_make_solver_train_step(
        jmodel, jtx, jstx, jsolvers, JSolverOptions(),
        attack_cfg=JAttackConfig(mode=mode, eps=0.1), donate=False)
    pmodel = build_model("mnist", device="cpu", dim=DIM)
    opt, sopt = (make_optimizer("sgd", 0.05, momentum=0.9),
                 make_optimizer("sgd", 0.01))
    pts = create_solver_train_state(pmodel, opt, sopt, psolvers,
                                    mnist_params_from_jax(
                                        jax.tree_util.tree_map(
                                            np.asarray, jts.params)))
    pstep = make_solver_train_step(pmodel, opt, sopt, psolvers, OPTS,
                                   attack_cfg=AttackConfig(mode=mode,
                                                           eps=0.1))
    for i in range(2):
        x, y = _batch(10 + i)
        jts, jm = jstep(jts, jnp.asarray(x), jnp.asarray(y),
                        jax.random.key(i))
        pts, pm = pstep(pts, torch.tensor(x), torch.tensor(y),
                        torch.Generator().manual_seed(i))
        assert abs(float(jm["loss"]) - pm["loss"].item()) < 1e-5, i
        rel = abs(float(jm["solver_grad_norm"])
                  - pm["solver_grad_norm"].item()) / float(
                      jm["solver_grad_norm"])
        assert rel < 1e-4, (i, rel)
        for k in ("u", "v"):
            if jts.solver_params[0][k] is not None:
                assert abs(float(jts.solver_params[0][k])
                           - pts.solver_params[0][k].item()) < 1e-6, (i, k)
                assert pm[f"solver0_{k}"].item() == \
                    pts.solver_params[0][k].item()
    assert set(pm) == set(jm)
    assert pts.step == 2
    jp = mnist_params_from_jax(jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32), jts.params))
    bar = 1e-4 * max(float(v.abs().max()) for v in jp.values())
    for k, v in jp.items():
        np.testing.assert_allclose(pts.params[k].detach().numpy(), v.numpy(),
                                   rtol=0, atol=bar, err_msg=k)


# --------------------------------------------------------- the port alone

def _setup(solvers, lr=0.05, lr_uv=0.01, dim=DIM, **kw):
    model = build_model("mnist", device="cpu", dim=dim)
    opt = make_optimizer("sgd", lr, momentum=0.9)
    sopt = make_optimizer("sgd", lr_uv)
    ts = create_solver_train_state(model, opt, sopt, solvers)
    step = make_solver_train_step(model, opt, sopt, solvers, OPTS, **kw)
    return model, ts, step


def _run(ts, step, n, seed=0):
    out = []
    for i in range(n):
        x, y = _batch(seed + i)
        ts, m = step(ts, torch.tensor(x), torch.tensor(y),
                     torch.Generator().manual_seed(i))
        out.append(m)
    return ts, out


def test_solver_u_moves_and_stays_valid_from_boundary_starts():
    """A huge lr_uv pushes u across the bounds at every step; the clip
    keeps it in [1e-3, 1] and the loss finite (JAX
    test_solver_training.py:38-70)."""
    for u0, lr_uv in ((0.5, 0.01), (1.0, 5.0), (1e-3, 5.0)):
        _, ts, step = _setup([create_solver("rk2", "u", n_steps=2, u0=u0)],
                             lr_uv=lr_uv)
        ts, ms = _run(ts, step, 4)
        us = [m["solver0_u"].item() for m in ms]
        assert all(1e-3 <= u <= 1.0 for u in us), (u0, us)
        assert all(np.isfinite(m["loss"].item()) for m in ms)
        if u0 == 0.5:
            assert us[-1] != 0.5 and ms[-1]["solver_grad_norm"] > 0


def test_rk3_both_params_train():
    _, ts, step = _setup([create_solver("rk3", "uv", n_steps=2, u0=1 / 3,
                                        v0=2 / 3)])
    ts, ms = _run(ts, step, 3)
    assert ts.solver_params[0]["u"].item() != np.float32(1 / 3)
    assert ts.solver_params[0]["v"].item() != np.float32(2 / 3)
    assert "solver0_v" in ms[-1]


def test_rk4_trainable_u_does_not_freeze_at_one():
    """rk4's clip stops at 1 - 1e-3, inside the tableau's clamp, so u keeps
    a gradient and keeps moving (JAX :144-170)."""
    _, ts, step = _setup([create_solver("rk4", "u2", n_steps=2, u0=0.97)],
                         lr=0.0, lr_uv=5.0, dim=8)
    ts, ms = _run(ts, step, 3)
    us = [m["solver0_u"].item() for m in ms]
    assert all(u <= 1.0 - 1e-3 + 1e-9 for u in us), us
    assert len(set(us)) > 1, us


def test_solvers_from_state_roundtrip_and_freeze():
    solvers = [create_solver("rk2", "u", n_steps=4, u0=0.5),
               create_solver("rk4", "u2", n_steps=2, u0=1 / 3)]
    _, ts, _ = _setup(solvers)
    rebuilt = solvers_from_state(solvers, ts.solver_params)
    assert all(not s.frozen for s in rebuilt) and all(s.frozen
                                                      for s in solvers)
    assert rebuilt[0].u.item() == 0.5 and rebuilt[1].n_steps == 2
    assert rebuilt[1].u.item() == np.float32(1 / 3)
    assert rebuilt[0].freeze().frozen and not rebuilt[0].freeze().unfreeze(
        ).frozen
    # a frozen solver's tableau stops u's gradient; an unfrozen one passes it
    y0 = torch.randn(2, 3, generator=torch.Generator().manual_seed(0),
                     requires_grad=True)
    for frozen in (True, False):
        u = torch.tensor(0.5, requires_grad=True)
        s = solvers[0].replace(u=u, frozen=frozen)
        y1 = s.integrate_final(lambda t, y: torch.tanh(y) * (1 + t), y0)
        (g,) = torch.autograd.grad(y1.sum(), u, allow_unused=True)
        assert (g is None) == frozen


def test_dynamic_solvers_equal_a_step_built_with_them():
    base = [create_solver("rk2", "u", n_steps=2, u0=0.5)]
    other = [create_solver("rk2", "u", n_steps=2, u0=0.8)]
    x, y = (torch.tensor(a) for a in _batch(3))
    out = []
    for built, dynamic in ((other, None), (base, other)):
        model = build_model("mnist", device="cpu", dim=DIM)
        opt = make_optimizer("sgd", 0.05, momentum=0.9)
        ts = create_train_state(model, opt)
        step = make_train_step(model, opt, built, OPTS,
                               AttackConfig(mode="fgsm", eps=0.1))
        _, m = step(ts, x, y, torch.Generator().manual_seed(0),
                    dynamic_solvers=dynamic)
        logits = make_eval_step(model, built)(x, dynamic_solvers=dynamic)
        out.append((m, logits, [p.detach().clone()
                                for p in model.parameters()]))
    (m1, l1, p1), (m2, l2, p2) = out
    assert all(torch.equal(m1[k], m2[k]) for k in m1)
    assert torch.equal(l1, l2)
    assert all(torch.equal(a, b) for a, b in zip(p1, p2))


def test_solver_train_state_checkpoint_restores_bit_for_bit(tmp_path):
    solvers = [create_solver("rk3", "uv", n_steps=2, u0=0.3, v0=0.7)]
    model, ts, step = _setup(solvers)
    ts, _ = _run(ts, step, 2)
    save_checkpoint(str(tmp_path / "solver_trained"), ts, {"x": 1})
    model2, fresh, _ = _setup(solvers)
    got, cfg = restore_checkpoint(str(tmp_path / "solver_trained"), fresh)
    assert cfg == {"x": 1} and got.step == ts.step == 2
    for k, v in ts.params.items():
        assert torch.equal(got.params[k], v)
    for k in ("u", "v"):
        assert torch.equal(got.solver_params[0][k], ts.solver_params[0][k])
    for a, b in ((got.opt_state, ts.opt_state),
                 (got.solver_opt_state, ts.solver_opt_state)):
        assert a.keys() == b.keys()
        for key, bufs in b.items():
            if isinstance(bufs, dict):
                assert all(torch.equal(a[key][n], t) for n, t in bufs.items())
            else:
                assert a[key] == bufs
    # the restored state trains on exactly as the saved one does
    _, m_saved = _run(ts, step, 1, seed=9)
    step2 = make_solver_train_step(model2, make_optimizer("sgd", 0.05,
                                                          momentum=0.9),
                                   make_optimizer("sgd", 0.01), solvers, OPTS)
    _, m_restored = _run(got, step2, 1, seed=9)
    assert torch.equal(m_saved[0]["loss"], m_restored[0]["loss"])
    assert torch.equal(m_saved[0]["solver0_u"], m_restored[0]["solver0_u"])


def test_a_trainable_u_keeps_premetanode10_off_b2():
    """With frozen weights and an input that carries no gradient, a
    premetanode10 ODE block would go to B2, which gives u no gradient: an
    unfrozen solver whose u requires grad keeps it on the generic path, so
    u's gradient flows (and equals the one taken with the weights live)."""
    model = build_model("premetanode10", device="cpu", in_planes=4)
    x = torch.tensor(np.random.RandomState(0).rand(2, 32, 32, 3)
                     .astype(np.float32))
    y = torch.tensor([1, 2])
    base = [create_solver("rk2", "u", n_steps=2, u0=0.5)]
    grads = []
    for tree in (model.detached_params(), None):
        u = torch.tensor(0.5, requires_grad=True)
        logits = model(x, solvers_from_state(base, [{"u": u, "v": None}]),
                       params=tree)
        (g,) = torch.autograd.grad(
            torch.nn.functional.cross_entropy(logits, y), u)
        grads.append(g)
    assert grads[0].abs() > 0
    torch.testing.assert_close(grads[0], grads[1], rtol=0, atol=0)
