"""The continuous adjoint of the port (``ops/adjoint.py``) against the JAX
package's ``odeint_final_adjoint``, and the JAX tests' bars on the port
itself.

Parity: an explicit-params RHS ``tanh(y W + b) + c sin(t)`` (y of width 8,
batch 3) through rk2, rk3 and rk4 tableaus over 4 steps, with and without
the stored states, 0 or 3 backward sub-steps; both sides in f32 on the same
grid (``tests/conftest.py`` turns x64 on, so the JAX side is cast).  y1
within 1e-6, the gradients of y0 and of each parameter within 1e-5 of
max|g|, and no gradient to u.  Then on the port alone, in f64: the forward
equals the backprop solve, adjoint gradients converge to backprop's as the
grid refines, the stored states beat the reconstruction by 8x, and finite
differences agree at rtol 1e-4."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neural_ode_metasolver_tpu.ops import create_solver as j_create_solver
from neural_ode_metasolver_tpu.ops.adjoint import (
    odeint_final_adjoint as j_odeint_final_adjoint,
)
from neural_ode_metasolver_tpu_torch.ops import (
    create_solver,
    make_time_grid,
    odeint_final,
    rk2_tableau,
    rk4_tableau,
)
from neural_ode_metasolver_tpu_torch.ops.adjoint import odeint_final_adjoint
from test_torch_runners import one_torch_thread  # noqa: F401 (autouse)

D, B, N = 8, 3, 4
SOLVERS = [("rk2", "u", 0.6, None), ("rk3", "uv", 0.3, 0.7),
           ("rk4", "uv", 0.3, 0.7)]


def _inputs(seed=0):
    rs = np.random.RandomState(seed)
    return {
        "W": (0.5 * rs.randn(D, D)).astype(np.float32),
        "b": rs.randn(D).astype(np.float32),
        "c": rs.randn(D).astype(np.float32),
    }, rs.randn(B, D).astype(np.float32), rs.randn(B, D).astype(np.float32)


def j_rhs(p, t, y):
    return jnp.tanh(y @ p["W"] + p["b"]) + p["c"] * jnp.sin(t)


def p_rhs(p, t, y):
    return torch.tanh(y @ p["W"] + p["b"]) + p["c"] * torch.sin(t)


CASES = [(s, ck, nb) for s in SOLVERS for ck in (True, False)
         for nb in (0, 3)]


@pytest.mark.parametrize(
    "solver,checkpoint_states,n_steps_bwd", CASES,
    ids=[f"{s[0]}-{'ckpt' if ck else 'flat'}-bwd{nb}" for s, ck, nb in CASES])
def test_adjoint_matches_jax(solver, checkpoint_states, n_steps_bwd):
    method, par, u0, v0 = solver
    params, y0, ct = _inputs()
    grid = np.linspace(0.0, 1.0, N + 1).astype(np.float32)
    js = j_create_solver(method, par, n_steps=N, u0=np.float32(u0),
                         v0=None if v0 is None else np.float32(v0))

    def j_loss(p, y):
        y1 = j_odeint_final_adjoint(js.tableau(), j_rhs, p, y,
                                    jnp.asarray(grid), n_steps_bwd,
                                    1, checkpoint_states)
        return jnp.sum(y1 * ct), y1

    jp = jax.tree_util.tree_map(jnp.asarray, params)
    (_, jy1), (jgp, jgy) = jax.value_and_grad(j_loss, argnums=(0, 1),
                                              has_aux=True)(jp, jnp.asarray(y0))

    ps = create_solver(method, par, n_steps=N, u0=u0, v0=v0).unfreeze()
    u = ps.u.clone().requires_grad_(True)
    ps = ps.replace(u=u)
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}
    ty0 = torch.tensor(y0, requires_grad=True)
    y1 = odeint_final_adjoint(ps.tableau(), p_rhs, tp, ty0,
                              torch.tensor(grid), n_steps_bwd,
                              checkpoint_states)
    np.testing.assert_allclose(y1.detach().numpy(), np.asarray(jy1),
                               rtol=0, atol=1e-6)
    wrt = [ty0] + [tp[k] for k in sorted(tp)] + [u]
    grads = torch.autograd.grad((y1 * torch.tensor(ct)).sum(), wrt,
                                allow_unused=True)
    assert grads[-1] is None  # the tableau is the method: u gets none
    want = [np.asarray(jgy)] + [np.asarray(jgp[k]) for k in sorted(tp)]
    for g, w in zip(grads[:-1], want):
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=1e-5 * np.abs(w).max())


# ------------------------------------------------ the port alone, in f64

def _f64_params(seed, d=4):
    g = torch.Generator().manual_seed(seed)
    return {"W": 0.5 * torch.randn(d, d, generator=g, dtype=torch.float64),
            "b": torch.randn(d, generator=g, dtype=torch.float64)}


def rhs64(p, t, y):
    return torch.tanh(y @ p["W"]) + p["b"] * torch.sin(t)


def _grid(n):
    return make_time_grid(0.0, 1.0, n_steps=n, dtype=torch.float64)


def test_adjoint_forward_matches_backprop_solve():
    p = _f64_params(0)
    y0 = torch.randn(3, 4, generator=torch.Generator().manual_seed(1),
                     dtype=torch.float64)
    tab = rk4_tableau(torch.tensor(1 / 3, dtype=torch.float64), None, "u2")
    y_adj = odeint_final_adjoint(tab, rhs64, p, y0, _grid(16))
    y_dir = odeint_final(tab, lambda t, y: rhs64(p, t, y), y0,
                         time_grid=_grid(16))
    torch.testing.assert_close(y_adj, y_dir, rtol=0, atol=0)


def _flat_grads(loss, p, y0):
    wrt = [p["W"], p["b"], y0]
    return torch.cat([g.reshape(-1) for g in torch.autograd.grad(loss, wrt)])


@pytest.mark.parametrize("tab", [
    rk2_tableau(torch.tensor(2 / 3, dtype=torch.float64)),
    rk4_tableau(torch.tensor(1 / 3, dtype=torch.float64), None, "u2"),
], ids=["rk2", "rk4"])
def test_adjoint_grads_converge_to_backprop(tab):
    p = {k: v.requires_grad_(True) for k, v in _f64_params(0).items()}
    y0 = torch.randn(2, 4, generator=torch.Generator().manual_seed(1),
                     dtype=torch.float64, requires_grad=True)
    errs = []
    for n in (8, 32):
        ga = _flat_grads((odeint_final_adjoint(tab, rhs64, p, y0, _grid(n))
                          ** 2).sum(), p, y0)
        gd = _flat_grads((odeint_final(tab, lambda t, y: rhs64(p, t, y), y0,
                                       time_grid=_grid(n)) ** 2).sum(), p,
                         y0)
        errs.append(float((ga - gd).abs().max()))
    assert errs[1] < errs[0] * 0.3, errs
    assert errs[1] < 5e-3, errs


def test_checkpointed_adjoint_beats_uncheckpointed():
    """A strongly contracting linear system: reconstructing y backward from
    y1 amplifies its error at every step, re-seeding at the stored states
    does not (JAX measured 5.0e-3 against 8.0e-2)."""
    lam, d, n = 12.0, 4, 8
    g = torch.Generator().manual_seed(1)
    p = {"W": (-lam * torch.eye(d, dtype=torch.float64) + 0.3 * torch.randn(
        d, d, generator=g, dtype=torch.float64)).requires_grad_(True)}
    y0 = torch.randn(2, d, generator=torch.Generator().manual_seed(5),
                     dtype=torch.float64, requires_grad=True)
    tab = rk2_tableau(torch.tensor(2 / 3, dtype=torch.float64))
    lin = lambda q, t, y: y @ q["W"]

    def grads(y1):
        return torch.cat([t.reshape(-1) for t in torch.autograd.grad(
            (y1 ** 2).sum(), [p["W"], y0])])

    gd = grads(odeint_final(tab, lambda t, y: lin(p, t, y), y0,
                            time_grid=_grid(n)))
    e_ckpt, e_flat = (float((grads(odeint_final_adjoint(
        tab, lin, p, y0, _grid(n), checkpoint_states=ck)) - gd).abs().max())
        for ck in (True, False))
    assert e_ckpt * 8 < e_flat, (e_ckpt, e_flat)


def test_adjoint_grad_matches_finite_difference():
    p = _f64_params(2)
    y0 = torch.randn(1, 4, generator=torch.Generator().manual_seed(3),
                     dtype=torch.float64)
    tab = rk4_tableau(torch.tensor(1 / 3, dtype=torch.float64), None, "u2")

    def loss(b):
        return (odeint_final_adjoint(tab, rhs64, {**p, "b": b}, y0,
                                     _grid(64)) ** 2).sum()

    b = p["b"].clone().requires_grad_(True)
    (g,) = torch.autograd.grad(loss(b), b)
    h = 1e-6
    with torch.no_grad():
        for i in range(2):
            e = torch.zeros_like(b)
            e[i] = h
            fd = (loss(b + e) - loss(b - e)) / (2 * h)
            np.testing.assert_allclose(float(g[i]), float(fd), rtol=1e-4)


def test_adjoint_skips_the_vjp_of_detached_params():
    """Params that need no gradient get none and are not differentiated
    (the attack's detached weights): only y0's gradient is returned, and
    it equals the one taken with the params live."""
    p = _f64_params(0)
    y0 = torch.randn(2, 4, generator=torch.Generator().manual_seed(1),
                     dtype=torch.float64, requires_grad=True)
    tab = rk2_tableau(torch.tensor(0.5, dtype=torch.float64))
    (g_frozen,) = torch.autograd.grad(
        odeint_final_adjoint(tab, rhs64, p, y0, _grid(4)).sum(), y0)
    live = {k: v.clone().requires_grad_(True) for k, v in p.items()}
    g_live = torch.autograd.grad(
        odeint_final_adjoint(tab, rhs64, live, y0, _grid(4)).sum(),
        [y0, live["W"]])
    torch.testing.assert_close(g_frozen, g_live[0], rtol=0, atol=0)
    assert g_live[1].abs().max() > 0
