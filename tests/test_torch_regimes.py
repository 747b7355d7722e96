"""The switch and ensemble regimes, the grid integrators and the NFE
accounting of the PyTorch port against the JAX package, on the CPU.

Inputs are numpy arrays made from a seed; the JAX side is cast to f32
(``conftest.py`` turns on x64).  The two packages draw from different
streams, so the draws are pinned: through ``aux_in`` at the level of
``meta_integrate``, and through degenerate probabilities (switch_probs (1, 0)
and (0, 1), ensemble_prob 1 and 0) through the models; the port's own draws
are checked against their probabilities.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neural_ode_metasolver_tpu.models import apply_cifar as j_apply_cifar
from neural_ode_metasolver_tpu.models import init_cifar as j_init_cifar
from neural_ode_metasolver_tpu.models import premetanode10 as j_premetanode10
from neural_ode_metasolver_tpu.models.api import build_model as j_build_model
from neural_ode_metasolver_tpu.ops import SolverOptions as JSolverOptions
from neural_ode_metasolver_tpu.ops import create_solver as j_create_solver
from neural_ode_metasolver_tpu.ops import integrate as jintegrate
from neural_ode_metasolver_tpu.ops import regimes as jregimes
from neural_ode_metasolver_tpu.training import metrics as jmetrics
from neural_ode_metasolver_tpu_torch.models import (
    build_model,
    cifar_params_from_jax,
    mnist_params_from_jax,
)
from neural_ode_metasolver_tpu_torch.ops import (
    SolverOptions,
    create_solver,
    meta_integrate,
)
from neural_ode_metasolver_tpu_torch.ops import integrate as tintegrate
from neural_ode_metasolver_tpu_torch.training import metrics as tmetrics


def _rhs_pair(seed=0, shape=(2, 5, 5, 3)):
    """The same elementwise non-autonomous RHS f(t, y) = (1 + t) tanh(w y)
    - 0.3 y for both packages, and a state y0."""
    rs = np.random.RandomState(seed)
    w = (rs.randn(*shape[-1:]) + 1.0).astype(np.float32)
    wj, wt = jnp.asarray(w), torch.tensor(w)

    def jrhs(t, y):
        return (1.0 + t).astype(y.dtype) * jnp.tanh(wj * y) - 0.3 * y

    def trhs(t, y):
        return (1.0 + t).to(y.dtype) * torch.tanh(wt * y) - 0.3 * y

    return jrhs, trhs, (rs.randn(*shape) * 0.7).astype(np.float32)


def _solver_pair(n_steps=3, u_alt=1.0):
    """(JAX, port) lists of two RK2 solvers: u=0.5 and u=u_alt."""
    return ([j_create_solver("rk2", "u", n_steps=n_steps, u0=np.float32(u))
             for u in (0.5, u_alt)],
            [create_solver("rk2", "u", n_steps=n_steps, u0=u)
             for u in (0.5, u_alt)])


# ------------------------------------------------------- meta_integrate


@pytest.mark.parametrize("solver_id", [0, 1, 2])
def test_switch_with_pinned_id_matches_jax(solver_id):
    """Every branch of a three-solver switch (u 0.5, 1.0 and 0.25), its id
    pinned by aux_in in both packages, within 1e-6; aux records the id."""
    jrhs, trhs, y0 = _rhs_pair(1)
    us = (0.5, 1.0, 0.25)
    js = [j_create_solver("rk2", "u", n_steps=3, u0=np.float32(u)) for u in us]
    ps = [create_solver("rk2", "u", n_steps=3, u0=u) for u in us]
    yj, auxj = jregimes.meta_integrate(
        js, jrhs, jnp.asarray(y0), JSolverOptions(solver_mode="switch"),
        aux_in={"switch_solver_id": jnp.int32(solver_id)})
    yp, auxp = meta_integrate(ps, trhs, torch.tensor(y0),
                              SolverOptions(solver_mode="switch"),
                              aux_in={"switch_solver_id": solver_id})
    assert auxp == {"switch_solver_id": solver_id}
    assert int(auxj["switch_solver_id"]) == solver_id
    np.testing.assert_allclose(yp.numpy(), np.asarray(yj), rtol=0, atol=1e-6)
    # the pinned branch is that solver's own solve
    torch.testing.assert_close(yp, ps[solver_id].integrate_final(
        trhs, torch.tensor(y0)), rtol=0, atol=0)


@pytest.mark.parametrize("coin", [True, False])
@pytest.mark.parametrize("members,weights", [
    (2, (0.6, 0.4)), (2, None), (1, (0.7,)), (1, None)])
def test_ensemble_with_pinned_coin_matches_jax(coin, members, weights):
    """Heads: the weighted sum of the members' outputs (default weights
    1/n); tails: solvers[0]'s output unweighted.  A single-member ensemble
    takes the regime path: heads applies its weight.  Within 1e-6 of JAX."""
    jrhs, trhs, y0 = _rhs_pair(2)
    js, ps = _solver_pair(2, u_alt=0.8)
    js, ps = js[:members], ps[:members]
    opts = dict(solver_mode="ensemble", ensemble_weights=weights)
    yj, _ = jregimes.meta_integrate(
        js, jrhs, jnp.asarray(y0), JSolverOptions(**opts),
        aux_in={"ensemble_coin_flip": jnp.bool_(coin)})
    yp, auxp = meta_integrate(ps, trhs, torch.tensor(y0),
                              SolverOptions(**opts),
                              aux_in={"ensemble_coin_flip": coin})
    assert auxp == {"ensemble_coin_flip": coin}
    np.testing.assert_allclose(yp.numpy(), np.asarray(yj), rtol=0, atol=1e-6)
    first = ps[0].integrate_final(trhs, torch.tensor(y0))
    if not coin:
        torch.testing.assert_close(yp, first, rtol=0, atol=0)
    elif members == 1:
        w = 1.0 if weights is None else weights[0]
        torch.testing.assert_close(yp, w * first, rtol=0, atol=0)


def test_switch_and_coin_draw_their_probabilities():
    """4,000 switch draws at (0.6, 0.4) and 4,000 coins at p = 0.3, from
    one CPU generator, fall within 4 sigma of the probabilities; uniform
    switch draws without switch_probs too; degenerate probabilities give
    one outcome."""
    y0 = torch.zeros(1)
    rhs = lambda t, y: y
    s = [create_solver("euler", None, n_steps=1)] * 2
    g = torch.Generator().manual_seed(0)
    n = 4000

    def share(opts, key, want):
        hits = sum(meta_integrate(s, rhs, y0, opts, g)[1][key] == want
                   for _ in range(n))
        return hits / n

    for opts, key, want, p in [
        (SolverOptions("switch", switch_probs=(0.6, 0.4)),
         "switch_solver_id", 0, 0.6),
        (SolverOptions("switch"), "switch_solver_id", 1, 0.5),
        (SolverOptions("ensemble", ensemble_prob=0.3),
         "ensemble_coin_flip", True, 0.3),
    ]:
        assert abs(share(opts, key, want) - p) <= 4 * (p * (1 - p) / n) ** 0.5
    for opts, key, want in [
        (SolverOptions("switch", switch_probs=(1.0, 0.0)),
         "switch_solver_id", 0),
        (SolverOptions("switch", switch_probs=(0.0, 1.0)),
         "switch_solver_id", 1),
        (SolverOptions("ensemble", ensemble_prob=1.0),
         "ensemble_coin_flip", True),
        (SolverOptions("ensemble", ensemble_prob=0.0),
         "ensemble_coin_flip", False),
    ]:
        assert all(meta_integrate(s, rhs, y0, opts, g)[1][key] == want
                   for _ in range(200))


def test_regimes_without_a_generator_raise():
    """Switch and ensemble draw, so without a generator (and nothing to
    replay) they raise, as JAX does without a key, through the model too;
    switch_probs of the wrong length raise."""
    _, trhs, y0 = _rhs_pair()
    _, ps = _solver_pair(1)
    y = torch.tensor(y0)
    for mode in ("switch", "ensemble"):
        with pytest.raises(ValueError, match=f"{mode} mode needs a PRNG key"):
            meta_integrate(ps, trhs, y, SolverOptions(solver_mode=mode))
    with pytest.raises(ValueError, match="entries for 2 solvers"):
        meta_integrate(ps, trhs, y, SolverOptions("switch", switch_probs=(1,)),
                       torch.Generator())
    with pytest.raises(ValueError, match="needs a PRNG key"):
        build_model("mnist", device="cpu", dim=16)(
            torch.rand(1, 28, 28, 1), ps, SolverOptions("switch"))


# ------------------------------------------------------------ the models


PINNED = [
    ("switch", dict(switch_probs=(1.0, 0.0))),
    ("switch", dict(switch_probs=(0.0, 1.0))),
    ("ensemble", dict(ensemble_prob=1.0, ensemble_weights=(0.6, 0.4))),
    ("ensemble", dict(ensemble_prob=0.0, ensemble_weights=(0.6, 0.4))),
]


@pytest.mark.parametrize("mode,opts", PINNED)
def test_apply_mnist_regimes_match_jax(mode, opts):
    """The MNIST MetaNODE (dim 16, RK2 u in {0.5, 1.0}, 3 steps) under
    switch and ensemble with degenerate probabilities, so both packages'
    draws are fixed: logits within 1e-4 (the MNIST bar), kernel and plain
    path alike, with the ss-loss replaying the forward's draw."""
    jmodel = j_build_model("mnist", dim=16)
    params, state = jmodel.init(jax.random.key(0))
    pmodel = build_model("mnist", device="cpu", dim=16)
    pmodel.load_state_dict(mnist_params_from_jax(
        jax.tree_util.tree_map(np.asarray, params)))
    js, ps = _solver_pair()
    x = np.random.RandomState(3).rand(3, 28, 28, 1).astype(np.float32)
    jl, _, jaux = jmodel.apply(
        params, state, jnp.asarray(x), js,
        JSolverOptions(solver_mode=mode, **opts), key=jax.random.key(1),
        train=False, ss_loss=True)
    with torch.no_grad():
        for use_kernels in (True, False):
            pl, paux = pmodel(torch.tensor(x), ps,
                              SolverOptions(solver_mode=mode, **opts),
                              generator=torch.Generator().manual_seed(1),
                              use_kernels=use_kernels, ss_loss=True,
                              return_aux=True)
            np.testing.assert_allclose(pl.numpy(), np.asarray(jl), atol=1e-4)
            np.testing.assert_allclose(float(paux["ss_loss"]),
                                       float(jaux["ss_loss"]), rtol=1e-5)


@pytest.mark.parametrize("mode,opts", PINNED)
def test_apply_cifar_regimes_match_jax(mode, opts):
    """premetanode10 (in_planes 16, RK2 u in {0.5, 1.0}, 3 steps) under
    switch and ensemble with degenerate probabilities: logits within 3e-4
    (the CIFAR bar), kernel path (B1's plain version on the generic path:
    B2 serves standalone only) and plain path."""
    cfg = j_premetanode10(in_planes=16)
    params, state = j_init_cifar(jax.random.key(0), cfg)
    pmodel = build_model("premetanode10", device="cpu", in_planes=16)
    pmodel.load_state_dict(cifar_params_from_jax(
        jax.tree_util.tree_map(np.asarray, params)))
    js, ps = _solver_pair()
    x = np.random.RandomState(4).rand(2, 32, 32, 3).astype(np.float32)
    jl, _, _ = j_apply_cifar(params, state, jnp.asarray(x), js,
                             JSolverOptions(solver_mode=mode, **opts),
                             key=jax.random.key(2), cfg=cfg)
    with torch.no_grad():
        for use_kernels in (True, False):
            pl = pmodel(torch.tensor(x), ps,
                        SolverOptions(solver_mode=mode, **opts),
                        generator=torch.Generator().manual_seed(2),
                        use_kernels=use_kernels)
            np.testing.assert_allclose(pl.numpy(), np.asarray(jl), atol=3e-4)


def test_cifar_kernel_path_follows_a_custom_grid():
    """A standalone RK2 solver with both n_steps and a custom_grid
    integrates on the grid (``time_grid``'s order): premetanode10's kernel
    path, whose kernel B2 runs uniform n_steps grids only, agrees with the
    plain path and with JAX within 3e-4 (the CIFAR bar).  The ODE blocks'
    kernels are scaled by 4: at the random init's scale every grid gives
    the same logits within 1.3e-6, at 4x 8 uniform steps and this grid
    put them 0.28 apart."""
    cfg = j_premetanode10(in_planes=16)
    params, state = j_init_cifar(jax.random.key(0), cfg)
    params = jax.tree_util.tree_map(np.asarray, params)
    for layer in ("layer1", "layer2"):
        for block in params[layer]["ode"]:
            for conv in ("conv1", "conv2"):
                block[conv]["kernel"] = block[conv]["kernel"] * 4
    pmodel = build_model("premetanode10", device="cpu", in_planes=16)
    pmodel.load_state_dict(cifar_params_from_jax(params))
    grid = (0.0, 0.15, 0.5, 1.0)
    js = j_create_solver("rk2", "u", n_steps=8, u0=np.float32(0.5)).replace(
        custom_grid=grid)
    ps = create_solver("rk2", "u", n_steps=8, u0=0.5).replace(
        custom_grid=grid)
    x = np.random.RandomState(5).rand(2, 32, 32, 3).astype(np.float32)
    jl, _, _ = j_apply_cifar(jax.tree_util.tree_map(jnp.asarray, params),
                             state, jnp.asarray(x), [js], JSolverOptions(),
                             key=jax.random.key(2), cfg=cfg)
    with torch.no_grad():
        for use_kernels in (True, False):
            pl = pmodel(torch.tensor(x), [ps], use_kernels=use_kernels)
            np.testing.assert_allclose(pl.numpy(), np.asarray(jl), atol=3e-4)


# ------------------------------------------------------ grid integrators


@pytest.mark.parametrize("grid,t", [
    (dict(n_steps=4), [0.0, 0.3, 0.5, 1.0]),
    (dict(n_steps=4), [1.0, 0.6, 0.25, 0.0]),  # backward in time
    (dict(step_size=0.3), [0.0, 0.45, 0.9, 1.0]),  # a short last step
    (dict(), [0.0, 0.2, 0.7, 1.0]),  # the grid is t itself
    (dict(time_grid=[0.0, 0.1, 0.35, 0.7, 1.0]), [0.0, 0.35, 0.5, 1.0]),
    (dict(time_grid=[1.0, 0.5, 0.0]), [1.0, 0.75, 0.5, 0.0]),
])
def test_odeint_matches_jax(grid, t):
    """odeint's interpolated trajectory within 1e-6 of JAX's, with exact
    values where a requested time is a grid point; odeint_grid's rows on
    the same grid too."""
    jrhs, trhs, y0 = _rhs_pair(5)
    jt = j_create_solver("rk2", "u", u0=np.float32(0.6)).tableau()
    pt = create_solver("rk2", "u", u0=0.6).tableau()
    jkw = {k: (jnp.asarray(v, jnp.float32) if k == "time_grid" else v)
           for k, v in grid.items()}
    pkw = {k: (torch.tensor(v) if k == "time_grid" else v)
           for k, v in grid.items()}
    yj = jintegrate.odeint(jt, jrhs, jnp.asarray(y0),
                           jnp.asarray(t, jnp.float32), **jkw)
    yp = tintegrate.odeint(pt, trhs, torch.tensor(y0), torch.tensor(t),
                           **pkw)
    assert yp.shape == (len(t),) + y0.shape and yp.dtype == torch.float32
    np.testing.assert_allclose(yp.numpy(), np.asarray(yj), rtol=0, atol=1e-6)
    if "time_grid" in grid:
        g = torch.tensor(grid["time_grid"])
        rows = tintegrate.odeint_grid(pt, trhs, torch.tensor(y0), g)
        np.testing.assert_allclose(
            rows.numpy(), np.asarray(jintegrate.odeint_grid(
                jt, jrhs, jnp.asarray(y0), jnp.asarray(g.numpy()))),
            rtol=0, atol=1e-6)
        for i, ti in enumerate(t):  # grid points are exact
            hits = (g == ti).nonzero()
            if len(hits):
                torch.testing.assert_close(yp[i], rows[hits[0, 0]],
                                           rtol=0, atol=0)


def test_custom_grid_takes_precedence_and_spans_are_checked():
    """A solver's custom_grid wins over n_steps (as in JAX's time_grid);
    integrate and integrate_final follow it within 1e-6 of JAX; a
    requested time outside an explicit grid raises."""
    jrhs, trhs, y0 = _rhs_pair(6)
    grid = (0.0, 0.15, 0.5, 0.8, 1.0)
    js = j_create_solver("rk2", "u", n_steps=7, u0=np.float32(0.5)).replace(
        custom_grid=grid)
    ps = create_solver("rk2", "u", n_steps=7, u0=0.5).replace(
        custom_grid=grid)
    np.testing.assert_allclose(ps.time_grid().numpy(),
                               np.asarray(js.time_grid()), atol=0)
    np.testing.assert_allclose(
        ps.integrate_final(trhs, torch.tensor(y0)).numpy(),
        np.asarray(js.integrate_final(jrhs, jnp.asarray(y0))), atol=1e-6)
    t = [0.0, 0.5, 0.9]
    np.testing.assert_allclose(
        ps.integrate(trhs, torch.tensor(y0), t).numpy(),
        np.asarray(js.integrate(jrhs, jnp.asarray(y0),
                                jnp.asarray(t, jnp.float32))), atol=1e-6)
    regrid = ps.replace(n_steps=4, step_size=None, custom_grid=None)
    assert regrid.time_grid().shape == (5,)
    with pytest.raises(ValueError, match="outside the integration grid"):
        ps.integrate(trhs, torch.tensor(y0), [0.0, 1.2])
    with pytest.raises(ValueError, match="outside the integration grid"):
        tintegrate.odeint(ps.tableau(), trhs, torch.tensor(y0), [0.5, 1.0],
                          time_grid=torch.tensor([0.6, 1.0]))


def test_nfe_matches_jax():
    """nfe_per_solve and nfe_per_forward equal JAX's for every grid source
    and regime."""
    specs = [("euler", None, 5, None), ("rk2", "u", 8, None),
             ("rk3", "uv", None, 0.3), ("rk4", "u1", None, None),
             ("rk4", "uv", 3, None)]
    pairs = [(j_create_solver(m, p, n_steps=n, step_size=h),
              create_solver(m, p, n_steps=n, step_size=h))
             for m, p, n, h in specs]
    grid = (0.0, 0.2, 0.9, 1.0)
    pairs.append((pairs[1][0].replace(custom_grid=grid),
                  pairs[1][1].replace(custom_grid=grid)))
    for js, ps in pairs:
        assert tmetrics.nfe_per_solve(ps) == jmetrics.nfe_per_solve(js)
    jsol, psol = [p[0] for p in pairs], [p[1] for p in pairs]
    for opts, ks in [
            (dict(), (1, 2, 6)), (dict(solver_mode="switch"), (1, 2, 6)),
            (dict(solver_mode="switch",
                  switch_probs=(0.1, 0.2, 0.3, 0.1, 0.2, 0.1)), (6,)),
            (dict(solver_mode="ensemble", ensemble_prob=0.35), (1, 2, 6))]:
        for k in ks:
            assert tmetrics.nfe_per_forward(
                psol[:k], SolverOptions(**opts), 2) == \
                jmetrics.nfe_per_forward(jsol[:k], JSolverOptions(**opts), 2)
    assert tmetrics.nfe_per_forward(psol[1:2], SolverOptions(), 2) == 32
    meter = tmetrics.RunningAverageMeter()
    jmeter = jmetrics.RunningAverageMeter()
    for v in (1.0, 3.0, 2.0):
        meter.update(v)
        jmeter.update(v)
    assert (meter.val, meter.avg) == (jmeter.val, jmeter.avg)
