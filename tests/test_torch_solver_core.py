"""Parity of the PyTorch port's solver core with the JAX package: tableaus,
solver construction and the DSL, time grids, and fixed-grid integration.

Inputs are numpy arrays made from a seed and fed to both packages; the JAX
side is cast to float32 explicitly (the test conftest enables jax x64).
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch
import torch.nn.functional as tF
from jax import lax

from neural_ode_metasolver_tpu.ops import integrate as jintegrate
from neural_ode_metasolver_tpu.ops import solver as jsolver
from neural_ode_metasolver_tpu.ops import tableau as jtab
from neural_ode_metasolver_tpu_torch.ops import integrate as tintegrate
from neural_ode_metasolver_tpu_torch.ops import regimes as tregimes
from neural_ode_metasolver_tpu_torch.ops import solver as tsolver
from neural_ode_metasolver_tpu_torch.ops import tableau as ttab

EPS16 = float(np.finfo(np.float16).eps)
# the grid of (u, v) values: clamp boundaries, the eps floor, the RK2/RK4
# poles and interior points
GRID = [-1.0, 0.0, EPS16, 0.25, 1 / 3, 0.5, 2 / 3, 1.0]


def _f32(v):
    return np.float32(v)


def _assert_tableau_equal(jt, tt):
    for name in ("c", "w", "b"):
        a = np.asarray(getattr(jt, name), np.float64)
        b = getattr(tt, name).numpy().astype(np.float64)
        assert a.shape == b.shape, name
        np.testing.assert_allclose(b, a, rtol=2e-5, atol=1e-6,
                                   equal_nan=True, err_msg=name)


def test_euler_tableau_matches():
    _assert_tableau_equal(jtab.euler_tableau(jnp.float32),
                          ttab.euler_tableau(torch.float32))


@pytest.mark.parametrize("u", GRID)
def test_rk2_tableau_matches(u):
    _assert_tableau_equal(jtab.rk2_tableau(jnp.asarray(_f32(u))),
                          ttab.rk2_tableau(torch.tensor(u)))


@pytest.mark.parametrize("u", GRID)
@pytest.mark.parametrize("v", GRID)
def test_rk3_tableau_matches(u, v):
    _assert_tableau_equal(
        jtab.rk3_tableau(jnp.asarray(_f32(u)), jnp.asarray(_f32(v))),
        ttab.rk3_tableau(torch.tensor(u), torch.tensor(v)))


@pytest.mark.parametrize("param", ["u1", "u2", "u3"])
@pytest.mark.parametrize("u", GRID)
def test_rk4_single_param_tableau_matches(param, u):
    _assert_tableau_equal(
        jtab.rk4_tableau(jnp.asarray(_f32(u)), None, param),
        ttab.rk4_tableau(torch.tensor(u), None, param))


@pytest.mark.parametrize("u", GRID)
@pytest.mark.parametrize("v", GRID)
def test_rk4_uv_tableau_matches(u, v):
    _assert_tableau_equal(
        jtab.rk4_tableau(jnp.asarray(_f32(u)), jnp.asarray(_f32(v)), "uv"),
        ttab.rk4_tableau(torch.tensor(u), torch.tensor(v), "uv"))


def test_tableau_errors_and_eps():
    with pytest.raises(ValueError):
        ttab.rk4_tableau(torch.tensor(0.3), None, "uv")
    with pytest.raises(ValueError):
        ttab.rk4_tableau(torch.tensor(0.3), None, "u9")
    for jd, td in ((jnp.float32, torch.float32), (jnp.float64, torch.float64),
                   (jnp.bfloat16, torch.bfloat16)):
        assert ttab.validity_eps(td) == jtab.validity_eps(jd)


# ------------------------------------------------------ solvers and grids --

SOLVER_ARGS = [
    ("rk2", "u", 8, -1, 0.5, -1),
    ("rk2", "u", -1, 0.1, -1, -1),
    ("RK2", "u", 4, None, None, None),
    ("rk3", "uv", 3, -1, 0.3, 0.7),
    ("rk3", "uv", 3, None, None, None),
    ("rk4", "u2", 2, -1, 0.25, -1),
    ("rk4", "uv", 2, -1, None, None),
    ("euler", None, 5, -1, 0.5, 0.5),
]


def _solver_fields(s):
    u = None if s.u is None else float(np.asarray(s.u))
    v = None if s.v is None else float(np.asarray(s.v))
    return (s.method, s.parameterization, s.u0, s.v0, s.n_steps,
            s.step_size, u, v)


@pytest.mark.parametrize("args", SOLVER_ARGS)
def test_create_solver_matches(args):
    js = jsolver.create_solver(*args)
    ts = tsolver.create_solver(*args)
    assert _solver_fields(ts) == pytest.approx(_solver_fields(js))
    assert ts.order == js.order
    _assert_tableau_equal(js.tableau(), ts.tableau())


BAD_SOLVER_ARGS = [
    ("rk2", "u", 0, -1, 0.5, -1),       # n_steps < 1
    ("rk2", "u", -1, 0.0, 0.5, -1),     # step_size <= 0
    ("rk5", "u", 8, -1, 0.5, -1),       # unknown method
    ("rk2", "uv", 8, -1, 0.5, -1),      # bad rk2 parameterization
    ("rk3", "u", 8, -1, 0.5, -1),       # bad rk3 parameterization
    ("rk4", "u4", 8, -1, 0.5, -1),      # bad rk4 parameterization
]


@pytest.mark.parametrize("args", BAD_SOLVER_ARGS)
def test_create_solver_errors_match(args):
    with pytest.raises(ValueError):
        jsolver.create_solver(*args)
    with pytest.raises(ValueError):
        tsolver.create_solver(*args)


@pytest.mark.parametrize("spec", [
    "rk2,u,8,-1,0.5,-1",
    "rk2,u,8,-1,0.5,-1;rk2,u,8,-1,1.0,-1;",
    " rk4,uv,-1,0.25,0.3,0.6 ; euler,-1,4,-1,-1,-1",
])
def test_parse_solver_dsl_matches(spec):
    js = jsolver.parse_solver_dsl(spec)
    ts = tsolver.parse_solver_dsl(spec)
    assert len(ts) == len(js)
    for a, b in zip(js, ts):
        assert _solver_fields(b) == pytest.approx(_solver_fields(a))


@pytest.mark.parametrize("spec", ["rk2,u,8", "rk2,u,x,-1,0.5,-1"])
def test_parse_solver_dsl_rejects_malformed(spec):
    with pytest.raises(ValueError):
        jsolver.parse_solver_dsl(spec)
    with pytest.raises(ValueError):
        tsolver.parse_solver_dsl(spec)


@pytest.mark.parametrize("t0,t1,n_steps,step_size", [
    (0.0, 1.0, 8, None),
    (0.0, 2.0, 3, None),
    (1.0, 0.0, 4, None),
    (0.0, 1.0, None, 0.3),
    (0.0, 1.0, None, 0.25),
    (1.0, 0.0, None, 0.3),
    (0.5, 1.7, None, 0.4),
])
def test_make_time_grid_matches(t0, t1, n_steps, step_size):
    jg = np.asarray(jintegrate.make_time_grid(t0, t1, n_steps, step_size,
                                              dtype=jnp.float32))
    tg = tintegrate.make_time_grid(t0, t1, n_steps, step_size).numpy()
    assert tg.dtype == np.float32
    np.testing.assert_allclose(tg, jg, rtol=0, atol=1e-6)


def test_make_time_grid_errors():
    for kw in ({}, {"n_steps": 2, "step_size": 0.5}, {"step_size": 0.0},
               {"step_size": -0.1}):
        with pytest.raises(ValueError):
            tintegrate.make_time_grid(0.0, 1.0, **kw)
        with pytest.raises(ValueError):
            jintegrate.make_time_grid(0.0, 1.0, **kw)


# ------------------------------------------------------------ integration --


def _conv_rhs_pair(seed=0, c=4):
    """The same non-autonomous conv RHS f(t, y) = (1 + t) conv(tanh(y), w)
    for both packages, on (N, H, W, C) NHWC states."""
    rs = np.random.RandomState(seed)
    w = (rs.randn(3, 3, c, c) * 0.2).astype(np.float32)
    wj = jnp.asarray(w)
    wt = torch.tensor(w)

    def jrhs(t, y):
        out = lax.conv_general_dilated(
            jnp.tanh(y), wj.astype(y.dtype), (1, 1), "SAME",
            dimension_numbers=("NHWC", "HWIO", "NHWC"))
        return out * (1.0 + t).astype(y.dtype)

    def trhs(t, y):
        out = tF.conv2d(torch.tanh(y).permute(0, 3, 1, 2),
                        wt.to(y.dtype).permute(3, 2, 0, 1), padding=1)
        return out.permute(0, 2, 3, 1) * (1.0 + t).to(y.dtype)

    y0 = (rs.randn(2, 6, 6, c) * 0.5).astype(np.float32)
    return jrhs, trhs, y0


@pytest.mark.parametrize("args,grid", [
    (("euler", None, 4, -1, -1, -1), "n"),
    (("rk2", "u", 4, -1, 2 / 3, -1), "n"),
    (("rk2", "u", -1, 0.3, 0.5, -1), "step"),
    (("rk3", "uv", 3, -1, 0.3, 0.7), "n"),
    (("rk4", "u2", 2, -1, 0.25, -1), "n"),
    (("rk4", "uv", 2, -1, 0.3, 0.8), "n"),
])
def test_odeint_final_matches_f32(args, grid):
    jrhs, trhs, y0 = _conv_rhs_pair()
    js = jsolver.create_solver(*args)
    ts = tsolver.create_solver(*args)
    yj = js.integrate_final(jrhs, jnp.asarray(y0), 0.0, 1.0)
    yt = ts.integrate_final(trhs, torch.tensor(y0), 0.0, 1.0)
    assert yt.dtype == torch.float32
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), atol=1e-5)


def test_odeint_final_keeps_bf16_carry():
    """A bf16 state stays bf16 through the steps (stage inputs cast to the
    carry dtype, the combine in f32) and tracks the JAX result within the
    bf16 I/O bar of tests/test_pallas.py (3e-2)."""
    jrhs, trhs, y0 = _conv_rhs_pair(seed=1)
    js = jsolver.create_solver("rk2", "u", 4, -1, 0.5, -1)
    ts = tsolver.create_solver("rk2", "u", 4, -1, 0.5, -1)
    yj = js.integrate_final(jrhs, jnp.asarray(y0).astype(jnp.bfloat16))
    seen = []

    def trhs_rec(t, y):
        seen.append(y.dtype)
        return trhs(t, y)

    yt = ts.integrate_final(trhs_rec, torch.tensor(y0).to(torch.bfloat16))
    assert yt.dtype == torch.bfloat16
    assert seen and all(d == torch.bfloat16 for d in seen)
    np.testing.assert_allclose(yt.float().numpy(),
                               np.asarray(yj.astype(jnp.float32)), atol=3e-2)


def test_rk_step_matches():
    jrhs, trhs, y0 = _conv_rhs_pair(seed=2)
    jt = jtab.rk4_tableau(jnp.asarray(_f32(0.3)), None, "u1")
    tt = ttab.rk4_tableau(torch.tensor(0.3), None, "u1")
    dyj = jintegrate.rk_step(jt, jrhs, jnp.asarray(y0),
                             jnp.asarray(_f32(0.2)), jnp.asarray(_f32(0.1)))
    dyt = tintegrate.rk_step(tt, trhs, torch.tensor(y0), torch.tensor(0.2),
                             torch.tensor(0.1))
    np.testing.assert_allclose(dyt.numpy(), np.asarray(dyj), atol=1e-6)


def test_meta_integrate_standalone_and_unported_modes():
    jrhs, trhs, y0 = _conv_rhs_pair(seed=3)
    ts = tsolver.create_solver("rk2", "u", 2, -1, 0.5, -1)
    y, aux = tregimes.meta_integrate([ts], trhs, torch.tensor(y0),
                                     tregimes.SolverOptions())
    assert aux == {}
    torch.testing.assert_close(y, ts.integrate_final(trhs, torch.tensor(y0)))
    # switch and ensemble are ported (tests/test_torch_regimes.py); they
    # draw, so without a generator they raise
    for mode in ("switch", "ensemble"):
        with pytest.raises(ValueError, match="needs a PRNG key"):
            tregimes.meta_integrate([ts], trhs, torch.tensor(y0),
                                    tregimes.SolverOptions(solver_mode=mode))
    with pytest.raises(ValueError):
        tregimes.meta_integrate([ts], trhs, torch.tensor(y0),
                                tregimes.SolverOptions(solver_mode="bogus"))
