"""The port's fixed tableaus, ``pad_tableau`` and ``stack_tableaus``
against the JAX package's, exactly (JAX ``ops/tableau.py:256-328``), and
the stacked tableau of a fleet's solvers against its members' own."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neural_ode_metasolver_tpu.ops import tableau as jt
from neural_ode_metasolver_tpu_torch.ops import tableau as pt
from neural_ode_metasolver_tpu_torch.ops import create_solver
from neural_ode_metasolver_tpu_torch.training import stack_fleet_solvers
from tests.test_torch_runners import one_torch_thread  # noqa: F401


def _equal(p, j):
    for a, b in zip(p, j):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b, np.float32))


@pytest.mark.parametrize("name", ["midpoint_tableau", "heun_tableau",
                                  "rk4_standard_tableau", "rk38_tableau"])
def test_named_tableaus_match_jax(name):
    p, j = getattr(pt, name)(), getattr(jt, name)(jnp.float32)
    assert p.c.dtype == torch.float32
    _equal(p, j)


def test_named_tableaus_equal_their_parametric_members():
    """Midpoint is rk2(1/2), Heun rk2(1), classical RK4 rk4(1/3, 'u2')."""
    for fixed, param in ((pt.midpoint_tableau(), pt.rk2_tableau(
            torch.tensor(0.5))), (pt.heun_tableau(), pt.rk2_tableau(
                torch.tensor(1.0))), (pt.rk4_standard_tableau(),
                                      pt.rk4_tableau(torch.tensor(1 / 3)))):
        for a, b in zip(fixed, param):
            torch.testing.assert_close(a, b, rtol=0, atol=1e-6)


def _mixed():
    """rk2, rk3 and rk4 at f32 parameters, in both frameworks."""
    u2, u3, v3, u4 = (np.float32(x) for x in (0.3, 0.25, 0.7, 0.4))
    port = [pt.rk2_tableau(torch.tensor(u2)),
            pt.rk3_tableau(torch.tensor(u3), torch.tensor(v3)),
            pt.rk4_tableau(torch.tensor(u4), parameterization="u1")]
    jax_ = [jt.rk2_tableau(jnp.float32(u2)),
            jt.rk3_tableau(jnp.float32(u3), jnp.float32(v3)),
            jt.rk4_tableau(jnp.float32(u4), parameterization="u1")]
    return port, jax_


def test_pad_tableau_matches_jax():
    port, jax_ = _mixed()
    for p, j in zip(port, jax_):
        for stages in range(p.stages, 5):
            _equal(pt.pad_tableau(p, stages), jt.pad_tableau(j, stages))
    with pytest.raises(ValueError, match="cannot pad"):
        pt.pad_tableau(port[2], 2)


def test_stack_tableaus_mixed_orders_match_jax():
    port, jax_ = _mixed()
    stacked = pt.stack_tableaus(port)
    assert stacked.w.shape == (3, 4, 4) and stacked.stages == 4
    _equal(stacked, jt.stack_tableaus(jax_))


def test_fleet_solvers_build_the_stacked_tableau():
    """A fleet's stacked rk2 solver builds, in one call, the tableau that
    ``stack_tableaus`` makes of its members' tableaus."""
    us = [0.3, 0.5, 0.9]
    members = [[create_solver("rk2", "u", n_steps=2, u0=u)] for u in us]
    (stacked,) = stack_fleet_solvers(members)
    assert stacked.u.shape == (3,)
    want = pt.stack_tableaus([m[0].tableau() for m in members])
    for a, b in zip(stacked.tableau(), want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
