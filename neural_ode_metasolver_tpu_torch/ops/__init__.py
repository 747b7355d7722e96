"""Solver core and kernels of the PyTorch port (mirrors the JAX ``ops``)."""
from .conv3x3 import (
    conv3x3_dgrad,
    conv3x3_same,
    conv3x3_wgrad,
    reference_conv3x3,
    reference_conv3x3_wgrad,
)
from .gelu_poly import (
    fused_gelu_poly,
    gelu_poly_backward,
    gelu_poly_backward_reference,
    gelu_poly_reference,
)
from .group_norm import (
    fused_group_norm_act,
    group_norm_backward,
    group_norm_backward_reference,
    group_norm_reference,
)
from .integrate import (
    make_time_grid,
    odeint,
    odeint_final,
    odeint_grid,
    rk_step,
)
from .noise import (
    noise_params,
    noise_solver,
    sample_noise,
    solver_ensemble_by_noising,
)
from .ode_block import ode_block_rk2_forward, reference_ode_block_rk2
from . import library  # registers the kernels as nodems:: custom ops
from .regimes import SolverOptions, meta_integrate
from .solver import ParametricSolver, create_solver, parse_solver_dsl
from .tableau import (
    ButcherTableau,
    euler_tableau,
    heun_tableau,
    midpoint_tableau,
    pad_tableau,
    rk2_tableau,
    rk3_tableau,
    rk4_standard_tableau,
    rk4_tableau,
    rk38_tableau,
    stack_tableaus,
    validity_eps,
)

__all__ = [
    "ButcherTableau",
    "ParametricSolver",
    "SolverOptions",
    "conv3x3_dgrad",
    "conv3x3_same",
    "conv3x3_wgrad",
    "create_solver",
    "euler_tableau",
    "fused_group_norm_act",
    "fused_gelu_poly",
    "gelu_poly_backward",
    "gelu_poly_backward_reference",
    "gelu_poly_reference",
    "group_norm_backward",
    "group_norm_backward_reference",
    "group_norm_reference",
    "heun_tableau",
    "make_time_grid",
    "meta_integrate",
    "midpoint_tableau",
    "noise_params",
    "noise_solver",
    "ode_block_rk2_forward",
    "odeint",
    "odeint_final",
    "odeint_grid",
    "pad_tableau",
    "parse_solver_dsl",
    "reference_conv3x3",
    "reference_conv3x3_wgrad",
    "reference_ode_block_rk2",
    "rk2_tableau",
    "rk3_tableau",
    "rk38_tableau",
    "rk4_standard_tableau",
    "rk4_tableau",
    "rk_step",
    "sample_noise",
    "solver_ensemble_by_noising",
    "stack_tableaus",
    "validity_eps",
]
