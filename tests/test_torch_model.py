"""The whole serving slice of the PyTorch port against the JAX package:
premetanode10 logits with weights carried by ``cifar_params_from_jax``, the
kernel dispatch on the CPU, and ``ServedModel``."""
import jax
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from neural_ode_metasolver_tpu.models import apply_cifar as j_apply_cifar
from neural_ode_metasolver_tpu.models import init_cifar as j_init_cifar
from neural_ode_metasolver_tpu.models import (
    premetanode4 as j_premetanode4,
    premetanode10 as j_premetanode10,
)
from neural_ode_metasolver_tpu.ops import SolverOptions as JSolverOptions
from neural_ode_metasolver_tpu.ops import create_solver as j_create_solver
from neural_ode_metasolver_tpu_torch.models import (
    build_model,
    cifar_params_from_jax,
)
from neural_ode_metasolver_tpu_torch.models.odenet_cifar10 import (
    _ode_kernel_u,
    premetanode10,
)
from neural_ode_metasolver_tpu_torch.ops import (
    SolverOptions,
    create_solver,
    parse_solver_dsl,
)
from neural_ode_metasolver_tpu_torch.serving import ServedModel


def _jax_model(ctor, in_planes, seed=0):
    cfg = ctor(in_planes=in_planes)
    params, state = j_init_cifar(jax.random.key(seed), cfg)
    return cfg, params, state


def _port_model(name, params, in_planes):
    model = build_model(name, device="cpu", in_planes=in_planes)
    np_params = jax.tree_util.tree_map(np.asarray, params)
    model.load_state_dict(cifar_params_from_jax(np_params))
    return model


def _images(n, seed=0):
    return np.random.RandomState(seed).rand(n, 32, 32, 3).astype(np.float32)


@pytest.mark.parametrize("in_planes,u0", [(16, 0.5), (64, 0.5), (16, 2 / 3)])
def test_premetanode10_logits_match_jax(in_planes, u0):
    """The bar of tests/test_torch_parity_cifar.py:115: atol 3e-4 in f32,
    for both the kernel path (plain versions on the CPU) and the generic
    path."""
    cfg, params, state = _jax_model(j_premetanode10, in_planes)
    x = _images(2)
    logits_j, _, _ = j_apply_cifar(
        params, state, jnp.asarray(x),
        [j_create_solver("rk2", "u", n_steps=8, u0=u0)], JSolverOptions(),
        cfg=cfg)
    model = _port_model("premetanode10", params, in_planes)
    solvers = [create_solver("rk2", "u", n_steps=8, u0=u0)]
    with torch.inference_mode():
        for use_kernels in (True, False):
            got = model(torch.tensor(x), solvers, use_kernels=use_kernels)
            assert got.shape == (2, 10) and got.dtype == torch.float32
            np.testing.assert_allclose(got.numpy(), np.asarray(logits_j),
                                       atol=3e-4)


def test_premetanode4_generic_solver_matches_jax():
    """A config off the kernels' path (rk4, no res blocks) takes the
    generic meta_integrate and still matches the JAX forward."""
    cfg, params, state = _jax_model(j_premetanode4, 8)
    x = _images(2, seed=1)
    logits_j, _, _ = j_apply_cifar(
        params, state, jnp.asarray(x),
        [j_create_solver("rk4", "u2", n_steps=2, u0=0.3)], JSolverOptions(),
        cfg=cfg)
    model = _port_model("premetanode4", params, 8)
    with torch.inference_mode():
        got = model(torch.tensor(x),
                    [create_solver("rk4", "u2", n_steps=2, u0=0.3)])
    np.testing.assert_allclose(got.numpy(), np.asarray(logits_j), atol=3e-4)


@pytest.mark.parametrize("batch", [1, 3])
def test_served_model_on_cpu(batch):
    cfg, params, state = _jax_model(j_premetanode10, 16)
    x = _images(batch, seed=2)
    logits_j, _, _ = j_apply_cifar(
        params, state, jnp.asarray(x),
        [j_create_solver("rk2", "u", n_steps=8, u0=0.5)], JSolverOptions(),
        cfg=cfg)
    model = _port_model("premetanode10", params, 16)
    solvers = parse_solver_dsl("rk2,u,8,-1,0.5,-1")
    served = ServedModel(model, solvers, SolverOptions())
    got = served(x)  # numpy in, like a request body
    assert got.shape == (batch, 10) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(logits_j), atol=3e-4)
    served_bf16 = ServedModel(model, solvers, SolverOptions(),
                              compute_dtype=torch.bfloat16)
    got16 = served_bf16(torch.tensor(x))
    assert got16.shape == (batch, 10) and got16.dtype == torch.float32
    assert torch.isfinite(got16).all()
    # bf16 activations: a loose sanity bar, not parity
    np.testing.assert_allclose(got16.numpy(), np.asarray(logits_j), atol=0.1)


def test_ode_kernel_dispatch_rule():
    cfg = premetanode10(in_planes=16)
    rk2 = create_solver("rk2", "u", n_steps=8, u0=0.5)
    opts = SolverOptions()
    assert _ode_kernel_u(cfg, [rk2], opts) == 0.5
    # u is clamped into [eps, 1] before it reaches the kernel
    assert _ode_kernel_u(cfg, [create_solver("rk2", "u", 8, -1, 1.5, -1)],
                         opts) == 1.0
    assert _ode_kernel_u(cfg, [create_solver("rk2", "u", 8, -1, -1, -1)],
                         opts) == pytest.approx(np.finfo(np.float16).eps)
    off_path = [
        (cfg, [rk2, rk2], opts),
        (cfg, [create_solver("rk2", "u", step_size=0.125)], opts),
        (cfg, [create_solver("rk4", "u2", n_steps=8)], opts),
        (cfg, [rk2], SolverOptions(solver_mode="switch")),
        (premetanode10(in_planes=16, acts=("GeLU", "GeLUpoly", "GeLU")),
         [rk2], opts),
    ]
    for args in off_path:
        assert _ode_kernel_u(*args) is None


def test_build_model_params_match_jax_tree_and_init_bounds():
    for name, ctor in (("premetanode10", j_premetanode10),
                       ("premetanode4", j_premetanode4)):
        _, params, _ = _jax_model(ctor, 8)
        model = build_model(name, device="cpu", in_planes=8)
        sd = cifar_params_from_jax(jax.tree_util.tree_map(np.asarray, params))
        assert {k: tuple(v.shape) for k, v in sd.items()} == {
            k: tuple(v.shape) for k, v in model.state_dict().items()}
    for name, p in model.state_dict().items():
        if name.endswith("kernel"):
            fan_in = int(np.prod(p.shape[:-1]))
            assert p.abs().max() <= 1.0 / np.sqrt(fan_in) + 1e-7, name
    # a seed gives the same weights
    a = build_model("premetanode4", device="cpu", in_planes=8,
                    generator=torch.Generator().manual_seed(3))
    b = build_model("premetanode4", device="cpu", in_planes=8,
                    generator=torch.Generator().manual_seed(3))
    for (ka, va), (kb, vb) in zip(a.state_dict().items(),
                                  b.state_dict().items()):
        assert ka == kb and torch.equal(va, vb)


def test_convert_rejects_norm_trees_and_wrong_widths():
    """A norm tree converts (its scale and bias by name), and a model of
    another architecture rejects it: a norm-free one, or another width."""
    _, params, _ = _jax_model(j_premetanode10, 8)
    np_params = jax.tree_util.tree_map(np.asarray, params)
    normed = dict(np_params, bn1={"scale": np.ones(8, np.float32),
                                  "bias": np.zeros(8, np.float32)})
    sd = cifar_params_from_jax(normed)
    assert torch.equal(sd["params.bn1.scale"], torch.ones(8))
    with pytest.raises(RuntimeError, match="bn1"):
        build_model("premetanode10", device="cpu",
                    in_planes=8).load_state_dict(sd)
    model = build_model("premetanode10", device="cpu", in_planes=16)
    with pytest.raises(RuntimeError):
        model.load_state_dict(cifar_params_from_jax(np_params))


def test_build_model_names():
    with pytest.raises(ValueError, match="unknown model"):
        build_model("bogus", device="cpu")
    assert build_model("mnist", device="cpu", dim=8).input_shape == (
        28, 28, 1)
    for name in ("metanode10", "premetanode10"):
        model = build_model(name, device="cpu", in_planes=8,
                            norms=("GN",) * 3, num_gn_groups=4)
        assert model.cfg.block_type == (
            "basic" if name == "metanode10" else "prebasic")
        assert "params.bn1.scale" in model.state_dict()
