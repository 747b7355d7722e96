"""The MNIST slice of the PyTorch port against the JAX package: the ODEfunc,
the whole MetaNODE with weights carried by ``mnist_params_from_jax``, the
shipped trained checkpoint on real digits, and ``ServedModel``.

On the CPU every kernel wrapper runs its plain version, so
``use_kernels=True`` exercises the kernel path's dispatch and shapes; the
CUDA kernels are held against the same plain versions on the card
(``test_torch_cuda.py``, ``chip_smoke.py``).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neural_ode_metasolver_tpu.models.odenet_mnist import (
    MnistConfig as JMnistConfig,
    _odefunc_apply as j_odefunc_apply,
    _odefunc_init as j_odefunc_init,
    apply_mnist as j_apply_mnist,
    init_mnist as j_init_mnist,
)
from neural_ode_metasolver_tpu.ops import SolverOptions as JSolverOptions
from neural_ode_metasolver_tpu.ops import create_solver as j_create_solver
from neural_ode_metasolver_tpu_torch import launch_counts, reset_launch_counts
from neural_ode_metasolver_tpu_torch.models import (
    build_model,
    mnist_params_from_jax,
)
from neural_ode_metasolver_tpu_torch.models.odenet_mnist import (
    _odefunc_apply,
    apply_mnist,
)
from neural_ode_metasolver_tpu_torch.ops import create_solver, parse_solver_dsl
from neural_ode_metasolver_tpu_torch.serving import ServedModel

CKPT = os.path.join(os.path.dirname(__file__), "..", "examples",
                    "checkpoints", "mnist_digits_smoothing")

RK2 = ("rk2", "u", 8, 0.5)
EULER = ("euler", None, 4, None)
RK4 = ("rk4", "u2", 4, 1 / 3)


def _solvers(spec, jax_side):
    method, param, n_steps, u0 = spec
    if jax_side:
        u0 = None if u0 is None else np.float32(u0)
        return [j_create_solver(method, param, n_steps=n_steps, u0=u0)]
    return [create_solver(method, param, n_steps=n_steps, u0=u0)]


def _perturb_norms(tree, rs):
    """GroupNorm scales and biases away from their (1, 0) init, so the
    affine is exercised; the same arrays go to JAX and to the port."""
    if isinstance(tree, dict):
        if "scale" in tree:
            c = tree["scale"].shape[0]
            return {"scale": (1 + 0.3 * rs.randn(c)).astype(np.float32),
                    "bias": (0.2 * rs.randn(c)).astype(np.float32)}
        return {k: _perturb_norms(v, rs) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_perturb_norms(v, rs) for v in tree]
    return tree


def _images(n, seed=0):
    return np.random.RandomState(seed).rand(n, 28, 28, 1).astype(np.float32)


def _jax_params(cfg, seed=0):
    params = j_init_mnist(jax.random.key(seed), cfg)
    np_params = jax.tree_util.tree_map(np.asarray, params)
    return _perturb_norms(np_params, np.random.RandomState(seed + 100))


def _port_model(np_params, **overrides):
    model = build_model("mnist", device="cpu", **overrides)
    model.load_state_dict(mnist_params_from_jax(np_params))
    return model


def _jax_logits(np_params, x, cfg, spec):
    params = jax.tree_util.tree_map(jnp.asarray, np_params)
    solvers = _solvers(spec, True) if cfg.is_odenet else None
    logits, _ = j_apply_mnist(params, jnp.asarray(x), solvers,
                              JSolverOptions(), cfg=cfg)
    return np.asarray(logits)


@pytest.mark.parametrize("t", [0.0, 0.3125])
@pytest.mark.parametrize("act", ["relu", "softplus"])
def test_odefunc_matches_jax(t, act):
    dim = 64
    rs = np.random.RandomState(1)
    p = jax.tree_util.tree_map(np.asarray,
                               j_odefunc_init(jax.random.key(1), dim))
    p = _perturb_norms(p, rs)
    x = rs.randn(2, 6, 6, dim).astype(np.float32)
    j_act = {"relu": jax.nn.relu, "softplus": jax.nn.softplus}[act]
    ref = np.asarray(j_odefunc_apply(
        jax.tree_util.tree_map(jnp.asarray, p), jnp.float32(t),
        jnp.asarray(x), j_act))
    tp = {k: {kk: torch.tensor(vv) for kk, vv in v.items()}
          for k, v in p.items()}
    for use_kernels in (True, False):
        got = _odefunc_apply(tp, torch.tensor(t), torch.tensor(x), act,
                             use_kernels)
        np.testing.assert_allclose(got.numpy(), ref, atol=1e-4)


MODEL_CASES = [
    pytest.param(16, "conv", True, False, RK2, id="d16-conv-ode-rk2"),
    pytest.param(64, "conv", True, False, RK2, id="d64-conv-ode-rk2"),
    pytest.param(16, "res", True, False, RK2, id="d16-res-ode-rk2"),
    pytest.param(64, "res", True, False, RK2, id="d64-res-ode-rk2"),
    pytest.param(16, "conv", False, False, None, id="d16-conv-resnet"),
    pytest.param(16, "res", False, False, None, id="d16-res-resnet"),
    pytest.param(16, "conv", True, True, RK2, id="d16-conv-ode-tanh"),
    pytest.param(16, "conv", True, False, EULER, id="d16-conv-ode-euler4"),
    pytest.param(16, "conv", True, False, RK4, id="d16-conv-ode-rk4"),
]


@pytest.mark.parametrize("dim,down,is_odenet,use_act,spec", MODEL_CASES)
def test_mnist_logits_match_jax(dim, down, is_odenet, use_act, spec):
    """Logits at atol 1e-4 / rtol 1e-4, on both the kernel path and the
    plain path."""
    overrides = dict(dim=dim, downsampling_method=down, is_odenet=is_odenet,
                     use_activation_type=use_act, activation_type="tanh")
    cfg = JMnistConfig(**overrides)
    np_params = _jax_params(cfg)
    x = _images(2)
    ref = _jax_logits(np_params, x, cfg, spec)
    model = _port_model(np_params, **overrides)
    solvers = _solvers(spec, False) if is_odenet else None
    with torch.inference_mode():
        for use_kernels in (True, False):
            got = model(torch.tensor(x), solvers, use_kernels=use_kernels)
            assert got.shape == (2, 10) and got.dtype == torch.float32
            np.testing.assert_allclose(got.numpy(), ref, atol=1e-4,
                                       rtol=1e-4)


def _restore_shipped():
    from neural_ode_metasolver_tpu.models.api import build_model as j_build
    from neural_ode_metasolver_tpu.training import (
        create_train_state,
        make_optimizer,
        restore_checkpoint,
    )

    model = j_build("mnist", dim=64)
    tx = make_optimizer("rmsprop", 1e-3, weight_decay=5e-4)
    # an abstract restore target: tracing the init costs a fraction of
    # running it
    target = jax.eval_shape(lambda k: create_train_state(model, tx, k),
                            jax.random.key(0))
    cpu = jax.sharding.SingleDeviceSharding(jax.devices("cpu")[0])
    target = jax.tree_util.tree_map(
        lambda s: jax.ShapeDtypeStruct(s.shape, s.dtype, sharding=cpu), target)
    ts, cfg = restore_checkpoint(CKPT, target)
    return model, ts, cfg


@pytest.mark.skipif(not os.path.isdir(CKPT),
                    reason="shipped artifact not present")
def test_shipped_checkpoint_matches_jax_on_real_digits():
    """The trained MetaNODE of examples/checkpoints, carried into the port:
    logits within 1e-4 of JAX on 256 test digits, the same predictions,
    and the accuracy bound of tests/test_shipped_artifact.py."""
    from neural_ode_metasolver_tpu.data import load_digits_dataset
    from neural_ode_metasolver_tpu.ops import SolverOptions as JOpts
    from neural_ode_metasolver_tpu.ops import parse_solver_dsl as j_parse

    j_model, ts, cfg = _restore_shipped()
    _, test_ds = load_digits_dataset(seed=0)
    x, y = test_ds.images[:256], test_ds.labels[:256]
    ref, _, _ = j_model.apply(ts.params, ts.model_state, jnp.asarray(x),
                              j_parse(cfg["solvers"]), JOpts())
    ref = np.asarray(ref)

    np_params = jax.tree_util.tree_map(np.asarray, ts.params)
    model = _port_model(np_params, dim=64)
    served = ServedModel(model, parse_solver_dsl(cfg["solvers"]))
    got = served(x).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-4)
    assert np.array_equal(got.argmax(-1), ref.argmax(-1))
    acc = float((got.argmax(-1) == y).mean())
    assert acc >= float(cfg["clean_acc"]) - 0.05
    assert acc > 0.85


@pytest.mark.parametrize("batch", [1, 3])
def test_served_mnist_on_cpu(batch):
    """f32 by default; the logits are the model's own (its JAX parity is
    test_mnist_logits_match_jax), and a CPU run launches no kernel."""
    model = build_model("mnist", device="cpu", dim=16)
    solvers = parse_solver_dsl("rk2,u,8,-1,0.5,-1")
    served = ServedModel(model, solvers)
    x = _images(batch, seed=3)
    reset_launch_counts()
    got = served(x)  # numpy in, like a request body
    assert got.shape == (batch, 10) and got.dtype == torch.float32
    assert launch_counts() == {}
    with torch.inference_mode():
        ref = model(torch.tensor(x), solvers, use_kernels=False)
    torch.testing.assert_close(got, ref, rtol=0, atol=0)
    with pytest.raises(ValueError, match="28, 28, 1"):
        served(np.zeros((batch, 32, 32, 3), np.float32))


def test_mnist_entry_point_needs_a_card_or_an_explicit_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the no-card path cannot run")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model("mnist", dim=16)
    model = build_model("mnist", device="cpu", dim=16)
    assert model.device == torch.device("cpu")
    assert model.input_shape == (28, 28, 1)


def test_mnist_training_options_and_bad_configs_raise():
    """The training options run (their parity with JAX is in
    tests/test_torch_mnist_training.py) and leave the logits as they are;
    the adjoint's logits equal backprop's; bad configs raise."""
    model = build_model("mnist", device="cpu", dim=16)
    x = torch.tensor(_images(1))
    solvers = parse_solver_dsl("rk2,u,2,-1,0.5,-1")
    with torch.no_grad():
        ref = model(x, solvers)
        for kw in (dict(ss_loss=True), dict(remat=True), dict(unroll=2),
                   dict(train=True)):
            got = apply_mnist(model.params, x, solvers, cfg=model.cfg, **kw)
            torch.testing.assert_close(got, ref, rtol=0, atol=0)
        _, aux = apply_mnist(model.params, x, solvers, cfg=model.cfg,
                             ss_loss=True, return_aux=True)
        assert float(aux["ss_loss"]) > 0
        got = apply_mnist(model.params, x, solvers, cfg=model.cfg,
                          integration_method="adjoint")
        torch.testing.assert_close(got, ref, rtol=0, atol=0)
    with pytest.raises(ValueError, match="integration_method"):
        apply_mnist(model.params, x, solvers, cfg=model.cfg,
                    integration_method="seminorm")
    with pytest.raises(ValueError, match="solvers"):
        model(x, None)
    with pytest.raises(ValueError, match="downsampling"):
        build_model("mnist", device="cpu", downsampling_method="pool")
    with pytest.raises(ValueError, match="activation"):
        build_model("mnist", device="cpu", use_activation_type=True,
                    activation_type="elu")


def test_forward_computes_f32_without_tf32_and_restores_the_flags():
    """The served f32 path never takes TF32, whatever the process flags:
    the forward turns it off for its convs and matmuls and restores the
    caller's flags afterwards, also when the forward raises."""
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = cudnn.allow_tf32, matmul.allow_tf32
    seen = []

    def probe(*args, **kwargs):
        seen.append((cudnn.allow_tf32, matmul.allow_tf32))
        if len(seen) == 2:
            raise RuntimeError("probe")
        return torch.zeros(1, 10)

    try:
        cudnn.allow_tf32 = matmul.allow_tf32 = True
        model = build_model("mnist", device="cpu", dim=16)
        model.apply_fn = probe
        ServedModel(model, parse_solver_dsl("rk2,u,2,-1,0.5,-1"))(
            np.zeros((1, 28, 28, 1), np.float32))
        assert (cudnn.allow_tf32, matmul.allow_tf32) == (True, True)
        with pytest.raises(RuntimeError, match="probe"):
            model(torch.zeros(1, 28, 28, 1), None)
        assert (cudnn.allow_tf32, matmul.allow_tf32) == (True, True)
        assert seen == [(False, False)] * 2
    finally:
        cudnn.allow_tf32, matmul.allow_tf32 = saved
