"""The models of the port under ``integration_method="adjoint"`` against the
JAX package's, on the CPU: the MNIST MetaNODE (dim 16), premetanode10
(in_planes 16) and metanode10 with GroupNorm and spectral norm in every
slot (in_planes 8; the adjoint's gradient goes to SN's materialized
``p_eff`` and autograd carries it to the raw params).

Each: the adjoint's logits equal backprop's in the port (JAX's test holds
them within 1e-5), and the cross-entropy's gradients of every parameter
within 1e-4 of max|g| of JAX's adjoint gradients from the same weights
(``models/convert.py``).  Both sides in f32, RK2 u=0.5 over 2 steps,
batch 2."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neural_ode_metasolver_tpu.attacks import cross_entropy as j_xent
from neural_ode_metasolver_tpu.models import MODEL_REGISTRY as J_REGISTRY
from neural_ode_metasolver_tpu.models import apply_cifar as j_apply_cifar
from neural_ode_metasolver_tpu.models import init_cifar as j_init_cifar
from neural_ode_metasolver_tpu.models.odenet_mnist import (
    MnistConfig as JMnistConfig,
    apply_mnist as j_apply_mnist,
    init_mnist as j_init_mnist,
)
from neural_ode_metasolver_tpu.ops import SolverOptions as JSolverOptions
from neural_ode_metasolver_tpu.ops import create_solver as j_create_solver
from neural_ode_metasolver_tpu_torch.attacks import cross_entropy
from neural_ode_metasolver_tpu_torch.models import (
    build_model,
    cifar_params_from_jax,
    cifar_state_from_jax,
    mnist_params_from_jax,
)
from neural_ode_metasolver_tpu_torch.ops import create_solver
from test_torch_runners import one_torch_thread  # noqa: F401 (autouse)

N_STEPS = 2
LABELS = np.array([3, 7])


def _np(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


def _mnist():
    cfg = JMnistConfig(dim=16)
    params = _np(j_init_mnist(jax.random.key(0), cfg))
    x = np.random.RandomState(0).rand(2, 28, 28, 1).astype(np.float32)

    def j_logits(p, method):
        return j_apply_mnist(p, jnp.asarray(x), _j_solvers(),
                             JSolverOptions(), cfg=cfg,
                             integration_method=method)[0]

    model = build_model("mnist", device="cpu", dim=16)
    model.load_state_dict(mnist_params_from_jax(params))
    return params, x, j_logits, model, mnist_params_from_jax


def _cifar(name, **kw):
    cfg = J_REGISTRY[name](**kw)
    params, state = j_init_cifar(jax.random.key(0), cfg)
    params, state = _np(params), _np(state)
    x = np.random.RandomState(0).rand(2, 32, 32, 3).astype(np.float32)

    def j_logits(p, method):
        return j_apply_cifar(p, jax.tree_util.tree_map(jnp.asarray, state),
                             jnp.asarray(x), _j_solvers(), JSolverOptions(),
                             cfg=cfg, train=True,
                             integration_method=method)[0]

    model = build_model(name, device="cpu", **kw)
    model.load_state_dict({**cifar_params_from_jax(params),
                           **cifar_state_from_jax(state)})
    return params, x, j_logits, model, cifar_params_from_jax


def _j_solvers():
    return [j_create_solver("rk2", "u", n_steps=N_STEPS, u0=np.float32(0.5))]


MODELS = {
    "mnist-dim16": _mnist,
    "premetanode10-in16": lambda: _cifar("premetanode10", in_planes=16),
    "metanode10-GN-SN": lambda: _cifar(
        "metanode10", in_planes=8, norms=("GN",) * 3, num_gn_groups=4,
        param_norms=("SN",) * 3),
}


@pytest.mark.parametrize("which", list(MODELS))
def test_adjoint_model_matches_backprop_logits_and_jax_grads(which):
    params, x, j_logits, model, convert = MODELS[which]()
    solvers = [create_solver("rk2", "u", n_steps=N_STEPS, u0=0.5)]
    xt, yt = torch.tensor(x), torch.tensor(LABELS)
    names = [k for k, _ in model.named_parameters()]
    out = {}
    for method in ("backprop", "adjoint"):
        logits = model(xt, solvers, train=True,
                       integration_method=method)
        grads = torch.autograd.grad(cross_entropy(logits, yt),
                                    list(model.parameters()))
        out[method] = (logits.detach(), dict(zip(names, grads)))
    torch.testing.assert_close(out["adjoint"][0], out["backprop"][0],
                               rtol=0, atol=1e-5)

    def j_loss(p):
        return j_xent(j_logits(p, "adjoint"), jnp.asarray(LABELS))

    jg = convert(_np(jax.grad(j_loss)(
        jax.tree_util.tree_map(jnp.asarray, params))))
    got = out["adjoint"][1]
    assert set(jg) == set(got)
    bar = 1e-4 * max(float(v.abs().max()) for v in jg.values())
    for k, v in jg.items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=0,
                                   atol=bar, err_msg=k)
