"""The whole CIFAR family of the port against the JAX package's, on the
CPU: ``apply_cifar``'s logits and new model state for the basic and
prebasic blocks under each norm, SN and WN, the ResNet counts, the
pre-activation order and every registry depth; the B2 dispatch rule; and
the train step with a model state against JAX's ``make_train_step``.

Small sizes throughout (in_planes 8, batch 2-4, one RK2 step); the JAX
side in f32 (``tests/conftest.py`` turns x64 on), weights and state
carried across with ``cifar_params_from_jax`` / ``cifar_state_from_jax``.
Logits and state within 3e-4 (the bar of
``tests/test_torch_parity_cifar.py``)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neural_ode_metasolver_tpu.models import MODEL_REGISTRY as J_REGISTRY
from neural_ode_metasolver_tpu.models import apply_cifar as j_apply_cifar
from neural_ode_metasolver_tpu.models import init_cifar as j_init_cifar
from neural_ode_metasolver_tpu.models.api import build_model as j_build_model
from neural_ode_metasolver_tpu.ops import SolverOptions as JSolverOptions
from neural_ode_metasolver_tpu.ops import create_solver as j_create_solver
from neural_ode_metasolver_tpu.training import (
    AttackConfig as JAttackConfig,
    TrainState as JTrainState,
    make_optimizer as j_make_optimizer,
    make_train_step as j_make_train_step,
)
from neural_ode_metasolver_tpu_torch.models import (
    build_model,
    cifar_params_from_jax,
    cifar_state_from_jax,
)
from neural_ode_metasolver_tpu_torch.models import odenet_cifar10
from neural_ode_metasolver_tpu_torch.models.api import _flatten
from neural_ode_metasolver_tpu_torch.ops import SolverOptions, create_solver
from neural_ode_metasolver_tpu_torch.training import (
    AttackConfig,
    create_train_state,
    make_optimizer,
    make_train_step,
)
from test_torch_runners import one_torch_thread  # noqa: F401 (autouse)

P = 8  # in_planes


def _np(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


def _jax_model(name, seed=0, **kw):
    """JAX params and a state whose BN statistics are moved off their init
    (so eval mode reads something), as numpy trees."""
    cfg = J_REGISTRY[name](in_planes=P, **kw)
    params, state = j_init_cifar(jax.random.key(seed), cfg)
    rs = np.random.RandomState(seed)

    def moved(path, a):
        name = jax.tree_util.keystr(path)
        if name.endswith("['mean']"):
            return (rs.randn(*a.shape) * 0.1).astype(np.float32)
        if name.endswith("['var']"):
            return (rs.rand(*a.shape) + 0.5).astype(np.float32)
        return np.asarray(a, np.float32)

    return cfg, _np(params), jax.tree_util.tree_map_with_path(moved, state)


def _port_model(name, np_params, np_state, **kw):
    model = build_model(name, device="cpu", in_planes=P, **kw)
    model.load_state_dict({**cifar_params_from_jax(np_params),
                           **cifar_state_from_jax(np_state)})
    return model


def _images(n, seed=0):
    return np.random.RandomState(seed).rand(n, 32, 32, 3).astype(np.float32)


FAMILY = [
    *[(f"{pre}metanode10", dict(norms=(k,) * 3, num_gn_groups=4))
      for pre in ("", "pre") for k in ("GN", "BN", "LN", "IN")],
    ("metanode10", dict(norms=("BN", "GN", "IN"), num_gn_groups=4,
                        param_norms=("SN", "SN", "SN"))),
    ("premetanode10", dict(norms=("IN", "LN", "BN"),
                           param_norms=("WN", "WN", "WN"))),
    ("premetanode10", dict(norms=("BN", "NF", "BN"),
                           param_norms=("SN", "PNF", "WN"),
                           faithful_preact_bug=False)),
    ("metanode10", dict(norms=("GN",) * 3, num_gn_groups=4,
                        is_odenet=False)),
    ("premetanode10", dict(norms=("BN",) * 3, is_odenet=False)),
    ("metanode4", dict(norms=("BN",) * 3, acts=("ReLU", "Tanh", "GeLUpoly"))),
    ("metanode6", dict(norms=("GN",) * 3, num_gn_groups=4,
                       acts=("Softsign", "AF", "GeLU"))),
    ("metanode18", dict(norms=("GN",) * 3, num_gn_groups=8)),
    ("metanode34", dict(norms=("GN",) * 3, num_gn_groups=8)),
    ("premetanode34", dict()),
]


def _ids():
    out = []
    for name, kw in FAMILY:
        tag = "-".join(f"{k}={''.join(v) if isinstance(v, tuple) else v}"
                       for k, v in kw.items() if k != "num_gn_groups")
        out.append(f"{name}-{tag}" if tag else name)
    return out


@pytest.mark.parametrize("name,kw", FAMILY, ids=_ids())
def test_apply_cifar_matches_jax(name, kw):
    """Logits in train mode and, where the config has a model state (BN,
    SN: without one the two modes are one function), in eval mode; the new
    state of the train-mode forward (BN running statistics, SN vectors);
    eval mode returns the state it read."""
    cfg, params, state = _jax_model(name, **kw)
    model = _port_model(name, params, state, **kw)
    x = _images(2)
    jsolvers = [j_create_solver("rk2", "u", n_steps=1, u0=np.float32(0.5))]
    psolvers = [create_solver("rk2", "u", n_steps=1, u0=0.5)]
    before = {k: v.clone() for k, v in model.state_dict().items()}
    for train in ((False, True) if list(model.buffers()) else (True,)):
        jl, jst, _ = j_apply_cifar(
            jax.tree_util.tree_map(jnp.asarray, params),
            jax.tree_util.tree_map(jnp.asarray, state), jnp.asarray(x),
            jsolvers, JSolverOptions(), cfg=cfg, train=train)
        with torch.no_grad():
            pl, aux = model(torch.tensor(x), psolvers, train=train,
                            return_aux=True)
        np.testing.assert_allclose(pl.numpy(), np.asarray(jl), atol=3e-4)
        want = cifar_state_from_jax(_np(jst))
        got = _flatten(aux["model_state"], "state", {})
        assert set(got) == set(want) == {
            k for k, _ in model.named_buffers()}
        for k in want:
            np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                       atol=3e-4, err_msg=k)
    # the forward never writes the buffers
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), k


def test_ode_kernel_u_takes_only_the_prebasic_nf_rhs(monkeypatch):
    """B2 computes conv2(gelu(conv1(gelu(y)))), the prebasic NF RHS: the
    basic family's RHS (gelu(conv2(gelu(conv1(y))))) takes the generic
    path, and its logits match JAX's."""
    _ode_kernel_u = odenet_cifar10._ode_kernel_u
    rk2 = create_solver("rk2", "u", n_steps=2, u0=0.5)
    opts = SolverOptions()
    assert _ode_kernel_u(odenet_cifar10.premetanode10(), [rk2], opts) == 0.5
    assert _ode_kernel_u(odenet_cifar10.metanode10(), [rk2], opts) is None
    cfg, params, state = _jax_model("metanode10")
    model = _port_model("metanode10", params, state)

    def no_b2(*args, **kwargs):
        raise AssertionError("the basic RHS went to kernel B2")

    monkeypatch.setattr(odenet_cifar10, "ode_block_rk2_forward", no_b2)
    x = _images(2, seed=1)
    jl, _, _ = j_apply_cifar(
        params, state, jnp.asarray(x),
        [j_create_solver("rk2", "u", n_steps=2, u0=np.float32(0.5))],
        JSolverOptions(), cfg=cfg)
    with torch.inference_mode():
        pl = model(torch.tensor(x), [rk2], use_kernels=True)
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), atol=3e-4)


STEP_CASES = [
    ("metanode6", dict(norms=("GN",) * 3, num_gn_groups=4)),
    ("premetanode6", dict(norms=("BN", "BN", "BN"),
                          param_norms=("SN", "SN", "SN"))),
]


@pytest.mark.parametrize("name,kw", STEP_CASES, ids=["GN", "BN+SN"])
def test_train_step_with_model_state_matches_jax(name, kw):
    """Two FGSM steps (SGD momentum 0.9, lr 0.05) from the same weights
    and state: each step's loss within 1e-4, then params within 1e-4 of
    max|p| and the model state within 3e-4.  The second step's attack
    reads the state the first committed.  Then a NaN batch under
    skip_nonfinite: the port leaves params and model state as they were,
    as JAX does."""
    jmodel = j_build_model(name, in_planes=P, **kw)
    _, params, state = _jax_model(name, seed=2, **kw)
    pmodel = _port_model(name, params, state, **kw)
    rs = np.random.RandomState(3)
    batches = [(rs.rand(4, 32, 32, 3).astype(np.float32) * 2 - 1,
                rs.randint(0, 10, 4)) for _ in range(2)]
    atk = dict(mode="fgsm", eps=8 / 255, mean=(0.5,) * 3, std=(0.25,) * 3)
    tx = j_make_optimizer("sgd", 0.05, momentum=0.9)
    jps = jax.tree_util.tree_map(jnp.asarray, params)
    jts = JTrainState(step=jnp.zeros((), jnp.int32), params=jps,
                      model_state=jax.tree_util.tree_map(jnp.asarray, state),
                      opt_state=tx.init(jps))
    jsolvers = [j_create_solver("rk2", "u", n_steps=1, u0=np.float32(0.5))]
    jstep = j_make_train_step(jmodel, tx, jsolvers, JSolverOptions(),
                              attack_cfg=JAttackConfig(**atk),
                              skip_nonfinite=True, donate=False)
    opt = make_optimizer("sgd", 0.05, momentum=0.9)
    pts = create_train_state(pmodel, opt)
    pstep = make_train_step(pmodel, opt,
                            [create_solver("rk2", "u", n_steps=1, u0=0.5)],
                            attack_cfg=AttackConfig(**atk),
                            skip_nonfinite=True)
    for i, (x, y) in enumerate(batches):
        jts, jm = jstep(jts, jnp.asarray(x), jnp.asarray(y),
                        jax.random.key(i))
        pts, pm = pstep(pts, torch.tensor(x), torch.tensor(y),
                        torch.Generator().manual_seed(i))
        assert abs(float(jm["loss"]) - pm["loss"].item()) < 1e-4, i
    jp = cifar_params_from_jax(_np(jts.params))
    bar = 1e-4 * max(float(v.abs().max()) for v in jp.values())
    for k, v in jp.items():
        np.testing.assert_allclose(pts.params[k].detach().numpy(), v.numpy(),
                                   rtol=0, atol=bar, err_msg=k)
    js = cifar_state_from_jax(_np(jts.model_state))
    assert set(js) == set(pts.model_state)
    for k, v in js.items():
        np.testing.assert_allclose(pts.model_state[k].numpy(), v.numpy(),
                                   atol=3e-4, err_msg=k)
    if "BN" in kw["norms"]:  # the state moved off what it started at
        assert not np.allclose(js["state.bn1.mean"].numpy(),
                               state["bn1"]["mean"])
    kept_p = {k: v.detach().clone() for k, v in pts.params.items()}
    kept_s = {k: v.clone() for k, v in pts.model_state.items()}
    nan_x = np.full((4, 32, 32, 3), np.nan, np.float32)
    jts2, jm = jstep(jts, jnp.asarray(nan_x), jnp.asarray(batches[0][1]),
                     jax.random.key(9))
    pts, pm = pstep(pts, torch.tensor(nan_x), torch.tensor(batches[0][1]),
                    torch.Generator().manual_seed(9))
    assert float(jm["skipped_nonfinite"]) == pm["skipped_nonfinite"].item() \
        == 1.0
    for k, v in pts.params.items():
        assert torch.equal(v, kept_p[k]), k
    for k, v in pts.model_state.items():
        assert torch.equal(v, kept_s[k]), k
    assert all(np.array_equal(a, b) for a, b in zip(
        jax.tree_util.tree_leaves(jts2.model_state),
        jax.tree_util.tree_leaves(jts.model_state)))
