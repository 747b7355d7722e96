"""The port's optimizers against the JAX package's optax chains, on the CPU:
adam, global-norm clipping, ``every_k`` accumulation (the mean of k
gradients) under a cyclic lr and momentum, and the non-finite backoff with
a NaN gradient injected.  Six updates on the same gradients; parameters
within 1e-6 relative after every update (to 1e-6 of max|p| where an element
is near 0), and the counts and backoff scale as JAX's."""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from neural_ode_metasolver_tpu.training import (
    cyclic_lr as j_cyclic_lr,
    cyclic_momentum as j_cyclic_momentum,
    make_optimizer as j_make_optimizer,
)
from neural_ode_metasolver_tpu_torch.training import (
    Adam,
    Optimizer,
    cyclic_lr,
    cyclic_momentum,
    make_optimizer,
)
from test_torch_runners import one_torch_thread  # noqa: F401 (autouse)

N_UPDATES = 6
SHAPES = {"a": (3, 4), "b": (5,), "c": (2, 2, 3)}


def _params_and_grads(nan_at=None, scale=1.0):
    rs = np.random.RandomState(0)
    p0 = {k: rs.randn(*s).astype(np.float32) for k, s in SHAPES.items()}
    grads = []
    for i in range(N_UPDATES):
        g = {k: (scale * rs.randn(*s)).astype(np.float32)
             for k, s in SHAPES.items()}
        if i == nan_at:
            g["b"][2] = np.nan
        grads.append(g)
    return p0, grads


def _run(kind, lr, momentum, kw, nan_at=None, grad_scale=1.0):
    """Six updates in both frameworks; returns the per-update params."""
    p0, grads = _params_and_grads(nan_at, grad_scale)
    jlr, plr = lr
    jm, pm = momentum
    tx = j_make_optimizer(kind, jlr, momentum=jm, weight_decay=5e-4, **kw)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    js = tx.init(jp)
    opt = make_optimizer(kind, plr, momentum=pm, weight_decay=5e-4, **kw)
    tp = {k: torch.tensor(v) for k, v in p0.items()}
    ts = opt.init(tp)
    out = []
    for g in grads:
        upd, js = tx.update({k: jnp.asarray(v) for k, v in g.items()}, js,
                            jp)
        jp = optax.apply_updates(jp, upd)
        opt.update(tp, [torch.tensor(g[k]) for k in tp], ts)
        out.append(({k: np.asarray(v) for k, v in jp.items()},
                    {k: v.numpy().copy() for k, v in tp.items()}))
    return out, js, ts, opt


def _close(out):
    for i, (jp, tp) in enumerate(out):
        for k in jp:
            assert jp[k].dtype == np.float32
            bar = 1e-6 * max(1.0, float(np.abs(jp[k]).max()))
            np.testing.assert_allclose(tp[k], jp[k], rtol=1e-6, atol=bar,
                                       err_msg=f"update {i}, param {k}")


def _schedules():
    return ((j_cyclic_lr(1e-3, 0.1, 3), cyclic_lr(1e-3, 0.1, 3)),
            (j_cyclic_momentum(3), cyclic_momentum(3)))


def test_adam_matches_optax():
    out, js, ts, opt = _run("adam", (1e-2, 1e-2), (0.9, 0.9), {})
    assert isinstance(opt, Adam) and ts["count"] == N_UPDATES
    _close(out)
    lr, _ = _schedules()
    out, *_ = _run("adam", lr, (0.9, 0.9), {})
    _close(out)


@pytest.mark.parametrize("kind", ["sgd", "rmsprop", "adam"])
def test_grad_clip_matches_optax(kind):
    """Clipping at a norm the gradients exceed (every update clipped) and
    at one they stay under."""
    lr, mom = _schedules()
    for clip in (0.5, 1e3):
        out, _, _, opt = _run(kind, lr, mom, {"grad_clip": clip})
        assert isinstance(opt, Optimizer)
        _close(out)


@pytest.mark.parametrize("kind", ["sgd", "rmsprop", "adam"])
@pytest.mark.parametrize("every_k", [2, 3])
def test_every_k_matches_optax_multisteps(kind, every_k):
    """The mean of k gradients every k-th iteration, the lr ticking every
    iteration and the cyclic momentum's phase remapped, with clipping
    inside the accumulation; the params do not move between emits."""
    lr, mom = _schedules()
    out, js, ts, _ = _run(kind, lr, mom, {"every_k": every_k,
                                          "grad_clip": 2.0})
    _close(out)
    assert ts["count"] == N_UPDATES and ts["emits"] == N_UPDATES // every_k
    assert ts["mini_step"] == N_UPDATES % every_k
    for i in range(1, N_UPDATES):
        moved = any(not np.array_equal(out[i][1][k], out[i - 1][1][k])
                    for k in SHAPES)
        assert moved == ((i + 1) % every_k == 0), i


@pytest.mark.parametrize("every_k", [1, 2])
def test_nonfinite_backoff_matches_optax(every_k):
    """A NaN in the third gradient: that update is dropped with every count
    and buffer left as it was, the scale dips by the backoff and then
    recovers by 1.1 a finite step, scaling the updates meanwhile."""
    lr, mom = _schedules()
    out, js, ts, _ = _run("sgd", lr, mom, {"nonfinite_backoff": 0.5,
                                           "every_k": every_k}, nan_at=2)
    _close(out)
    for k in SHAPES:
        np.testing.assert_array_equal(out[2][1][k], out[1][1][k])
    assert all(np.isfinite(tp[k]).all() for _, tp in out for k in tp)
    assert ts["n_skipped"] == int(js.n_skipped) == 1
    assert ts["scale"] == pytest.approx(float(js.scale), rel=1e-7)
    assert ts["scale"] == pytest.approx(0.5 * 1.1 ** 3, rel=1e-6)
    assert ts["count"] == N_UPDATES - 1
    # an overflowing global norm counts as non-finite too
    out, js, ts, _ = _run("rmsprop", lr, mom, {"nonfinite_backoff": 0.25},
                          grad_scale=1e20)
    assert ts["n_skipped"] == int(js.n_skipped) == N_UPDATES
    assert ts["scale"] == pytest.approx(float(js.scale)) == 1e-3
    _close(out)


def test_optimizer_state_round_trips_through_create_train_state():
    """A wrapped optimizer's state (numbers and tensors) loads into a fresh
    state of the same structure, and refuses another structure."""
    from neural_ode_metasolver_tpu_torch.models import build_model
    from neural_ode_metasolver_tpu_torch.training import create_train_state

    model = build_model("mnist", device="cpu", dim=8)
    opt = make_optimizer("adam", 1e-3, every_k=2, nonfinite_backoff=0.5)
    state = create_train_state(model, opt)
    grads = [torch.ones_like(p) for p in state.params.values()]
    for _ in range(3):
        opt.update(state.params, grads, state.opt_state)
    model2 = build_model("mnist", device="cpu", dim=8)
    state2 = create_train_state(model2, opt, opt_state=state.opt_state)
    for key in ("count", "emits", "mini_step", "scale", "n_skipped"):
        assert state2.opt_state[key] == state.opt_state[key]
    for name, t in state.opt_state["mu"].items():
        assert torch.equal(state2.opt_state["mu"][name], t)
    with pytest.raises(ValueError):
        create_train_state(model2, make_optimizer("adam", 1e-3),
                           opt_state=state.opt_state)
    with pytest.raises(ValueError):
        make_optimizer("adamw", 1e-3)
