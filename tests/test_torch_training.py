"""The training slice of the PyTorch port against the JAX package, on the
CPU: schedules, the SGD update, solver-smoothing noise, the FGSM-random
attack, and the whole adversarial train step (``make_train_step``) in f32
and under the bf16 policy.

Inputs come from numpy seeds; the JAX side is cast to f32 (``conftest.py``
turns on x64).  Random draws are pinned in both frameworks where the
streams differ (torch's generator is not threefry): the attack's uniform
start as in ``tests/test_train_step_parity.py:240-248``, the noised u as at
``:209-216,269-279``.  Each JAX train-step variant is compiled once.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from neural_ode_metasolver_tpu.attacks import (
    cross_entropy as j_cross_entropy,
    fgsm_random as j_fgsm_random,
)
from neural_ode_metasolver_tpu.models import premetanode10 as j_premetanode10
from neural_ode_metasolver_tpu.models.api import make_cifar_model
from neural_ode_metasolver_tpu.ops import SolverOptions as JSolverOptions
from neural_ode_metasolver_tpu.ops import create_solver as j_create_solver
from neural_ode_metasolver_tpu.ops import noise as j_noise
from neural_ode_metasolver_tpu.training import (
    AttackConfig as JAttackConfig,
    NoiseConfig as JNoiseConfig,
    TrainState as JTrainState,
    cyclic_lr as j_cyclic_lr,
    cyclic_momentum as j_cyclic_momentum,
    make_optimizer as j_make_optimizer,
    make_train_step as j_make_train_step,
)
from neural_ode_metasolver_tpu.training import train as j_train_mod
from neural_ode_metasolver_tpu_torch import launch_counts, reset_launch_counts
from neural_ode_metasolver_tpu_torch.attacks import attacks as p_attacks
from neural_ode_metasolver_tpu_torch.models import (
    build_model,
    cifar_params_from_jax,
)
from neural_ode_metasolver_tpu_torch.ops import (
    SolverOptions,
    create_solver,
    noise as p_noise,
)
from neural_ode_metasolver_tpu_torch.training import (
    SGD,
    AttackConfig,
    LossConfig,
    NoiseConfig,
    constant_lr,
    create_train_state,
    cyclic_lr,
    cyclic_momentum,
    make_optimizer,
    make_train_step,
)
from neural_ode_metasolver_tpu_torch.training import train as p_train_mod
from tests.test_torch_runners import one_torch_thread  # noqa: F401

MEAN = (0.4914, 0.4822, 0.4465)
STD = (0.2023, 0.1994, 0.2010)
P, B, N = 16, 4, 5  # in_planes, batch, steps (test_train_step_parity.py:181)
BASE_LR, MAX_LR, SSU = 1e-7, 0.1, 3186
EPS, ALPHA = 8 / 255, 10 / 255
U_PIN = 0.55


# ---------------------------------------------------------------- schedules


@pytest.mark.parametrize("mode", ["triangular", "triangular2"])
@pytest.mark.parametrize("which", ["lr", "momentum"])
def test_cyclic_schedules_match_jax(mode, which):
    """Steps 0 .. 3 SSU (a step size of 7: three half-cycles, both
    triangles' corners); JAX evaluates in f32, the port in Python floats."""
    ssu = 7
    if which == "lr":
        ours, theirs = cyclic_lr(1e-3, 0.1, ssu, mode), j_cyclic_lr(
            1e-3, 0.1, ssu, mode)
    else:
        ours, theirs = cyclic_momentum(ssu, mode), j_cyclic_momentum(ssu, mode)
    got = np.array([ours(s) for s in range(3 * ssu + 1)])
    want = np.array([float(theirs(s)) for s in range(3 * ssu + 1)])
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    assert constant_lr(0.05)(123) == 0.05
    with pytest.raises(ValueError, match="CyclicLR mode"):
        cyclic_lr(0.1, 0.2, 4, "exp_range")


@pytest.mark.parametrize("which", ["lr", "momentum"])
def test_flagship_schedules_match_jax(which):
    """Every step 0 .. 3 * 3186 of the flagship schedules.  JAX forms
    1 - |step/s - 2 cycle + 1| in f32, which cancels near a cycle's start
    (to 2**-24 of 1) and rounds the value to f32; the port's Python floats
    do neither, so the bar is a few f32 ulps of the span and of the
    value."""
    steps = np.arange(3 * SSU + 1)
    if which == "lr":
        ours, theirs = cyclic_lr(BASE_LR, MAX_LR, SSU), j_cyclic_lr(
            BASE_LR, MAX_LR, SSU)
        span, top = MAX_LR - BASE_LR, MAX_LR
    else:
        ours, theirs = cyclic_momentum(SSU), j_cyclic_momentum(SSU)
        span, top = 0.9 - 0.8, 0.9
    got = np.array([ours(int(s)) for s in steps])
    want = np.asarray(theirs(jnp.asarray(steps)), np.float64)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=2.0 ** -22 * (span + top))


# -------------------------------------------------------------------- SGD


@pytest.mark.parametrize("momentum", ["cyclic", 0.9])
@pytest.mark.parametrize("ssu,atol", [(SSU, 1e-7), (3, 1e-6)])
def test_sgd_update_matches_optax(momentum, ssu, atol):
    """Five updates of make_optimizer('sgd', cyclic_lr, momentum, wd):
    weight decay coupled before the trace, the trace starting at zero,
    lr and momentum at the pre-increment count.  Params at the scale of the
    model's weights (kaiming bounds of at most 0.2).  The flagship SSU:
    within 1e-7.  SSU 3, where the lr climbs to 0.1 in five steps and
    updates reach 0.3: JAX's f32 schedule lands an ulp off the exact lr,
    so within 1e-6, a few ulps of the update."""
    import optax
    rs = np.random.RandomState(0)
    shapes = {"a": (3, 3, 4, 5), "b": (7,), "c": (6, 2)}
    p0 = {k: (0.1 * rs.randn(*s)).astype(np.float32)
          for k, s in shapes.items()}
    grads = [{k: rs.randn(*s).astype(np.float32) for k, s in shapes.items()}
             for _ in range(5)]
    j_mom = j_cyclic_momentum(ssu) if momentum == "cyclic" else momentum
    p_mom = cyclic_momentum(ssu) if momentum == "cyclic" else momentum
    tx = j_make_optimizer("sgd", j_cyclic_lr(1e-7, 0.1, ssu), momentum=j_mom,
                          weight_decay=5e-4)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    js = tx.init(jp)
    opt = make_optimizer("sgd", cyclic_lr(1e-7, 0.1, ssu), momentum=p_mom,
                         weight_decay=5e-4)
    tp = {k: torch.tensor(v) for k, v in p0.items()}
    ts = opt.init(tp)
    for g in grads:
        upd, js = tx.update({k: jnp.asarray(v) for k, v in g.items()}, js, jp)
        jp = optax.apply_updates(jp, upd)
        opt.update(tp, [torch.tensor(g[k]) for k in tp], ts)
        for k in tp:
            assert tp[k].dtype == torch.float32
            np.testing.assert_allclose(tp[k].numpy(),
                                       np.asarray(jp[k], np.float32),
                                       rtol=0, atol=atol)
    assert ts["count"] == 5


def test_optimizer_options_not_ported_raise():
    """adam and the wrappers are ported (checked against optax in
    tests/test_torch_optimizers.py); unknown names and every_k < 1
    raise."""
    from neural_ode_metasolver_tpu_torch.training import Adam, Optimizer

    assert isinstance(make_optimizer("adam", 0.1), Adam)
    wrapped = make_optimizer("sgd", 0.1, grad_clip=1.0)
    assert isinstance(wrapped, Optimizer) and wrapped.grad_clip == 1.0
    with pytest.raises(ValueError, match="unknown optimizer"):
        make_optimizer("lamb", 0.1)
    with pytest.raises(ValueError, match="every_k"):
        make_optimizer("sgd", 0.1, every_k=0)


# ------------------------------------------------------------------ noise

MEAN_U, NSTD = 0.5, 0.05


@pytest.fixture
def pinned_z(monkeypatch):
    """Pin the standard draw z of both frameworks' sample_noise."""
    box = {}

    def jax_draw(key, shape=(), dtype=jnp.float32):
        return jnp.full(shape, box["z"], jnp.float32)

    monkeypatch.setattr(jax.random, "normal", jax_draw)
    monkeypatch.setattr(jax.random, "cauchy", jax_draw)
    monkeypatch.setattr(torch, "randn",
                        lambda shape, **kw: torch.full(shape, box["z"]))
    monkeypatch.setattr(torch.Tensor, "cauchy_",
                        lambda self, **kw: self.fill_(box["z"]))
    return box


@pytest.mark.parametrize("noise_type", ["normal", "cauchy"])
@pytest.mark.parametrize("minimize", [False, True])
@pytest.mark.parametrize("z", [-2.5, -2.0, -1.95, -0.5, 0.0, 1.0, 1.95, 2.0,
                               2.5, 8.0])
def test_noise_params_with_pinned_draw_match_jax(pinned_z, noise_type,
                                                 minimize, z):
    """The same z gives the same (u, v): rejection to the mean outside
    mean +- 2 std, boundaries inclusive, v never rejected, and the
    minimize_rk2_error recentering at 2/3 with the window left at mean_u."""
    pinned_z["z"] = z
    kw = dict(mean_u=MEAN_U, mean_v=1 / 3, std=NSTD, bernoulli_p=1.0,
              noise_type=noise_type, minimize_rk2_error=minimize)
    ju, jv = j_noise.noise_params(jax.random.key(0), **kw)
    pu, pv = p_noise.noise_params(torch.Generator().manual_seed(0), **kw)
    assert pu.dtype == torch.float32 and pu.shape == ()
    assert float(pu) == float(np.float32(ju))
    assert float(pv) == float(np.float32(jv))
    if not minimize and abs(z) >= 2.0:
        assert float(pu) == np.float32(MEAN_U)  # the boundary rejects


def test_noise_gate_closed_gives_the_means():
    for seed in range(5):
        u, v = p_noise.noise_params(torch.Generator().manual_seed(seed), 0.5,
                                    0.25, std=0.05, bernoulli_p=0.0,
                                    noise_type="cauchy")
        assert float(u) == 0.5 and float(v) == 0.25


def test_noise_distributions_match_jax():
    """Streams differ, so compare distributions (as
    tests/test_reference_noise_parity.py:175-282): normal mean, std and
    atom-at-mean rate (analytic 4.55%); cauchy median, IQR and atom rate
    (1 - 2/pi atan 2); the Bernoulli gate's atom rate; the recentering."""
    n = 4000
    keys = jax.random.split(jax.random.key(2), n)

    def ours(**kw):
        g = torch.Generator().manual_seed(1)
        return np.array([float(p_noise.noise_params(g, **kw)[0])
                         for _ in range(n)])

    def theirs(**kw):
        return np.asarray(jax.vmap(
            lambda k: j_noise.noise_params(k, **kw)[0])(keys), np.float64)

    kw = dict(mean_u=MEAN_U, std=NSTD, bernoulli_p=1.0, noise_type="normal")
    a, b = ours(**kw), theirs(**kw)
    for u in (a, b):
        assert abs(u.mean() - MEAN_U) < 0.005
        assert abs(np.mean(u == np.float32(MEAN_U)) - 0.0455) < 0.015
    assert abs(a.std() - b.std()) < 0.006
    kw["noise_type"] = "cauchy"
    a, b = ours(**kw), theirs(**kw)
    for u in (a, b):
        assert abs(np.median(u) - MEAN_U) < 0.005
        assert abs(np.mean(u == np.float32(MEAN_U))
                   - (1 - 2 / np.pi * np.arctan(2.0))) < 0.03
    iqr = [np.subtract(*np.percentile(u, [75, 25])) for u in (a, b)]
    assert abs(iqr[0] - iqr[1]) < 0.01
    kw.update(noise_type="normal", bernoulli_p=0.35)
    for u in (ours(**kw), theirs(**kw)):
        assert abs(np.mean(u == np.float32(MEAN_U))
                   - (0.65 + 0.35 * 0.0455)) < 0.03
    raw = p_noise.sample_noise(torch.Generator().manual_seed(3), 0.3, 0.06,
                               "normal", minimize_rk2_error=True, shape=(n,))
    assert abs(raw.mean().item() - 2 / 3) < 0.003
    assert abs(raw.std().item() - 0.04) < 0.003


def test_noise_solver_and_solver_params():
    s = create_solver("rk2", "u", n_steps=8, u0=0.5)
    noised = p_noise.noise_solver(s, torch.Generator().manual_seed(0),
                                  std=0.0125, bernoulli_p=1.0,
                                  noise_type="normal")
    assert noised.u.dtype == torch.float32 and float(noised.u) != 0.5
    assert float(s.u) == 0.5  # the base solver is untouched
    assert float(noised.reset_params().u) == 0.5
    assert float(s.with_params(u=0.7).u) == pytest.approx(0.7)
    with pytest.raises(ValueError, match="no parameter v"):
        s.with_params(v=0.3)
    euler = create_solver("euler", None, n_steps=4)
    assert p_noise.noise_solver(euler, torch.Generator()) is euler
    rk3 = create_solver("rk3", "uv", n_steps=4).with_params(u=0.2, v=0.6)
    reset = rk3.reset_params()
    assert float(reset.u) == pytest.approx(1 / 3)
    assert float(reset.v) == pytest.approx(2 / 3)
    members = p_noise.solver_ensemble_by_noising(
        s, torch.Generator().manual_seed(0), ensemble_size=3, std=0.0125,
        noise_type="normal")
    assert members[0] is s and len(members) == 3
    assert len({float(m.u) for m in members}) == 3


# ------------------------------------------------------- models and attack


def _models(acts=("GeLU",) * 3, seed=0):
    """The JAX model with its params and state, and the port's model on the
    CPU carrying the same params."""
    jmodel = make_cifar_model(j_premetanode10(in_planes=P, acts=acts))
    params, state = jmodel.init(jax.random.key(seed))
    np_params = jax.tree_util.tree_map(np.asarray, params)
    pmodel = build_model("premetanode10", device="cpu", in_planes=P,
                         acts=acts)
    pmodel.load_state_dict(cifar_params_from_jax(np_params))
    return jmodel, params, state, pmodel, np_params


def _batches(seed=5):
    rs = np.random.RandomState(seed)
    norm = lambda a: (a - np.asarray(MEAN, np.float32)) / np.asarray(
        STD, np.float32)
    batches = [(norm(rs.rand(B, 32, 32, 3).astype(np.float32)),
                rs.randint(0, 10, size=B)) for _ in range(N)]
    return batches, rs.rand(B, 32, 32, 3).astype(np.float32)


@pytest.fixture
def pinned_uniform(monkeypatch):
    """Pin the attack's uniform start in both frameworks."""
    box = {}
    uniform = jax.random.uniform

    def pinned(key, shape=(), dtype=float, minval=0.0, maxval=1.0):
        if "U" in box and tuple(shape) == box["U"].shape:
            return jnp.asarray(box["U"])
        return uniform(key, shape, dtype, minval, maxval)  # e.g. inits

    monkeypatch.setattr(jax.random, "uniform", pinned)
    monkeypatch.setattr(p_attacks, "uniform_like",
                        lambda x, generator: torch.tensor(box["U"]))
    return box


def test_fgsm_random_matches_jax(pinned_uniform):
    """x_adv within 1e-6 of JAX's with the uniform draw pinned, through the
    premetanode10 forward (RK2 u=0.5, 8 steps) in eval mode."""
    jmodel, params, state, pmodel, _ = _models()
    (x, y), U = _batches()[0][0], _batches()[1]
    pinned_uniform["U"] = U
    solvers = [j_create_solver("rk2", "u", n_steps=8, u0=0.5)]
    jfwd = lambda xi: jmodel.apply(params, state, xi, solvers,
                                   JSolverOptions(), train=False)[0]
    j_adv = np.asarray(j_fgsm_random(jfwd, jax.random.key(0), jnp.asarray(x),
                                     jnp.asarray(y), EPS, ALPHA, MEAN,
                                     STD)[0])
    psolvers = [create_solver("rk2", "u", n_steps=8, u0=0.5)]
    frozen = pmodel.detached_params()
    pfwd = lambda xi: pmodel(xi, psolvers, params=frozen)
    p_adv, _ = p_attacks.fgsm_random(pfwd, None, torch.tensor(x),
                                     torch.tensor(y), EPS, ALPHA, MEAN, STD)
    assert not p_adv.requires_grad
    np.testing.assert_allclose(p_adv.numpy(), j_adv, rtol=0, atol=1e-6)
    # the weights were not reached: no gradient was accumulated anywhere
    assert all(p.grad is None for p in pmodel.parameters())


def test_attacks_not_ported_raise_and_helpers_match():
    x = torch.rand(2, 4, 4, 3)
    # the ensemble attacks are ported (tests/test_torch_regime_eval.py)
    assert p_attacks.clean2ensemble(x, 3) == (x, 3)
    assert p_attacks.clean(x, 3) == (x, 3)
    xn = p_attacks.normalize(x, MEAN, STD)
    torch.testing.assert_close(p_attacks.inv_normalize(xn, MEAN, STD), x)
    logits = torch.randn(5, 10)
    y = torch.arange(5)
    np.testing.assert_allclose(
        p_attacks.cross_entropy(logits, y).item(),
        float(j_cross_entropy(jnp.asarray(logits.numpy()), jnp.asarray(
            y.numpy()))), rtol=1e-6)


# ---------------------------------------------------------- the train step


def _step_pair(monkeypatch, pinned, smoothing, acts, compute_dtype=None,
               n_steps=N):
    """Run the JAX and the port train step side by side from the same
    weights; returns per-step xentropies, the first step's param diff, the
    final (max, mean) param diff, the port's step-0 grads by name and the
    JAX step-0 grads."""
    jmodel, params, state, pmodel, np_params = _models(acts)
    batches, U = _batches()
    pinned["U"] = U
    tx = j_make_optimizer("sgd", j_cyclic_lr(BASE_LR, MAX_LR, SSU),
                          momentum=j_cyclic_momentum(SSU), weight_decay=5e-4)
    jts = JTrainState(step=jnp.zeros((), jnp.int32), params=params,
                      model_state=state, opt_state=tx.init(params))
    opt = make_optimizer("sgd", cyclic_lr(BASE_LR, MAX_LR, SSU),
                         momentum=cyclic_momentum(SSU), weight_decay=5e-4)
    pts = create_train_state(pmodel, opt, cifar_params_from_jax(np_params))
    jsolvers = [j_create_solver("rk2", "u", n_steps=8, u0=0.5)]
    psolvers = [create_solver("rk2", "u", n_steps=8, u0=0.5)]
    jnoise, pnoise = JNoiseConfig(), NoiseConfig()
    if smoothing:
        jnoise = JNoiseConfig(noise_type="normal", sigma=0.0125, prob=1.0)
        pnoise = NoiseConfig(noise_type="normal", sigma=0.0125, prob=1.0)
        monkeypatch.setattr(j_train_mod, "_noise_solvers", lambda base, k, c: [
            s.replace(u=jnp.asarray(U_PIN, jnp.float32)) for s in base])
        monkeypatch.setattr(p_train_mod, "_noise_solvers", lambda base, g, c: [
            s.with_params(u=U_PIN) for s in base])
    recorded = []
    sgd_update = SGD.update
    monkeypatch.setattr(SGD, "update", lambda self, p, g, s: (
        recorded.append([t.clone() for t in g]), sgd_update(self, p, g, s)))
    jstep = j_make_train_step(
        jmodel, tx, jsolvers, JSolverOptions(),
        attack_cfg=JAttackConfig(mode="fgsm_random", eps=EPS, alpha=ALPHA,
                                 mean=MEAN, std=STD),
        noise_cfg=jnoise, jit_compile=True, donate=False,
        compute_dtype=None if compute_dtype is None else jnp.bfloat16)
    pstep = make_train_step(
        pmodel, opt, psolvers, SolverOptions(),
        AttackConfig(mode="fgsm_random", eps=EPS, alpha=ALPHA, mean=MEAN,
                     std=STD), pnoise, compute_dtype=compute_dtype)

    def param_dev():
        sd = pmodel.state_dict()
        jd = cifar_params_from_jax(jax.tree_util.tree_map(
            lambda a: np.asarray(a, np.float32), jts.params))
        assert sd.keys() == jd.keys()
        d = np.concatenate([np.abs(sd[k].numpy() - jd[k].numpy()).ravel()
                            for k in sd])
        return d.max(), d.mean()

    losses, metrics, d0 = [], [], None
    reset_launch_counts()
    for i, (x, y) in enumerate(batches[:n_steps]):
        if i == 0:
            jsolvers_t = ([s.replace(u=jnp.asarray(U_PIN, jnp.float32))
                           for s in jsolvers] if smoothing else jsolvers)
            j_grads0 = _jax_grads(jmodel, jts.params, state, jsolvers_t, x,
                                  y, compute_dtype)
        jts, jm = jstep(jts, jnp.asarray(x), jnp.asarray(y),
                        jax.random.key(i))
        pts, pm = pstep(pts, torch.tensor(x), torch.tensor(y),
                        torch.Generator().manual_seed(i))
        losses.append((float(jm["xentropy"]), pm["xentropy"].item()))
        metrics.append(pm)
        if i == 0:
            d0 = param_dev()[0]
    assert launch_counts() == {}  # the CPU runs the plain versions
    assert pts.step == n_steps and pts.opt_state["count"] == n_steps
    names = list(pts.params)
    return dict(losses=losses, d0=d0, dev=param_dev(), metrics=metrics,
                p_grads0=dict(zip(names, recorded[0])), j_grads0=j_grads0,
                pts=pts)


def _jax_grads(jmodel, params, state, solvers, x, y, compute_dtype):
    """Step 0's param grads of the JAX recipe (attack, then the CE grad at
    x_adv), from the JAX package's pieces, as the port's names."""
    cast = (lambda a: a) if compute_dtype is None else (
        lambda a: a.astype(jnp.bfloat16))

    def apply(p, xi, train):
        return jmodel.apply(p, state, cast(xi), solvers, JSolverOptions(),
                            train=train)[0].astype(jnp.float32)

    @jax.jit
    def grads(p, x, y):
        x_adv = j_fgsm_random(lambda xi: apply(p, xi, False),
                              jax.random.key(0), x, y, EPS, ALPHA, MEAN,
                              STD)[0]
        return jax.grad(lambda q: j_cross_entropy(apply(q, x_adv, True),
                                                  y))(p)

    g = grads(params, jnp.asarray(x), jnp.asarray(y))
    return cifar_params_from_jax(jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32), g))


@pytest.mark.parametrize("smoothing,acts", [(False, ("GeLU",) * 3),
                                            (True, ("GeLUpoly",) * 3)])
def test_train_step_matches_jax(monkeypatch, pinned_uniform, smoothing, acts):
    """The flagship recipe (FGSM-random, SGD momentum from cyclic_momentum,
    wd 5e-4, cyclic lr) at in_planes 16, batch 4, five steps, from JAX's
    weights, with and without smoothing (u pinned to 0.55): the bounds of
    tests/test_train_step_parity.py:316-333, and step 0's grads directly
    (lr(0) = 1e-7 hides them in the params)."""
    r = _step_pair(monkeypatch, pinned_uniform, smoothing, acts)
    assert r["d0"] < 1e-6, f"first-step param diff {r['d0']}"
    for i, (lj, lt) in enumerate(r["losses"]):
        assert abs(lj - lt) < 5e-4, f"step {i}: {lj} vs {lt}"
    d_max, d_mean = r["dev"]
    assert d_max < 1e-3, f"max abs param diff after {N} steps: {d_max}"
    assert d_mean < 2e-6, f"mean abs param diff after {N} steps: {d_mean}"
    gj, gp = r["j_grads0"], r["p_grads0"]
    scale = max(1.0, max(np.abs(v.numpy()).max() for v in gj.values()))
    for k in gj:
        np.testing.assert_allclose(gp[k].numpy(), gj[k].numpy(), rtol=0,
                                   atol=1e-5 * scale, err_msg=k)
    m = r["metrics"][0]
    assert set(m) == {"loss", "xentropy", "ss_loss", "accuracy", "grad_norm"}
    assert m["ss_loss"].item() == 0.0  # off, as JAX reports it
    gnorm = np.sqrt(sum(float((v.numpy().astype(np.float64) ** 2).sum())
                        for v in gp.values()))
    assert m["grad_norm"].item() == pytest.approx(gnorm, rel=1e-5)


def test_train_step_bf16_policy(monkeypatch, pinned_uniform):
    """compute_dtype=bf16: params and optimizer state stay f32, logits and
    loss are f32, and step 0's loss is within 5e-2 of JAX's bf16 step."""
    r = _step_pair(monkeypatch, pinned_uniform, False, ("GeLUpoly",) * 3,
                   compute_dtype=torch.bfloat16, n_steps=2)
    for lj, lt in r["losses"]:
        assert abs(lj - lt) < 5e-2
    m = r["metrics"][0]
    assert m["loss"].dtype == torch.float32 and m["xentropy"].dtype == torch.float32
    pts = r["pts"]
    assert all(p.dtype == torch.float32 for p in pts.params.values())
    assert all(b.dtype == torch.float32
               for b in pts.opt_state["momentum"].values())
    assert all(g.dtype == torch.float32 for g in r["p_grads0"].values())


def test_train_step_options(monkeypatch):
    """skip_nonfinite leaves params and optimizer state unchanged on a
    non-finite batch; clean mode and data noise run; the PGD mode runs on
    the CIFAR family, and so does the CIFAR ss-loss."""
    pmodel = build_model("premetanode10", device="cpu", in_planes=8)
    opt = make_optimizer("sgd", 0.1, momentum=0.9)
    solvers = [create_solver("rk2", "u", n_steps=2, u0=0.5)]
    state = create_train_state(pmodel, opt)
    before = {k: p.detach().clone() for k, p in state.params.items()}
    step = make_train_step(pmodel, opt, solvers, skip_nonfinite=True,
                           loss_cfg=LossConfig(data_noise_std=0.01))
    x = torch.full((2, 32, 32, 3), float("nan"))
    y = torch.tensor([1, 2])
    state, m = step(state, x, y, torch.Generator().manual_seed(0))
    assert m["skipped_nonfinite"].item() == 1.0 and state.step == 1
    assert state.opt_state["count"] == 0
    for k, p in state.params.items():
        assert torch.equal(p, before[k])
    state, m = step(state, torch.rand(2, 32, 32, 3), y,
                    torch.Generator().manual_seed(1))
    assert m["skipped_nonfinite"].item() == 0.0
    assert state.opt_state["count"] == 1
    assert any(not torch.equal(p, before[k]) for k, p in state.params.items())
    state, m = make_train_step(pmodel, opt, solvers, loss_cfg=LossConfig(
        ss_loss=True))(
        state, torch.rand(2, 32, 32, 3), y, torch.Generator().manual_seed(3))
    assert torch.isfinite(m["loss"]) and m["ss_loss"].item() > 0
    assert m["loss"].item() == pytest.approx(
        m["xentropy"].item() + 0.1 * m["ss_loss"].item(), rel=1e-6)
    state, m = make_train_step(pmodel, opt, solvers, attack_cfg=AttackConfig(
        mode="at", pgd_niter=1))(
        state, torch.rand(2, 32, 32, 3), y, torch.Generator().manual_seed(2))
    assert torch.isfinite(m["loss"]) and state.opt_state["count"] == 3


def test_train_step_takes_the_generic_path_not_b2(monkeypatch):
    """With exact GeLU, B2 serves the forward but cannot carry a gradient:
    under grad the ODE blocks take meta_integrate (whose RHS convs are B1),
    and the input gradient equals the plain path's."""
    from neural_ode_metasolver_tpu_torch.models import odenet_cifar10

    calls = []
    b2 = odenet_cifar10.ode_block_rk2_forward
    monkeypatch.setattr(odenet_cifar10, "ode_block_rk2_forward",
                        lambda *a: (calls.append(1), b2(*a))[1])
    _, _, _, pmodel, _ = _models()
    solvers = [create_solver("rk2", "u", n_steps=4, u0=0.5)]
    x = torch.tensor(_batches()[0][0][0])
    with torch.no_grad():
        pmodel(x, solvers)
    assert len(calls) == 2  # both ODE blocks on B2's plain version
    grads = []
    for use_kernels in (True, False):
        xi = x.clone().requires_grad_(True)
        out = pmodel(xi, solvers, use_kernels=use_kernels,
                     params=pmodel.detached_params())
        (g,) = torch.autograd.grad(out.logsumexp(-1).sum(), xi)
        grads.append(g)
    assert len(calls) == 2  # not taken when x requires grad
    out = pmodel(x, solvers, train=True)
    assert out.requires_grad and len(calls) == 2  # nor when weights do
    torch.testing.assert_close(grads[0], grads[1], rtol=1e-5, atol=1e-7)
