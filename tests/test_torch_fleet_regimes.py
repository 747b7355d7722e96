"""The port's fleet with per-member optimizer counts, the non-finite backoff
and the switch and ensemble regimes, on the CPU: each member against its
own single run (draws included) and against JAX's fleet, the vmap of its
single step, from the same weights.

Bars: the fleet's (``tests/test_torch_fleet.py``), losses within 2e-5
relative and params within 5e-5 of max|p|.  Adam's first update is lr
sign(g) for any gradient well above its eps, so an element whose exact
gradient is 0 (at dim 8 the ones before one-channel GN groups, see
``test_fleet_matches_jax_fleet``) moves by lr either way in two
implementations: against JAX those elements, read from JAX's second moment
(|g| within 1e-6 of the largest), are left out, and the rest are held.

The regime fleets against their per-member loops run the ODE RHS under
tanh (``smooth_model``): at dim 8 the ReLU RHS makes a step under the
ss-loss ill-conditioned (a 1e-6 shift of one member's input moves its
single run's params by 1e-4 of max|p| after two steps, where tanh's move
3e-8), so the fleet's rounding would show there as a defect it is not."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neural_ode_metasolver_tpu.models.api import build_model as j_build_model
from neural_ode_metasolver_tpu.ops import SolverOptions as JSolverOptions
from neural_ode_metasolver_tpu.ops import create_solver as j_create_solver
from neural_ode_metasolver_tpu.training import cyclic_lr as j_cyclic_lr
from neural_ode_metasolver_tpu.training import make_optimizer as j_make_opt
from neural_ode_metasolver_tpu.training.fleet import (
    create_fleet_state as j_create_fleet_state,
    fleet_keys as j_fleet_keys,
    make_fleet_train_step as j_make_fleet_train_step,
)
from neural_ode_metasolver_tpu_torch.models import (build_model,
                                                    mnist_params_from_jax)
from neural_ode_metasolver_tpu_torch.ops import SolverOptions, create_solver
from neural_ode_metasolver_tpu_torch.ops.regimes import meta_integrate
from neural_ode_metasolver_tpu_torch.training import (
    AttackConfig,
    LossConfig,
    accuracy,
    adversarial_accuracy,
    create_fleet_state,
    create_train_state,
    cyclic_lr,
    fleet_generators,
    fleet_member,
    make_adversarial_predict,
    make_fleet_eval_step,
    make_fleet_train_step,
    make_optimizer,
    make_train_step,
    tile_fleet,
)
from neural_ode_metasolver_tpu_torch.training.train import (_regime_seeds,
                                                            _seeds)
from tests.test_torch_fleet import (assert_params_close, member_batches,
                                    member_model, tiny_model)
from tests.test_torch_runners import one_torch_thread  # noqa: F401

RK2 = create_solver("rk2", "u", n_steps=2, u0=0.5)
RK2_ALT = create_solver("rk2", "u", n_steps=2, u0=1.0)
EULER3 = create_solver("euler", None, n_steps=3)
SWITCH = SolverOptions(solver_mode="switch", switch_probs=[0.5, 0.5])
ENSEMBLE = SolverOptions(solver_mode="ensemble", ensemble_prob=0.5,
                         ensemble_weights=[0.6, 0.4])
COUNTS = ("count", "mini_step", "emits", "scale", "n_skipped")


def smooth_model(seed=0):
    """``tiny_model`` with tanh in the ODE RHS, smooth everywhere."""
    return build_model("mnist", device="cpu", dim=8, use_activation_type=True,
                       activation_type="tanh",
                       generator=torch.Generator().manual_seed(seed))


def _nan_batches(n_members, steps, bad=1, at=0):
    """Each member its own batch a step; member ``bad``'s at step ``at``
    carries a NaN pixel."""
    out = []
    for k in range(steps):
        x, y = member_batches(n_members)
        x = x + 0.01 * k
        if k == at:
            x[bad, 0, 0, 0, 0] = float("nan")
        out.append((x, y))
    return out


def _single_runs(opt, batches, seeds, gen_seeds, solvers=(RK2,),
                 options=SolverOptions(), **kw):
    """Each member's own single run over its slice of the batches: the
    final state and the metrics of every step."""
    out = []
    for i, s in enumerate(seeds):
        model = smooth_model(s)
        ts = create_train_state(model, opt)
        step = make_train_step(model, opt, list(solvers), options, **kw)
        g = torch.Generator().manual_seed(gen_seeds[i])
        ms = []
        for x, y in batches:
            ts, m = step(ts, x[i], y[i], g)
            ms.append(m)
        out.append((ts, ms))
    return out


def _assert_counts(fleet_opt_state, i, single_opt_state):
    for k in COUNTS:
        if k in single_opt_state:
            assert fleet_member(fleet_opt_state, i)[k] == \
                single_opt_state[k], k


def _jax_fleet(jtx, batches, seeds, **kw):
    """JAX's fleet over the batches from ``create_fleet_state(seeds)``:
    its initial params (numpy) and its final state."""
    jmodel = j_build_model("mnist", dim=8)
    jfts = j_create_fleet_state(jmodel, jtx, seeds)
    init = jax.tree_util.tree_map(np.asarray, jfts.params)
    jsolver = j_create_solver("rk2", "u", n_steps=2, u0=np.float32(0.5))
    jstep = j_make_fleet_train_step(jmodel, jtx, [jsolver], JSolverOptions(),
                                    donate=False, **kw)
    for x, y in batches:
        jfts, _ = jstep(jfts, jnp.asarray(x.numpy()),
                        jnp.asarray(y.numpy().astype(np.int32)),
                        j_fleet_keys(seeds))
    return init, jfts


def _held(jfts, kind):
    """Elements held against JAX: all, but under Adam those whose
    gradients were all at rounding level (JAX's nu within 1e-12 of the
    largest, |g| within 1e-6)."""
    want = mnist_params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                        jfts.params))
    keep = {k: torch.ones_like(v, dtype=torch.bool) for k, v in want.items()}
    if kind == "adam":
        leaves = jax.tree_util.tree_leaves_with_path(jfts.opt_state)
        nu = [v for p, v in leaves if "nu" in jax.tree_util.keystr(p)]
        tree = jax.tree_util.tree_unflatten(
            jax.tree_util.tree_structure(jfts.params), nu)
        jnu = mnist_params_from_jax(jax.tree_util.tree_map(np.asarray, tree))
        top = torch.stack([v.flatten(1).max(1).values
                           for v in jnu.values()]).max(0).values
        keep = {k: v > 1e-12 * top.view(-1, *[1] * (v.dim() - 1))
                for k, v in jnu.items()}
    return want, keep


def _assert_member_near(fts, i, want, keep=None):
    """Member i's params within 5e-5 of max|p| of ``want`` (by name, a
    single run's, or with ``keep`` a stacked JAX state's member i), on the
    elements ``keep`` holds."""
    big = max(float(v.detach().abs().max()) for v in want.values())
    for k, v in want.items():
        diff = (fts.params[k][i].detach() - v.detach()).abs()
        if keep is not None:
            diff = diff[keep[k]]
        assert diff.numel() == 0 or diff.max() <= 5e-5 * big, (
            k, float(diff.max()), big)


def _member(tree, i):
    return {k: v[i] for k, v in tree.items()}


OPTIMS = {
    "adam": (lambda: make_optimizer("adam", 1e-3),
             lambda: j_make_opt("adam", 1e-3)),
    "sgd_cyclic": (lambda: make_optimizer(
        "sgd", cyclic_lr(1e-7, 0.05, 2), momentum=0.9),
        lambda: j_make_opt("sgd", j_cyclic_lr(1e-7, 0.05, 2),
                           momentum=0.9)),
}


@pytest.mark.parametrize("kind", sorted(OPTIMS))
def test_skipped_member_keeps_its_own_counts(kind):
    """C1: member 1's batch is NaN at step 0, then two finite steps.  Its
    counts stay its own, so its lr schedule and Adam's bias correction read
    what its single run's do; member 1 against that run (skip_nonfinite)
    and against JAX's fleet from the same weights."""
    make_port, make_jax = OPTIMS[kind]
    seeds = [1, 2]
    batches = _nan_batches(2, 3)
    init, jfts = _jax_fleet(make_jax(), batches, seeds, skip_nonfinite=True)
    opt = make_port()
    model = tiny_model()
    fts = create_fleet_state(model, opt,
                             state_dict=mnist_params_from_jax(init))
    fstep = make_fleet_train_step(model, opt, [RK2], skip_nonfinite=True)
    gens = fleet_generators(seeds)
    for x, y in batches:
        fts, fm = fstep(fts, x, y, gens)
    assert fleet_member(fts.opt_state, 0)["count"] == 3
    assert fleet_member(fts.opt_state, 1)["count"] == 2
    want, keep = _held(jfts, kind)
    for i in range(2):
        _assert_member_near(fts, i, _member(want, i), _member(keep, i))
    # member 1 against its own single run from the same weights
    single = tiny_model()
    single.load_state_dict(fleet_member(mnist_params_from_jax(init), 1))
    ts = create_train_state(single, opt)
    step = make_train_step(single, opt, [RK2], skip_nonfinite=True)
    g = torch.Generator().manual_seed(seeds[1])
    for x, y in batches:
        ts, sm = step(ts, x[1], y[1], g)
    np.testing.assert_allclose(float(fm["loss"][1]), float(sm["loss"]),
                               rtol=2e-5)
    _assert_member_near(fts, 1, ts.params, _member(keep, 1))
    _assert_counts(fts.opt_state, 1, ts.opt_state)


@pytest.mark.parametrize("skip_nonfinite", [False, True])
def test_backoff_per_member(skip_nonfinite):
    """The non-finite backoff in a fleet: member 1's NaN step dips its own
    scale and counts its own skip, keeping its inner state; member 0
    recovers nothing it lost.  Against the per-member loop (counts, scale,
    n_skipped, params) and against JAX's fleet."""
    seeds = [3, 4]
    batches = _nan_batches(2, 3)
    opt = make_optimizer("adam", 1e-3, nonfinite_backoff=0.5)
    init, jfts = _jax_fleet(j_make_opt("adam", 1e-3, nonfinite_backoff=0.5),
                            batches, seeds, skip_nonfinite=skip_nonfinite)
    model = tiny_model()
    fts = create_fleet_state(model, opt,
                             state_dict=mnist_params_from_jax(init))
    fstep = make_fleet_train_step(model, opt, [RK2],
                                  skip_nonfinite=skip_nonfinite)
    gens = fleet_generators(seeds)
    for x, y in batches:
        fts, fm = fstep(fts, x, y, gens)
    assert fts.opt_state["n_skipped"] == [0, 1]
    assert fts.opt_state["scale"] == [1.0, pytest.approx(0.5 * 1.1 ** 2)]
    assert fts.opt_state["count"] == [3, 2]
    js = jfts.opt_state
    np.testing.assert_allclose(np.asarray(js.scale), fts.opt_state["scale"],
                               rtol=1e-7)
    assert np.asarray(js.n_skipped).tolist() == fts.opt_state["n_skipped"]
    want, keep = _held(jfts, "adam")
    for i in range(2):
        _assert_member_near(fts, i, _member(want, i), _member(keep, i))
    for i in range(2):
        single = tiny_model()
        single.load_state_dict(fleet_member(mnist_params_from_jax(init), i))
        ts = create_train_state(single, opt)
        step = make_train_step(single, opt, [RK2],
                               skip_nonfinite=skip_nonfinite)
        g = torch.Generator().manual_seed(seeds[i])
        for x, y in batches:
            ts, _ = step(ts, x[i], y[i], g)
        _assert_counts(fts.opt_state, i, ts.opt_state)
        _assert_member_near(fts, i, ts.params, _member(keep, i))


def test_every_k_with_a_skip_puts_members_out_of_phase():
    """every_k=2 and skip_nonfinite: member 1 skips step 0, so it emits at
    steps 2 and 4 while member 0 emits at 1 and 3; an emitting member's
    update touches neither the other's params nor its accumulator.
    Against the per-member loop, after every step."""
    seeds = [1, 2]
    batches = _nan_batches(2, 4)
    opt = make_optimizer("sgd", 0.05, momentum=0.9, every_k=2)
    fts = create_fleet_state(tiny_model(), opt, seeds)
    fstep = make_fleet_train_step(tiny_model(), opt, [RK2],
                                  skip_nonfinite=True)
    gens = fleet_generators([10, 11])
    singles = []
    for i, s in enumerate(seeds):
        model = tiny_model(s)
        singles.append([create_train_state(model, opt),
                        make_train_step(model, opt, [RK2],
                                        skip_nonfinite=True),
                        torch.Generator().manual_seed(10 + i)])
    for k, (x, y) in enumerate(batches):
        fts, fm = fstep(fts, x, y, gens)
        for i, (ts, step, g) in enumerate(singles):
            singles[i][0], sm = step(ts, x[i], y[i], g)
            _assert_counts(fts.opt_state, i, singles[i][0].opt_state)
            assert_params_close(fts.params, i, singles[i][0].params, 5e-5,
                                5e-7)
            for name, a in singles[i][0].opt_state["acc"].items():
                np.testing.assert_allclose(
                    fts.opt_state["acc"][name][i].numpy(), a.numpy(),
                    rtol=5e-5, atol=1e-7, err_msg=name)
    assert fts.opt_state["emits"] == [2, 1]
    assert fts.opt_state["mini_step"] == [0, 1]


def _draws(gen_seed, options, n):
    """The switch ids or coins of the training forward of a single step's
    generator seeded ``gen_seed`` (its fifth seed), for the test's
    choice of seeds."""
    g = torch.Generator().manual_seed(gen_seed)
    _seeds(g, 3)
    fwd = torch.Generator().manual_seed(_regime_seeds(g, options, 2)[1])
    r = float(torch.rand((), generator=fwd, dtype=torch.float64))
    if options.solver_mode == "switch":
        return int(r >= options.switch_probs[0])
    return r < options.ensemble_prob


GEN_SEEDS = [20, 21, 22, 23]

REGIME_CASES = {
    "switch-homogeneous": (SWITCH, [RK2, RK2_ALT], {}),
    "switch-heterogeneous-ss": (SWITCH, [RK2, EULER3],
                                dict(loss_cfg=LossConfig(ss_loss=True))),
    "switch-adjoint": (SWITCH, [RK2, RK2_ALT],
                       dict(integration_method="adjoint")),
    "ensemble-homogeneous-ss": (ENSEMBLE, [RK2, RK2_ALT],
                                dict(loss_cfg=LossConfig(ss_loss=True))),
    "ensemble-heterogeneous": (ENSEMBLE, [RK2, EULER3], {}),
    "ensemble-adjoint-fgsm": (ENSEMBLE, [RK2, EULER3], dict(
        integration_method="adjoint",
        attack_cfg=AttackConfig(mode="fgsm", eps=0.1))),
}


@pytest.mark.parametrize("case", sorted(REGIME_CASES))
def test_regime_fleet_matches_member_loop(case):
    """Switch and ensemble in a fleet of four: each member draws from its
    own generator as its single run does (the members' training draws
    differ), and its losses, ss-loss and params after two steps equal its
    single run's at the fleet's bars."""
    options, solvers, kw = REGIME_CASES[case]
    draws = [_draws(s, options, len(solvers)) for s in GEN_SEEDS]
    assert len(set(draws)) == 2, draws  # the members draw apart
    seeds = [1, 2, 3, 4]
    opt = make_optimizer("sgd", 0.05, momentum=0.9)
    fts = create_fleet_state(smooth_model(), opt, seeds)
    fstep = make_fleet_train_step(smooth_model(), opt, solvers, options,
                                  **kw)
    gens = fleet_generators(GEN_SEEDS)
    batches = [member_batches(4), member_batches(4)]
    fms = []
    for x, y in batches:
        fts, fm = fstep(fts, x, y, gens)
        fms.append(fm)
    for i, (ts, ms) in enumerate(_single_runs(opt, batches, seeds, GEN_SEEDS,
                                              solvers, options, **kw)):
        for fm, sm in zip(fms, ms):
            for k in ("loss", "ss_loss"):
                np.testing.assert_allclose(float(fm[k][i]), float(sm[k]),
                                           rtol=2e-5, atol=1e-7)
        _assert_member_near(fts, i, ts.params)


@pytest.mark.parametrize("pinned", ["switch", "ensemble-heads",
                                    "ensemble-tails"])
def test_regime_fleet_matches_jax_fleet(pinned):
    """Draws pinned by the options (switch_probs (0, 1); ensemble_prob 1
    or 0), so JAX's threefry and the port's generators agree: two steps
    of a fleet of two against JAX's fleet from the same weights."""
    opts = {"switch": dict(solver_mode="switch", switch_probs=(0.0, 1.0)),
            "ensemble-heads": dict(solver_mode="ensemble",
                                   ensemble_prob=1.0,
                                   ensemble_weights=(0.6, 0.4)),
            "ensemble-tails": dict(solver_mode="ensemble",
                                   ensemble_prob=0.0)}[pinned]
    seeds = [5, 6]
    us = (0.5, 1.0)
    jmodel = j_build_model("mnist", dim=8)
    jtx = j_make_opt("sgd", 0.05, momentum=0.9)
    jfts = j_create_fleet_state(jmodel, jtx, seeds)
    init = jax.tree_util.tree_map(np.asarray, jfts.params)
    jstep = j_make_fleet_train_step(
        jmodel, jtx, [j_create_solver("rk2", "u", n_steps=2,
                                      u0=np.float32(u)) for u in us],
        JSolverOptions(**opts), donate=False)
    model = tiny_model()
    opt = make_optimizer("sgd", 0.05, momentum=0.9)
    fts = create_fleet_state(model, opt,
                             state_dict=mnist_params_from_jax(init))
    fstep = make_fleet_train_step(
        model, opt, [create_solver("rk2", "u", n_steps=2, u0=u) for u in us],
        SolverOptions(**opts))
    gens = fleet_generators(seeds)
    for k in range(2):
        x, y = member_batches(2)
        x = x + 0.01 * k
        jfts, jm = jstep(jfts, jnp.asarray(x.numpy()),
                         jnp.asarray(y.numpy().astype(np.int32)),
                         j_fleet_keys(seeds))
        fts, fm = fstep(fts, x, y, gens)
        np.testing.assert_allclose(fm["loss"].numpy(), np.asarray(jm["loss"]),
                                   rtol=2e-5)
    want, _ = _held(jfts, "sgd")
    for i in range(2):
        _assert_member_near(fts, i, _member(want, i))


def test_fleet_eval_counts_under_switch_match_harnesses():
    """Clean and FGSM counts of a switch fleet: member m draws its regime
    seed (after its attack seed) from its own generator as ``accuracy``
    and ``adversarial_accuracy`` draw a batch's, so the counts equal those
    harnesses' on each member.  A switch eval without generators
    raises."""
    opt = make_optimizer("sgd", 0.05)
    fts = create_fleet_state(tiny_model(), opt, [1, 2, 3])
    solvers = [RK2, EULER3]
    x, y = member_batches(1, bs=16)
    batches = [(x[0].numpy(), y[0].numpy())]
    xs, ys = tile_fleet(x[0], 3), tile_fleet(y[0], 3)
    adv = AttackConfig(mode="fgsm", eps=0.15)
    clean = make_fleet_eval_step(tiny_model(), solvers, SWITCH)
    attacked = make_fleet_eval_step(tiny_model(), solvers, SWITCH,
                                    attack_cfg=adv)
    with pytest.raises(ValueError, match="generator per member"):
        clean(fts.params, fts.model_state, xs, ys)
    counts_c = clean(fts.params, fts.model_state, xs, ys,
                     fleet_generators([7, 8, 9]))
    counts_a = attacked(fts.params, fts.model_state, xs, ys,
                        fleet_generators([7, 8, 9]))
    for i in range(3):
        m = member_model(tiny_model, fts, i)
        g = torch.Generator().manual_seed(7 + i)
        assert float(counts_c[i]) / 16 == accuracy(m, solvers, SWITCH,
                                                   batches, generator=g)
        acc_a = adversarial_accuracy(
            m, solvers, SWITCH, batches, adv,
            torch.Generator().manual_seed(7 + i),
            predict=make_adversarial_predict(m, solvers, SWITCH, adv))
        assert float(counts_a[i]) / 16 == acc_a


def _counting_rhs(calls):
    """tanh(y) (1 + t), t one a member on a stacked tableau; each call
    appends to ``calls``."""
    def rhs(t, y):
        calls.append(1)
        t = torch.as_tensor(t)
        return torch.tanh(y) * (1.0 + t.reshape(
            t.shape + (1,) * (y.dim() - t.dim())))
    return rhs


def test_meta_integrate_member_axis():
    """meta_integrate with a member axis: each member's output equals its
    single call's with the same draw; a switch over one grid is one solve
    (on the stacked tableau, padded to the largest stage count), over two
    grids a solve each; an ensemble
    whose coins all fell tails solves once; an unchosen branch's NaN
    reaches neither the output nor the gradient."""
    y0 = torch.randn(4, 3, 5, generator=torch.Generator().manual_seed(0))
    ids = [0, 1, 1, 0]
    rk4 = create_solver("rk4", "u2", n_steps=2, u0=1 / 3)
    # RHS calls: two RK2 steps 4; with RK4 on the same grid one solve on
    # RK2's tableau padded to four stages, 8; euler on another grid, a
    # solve each, 4 + 3
    for solvers, want_calls in (([RK2, RK2_ALT], 4), ([RK2, rk4], 8),
                                ([RK2, EULER3], 4 + 3)):
        calls = []
        out, aux = meta_integrate(solvers, _counting_rhs(calls), y0, SWITCH,
                                  aux_in={"switch_solver_id": ids})
        assert len(calls) == want_calls and aux["switch_solver_id"] == ids
        for m, j in enumerate(ids):
            want, _ = meta_integrate(solvers, _counting_rhs([]), y0[m],
                                     SWITCH,
                                     aux_in={"switch_solver_id": j})
            torch.testing.assert_close(out[m], want, rtol=1e-6, atol=1e-7)
    # the draws: member m draws from its own generator as its single call
    gens = fleet_generators([0, 1, 2, 3])
    _, aux = meta_integrate([RK2, RK2_ALT], _counting_rhs([]), y0, SWITCH,
                            gens)
    assert aux["switch_solver_id"] == [
        meta_integrate([RK2, RK2_ALT], _counting_rhs([]), y0[m], SWITCH,
                       torch.Generator().manual_seed(m))[1][
                           "switch_solver_id"] for m in range(4)]
    calls = []
    meta_integrate([RK2, EULER3], _counting_rhs(calls), y0, ENSEMBLE,
                   aux_in={"ensemble_coin_flip": [False] * 4})
    assert len(calls) == 4
    # a NaN in the unchosen branch (EULER3's last step, for members 0 and
    # 3): selection keeps it out of their outputs and passes the branch a
    # zero gradient
    y = y0.clone().requires_grad_(True)

    def nan_rhs(t, yy):
        last = abs(float(t) - 2 / 3) < 1e-6
        return torch.log(-yy.abs() - 1) if last else torch.tanh(yy)

    out, _ = meta_integrate([RK2, EULER3], nan_rhs, y, SWITCH,
                            aux_in={"switch_solver_id": ids})
    assert torch.isfinite(out[[0, 3]]).all()
    (grad,) = torch.autograd.grad(out[[0, 3]].sum(), y)
    assert torch.isfinite(grad).all()
    assert (grad[[1, 2]] == 0).all()
