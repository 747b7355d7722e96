"""The port's fleet (``training/fleet.py``) on the CPU: the cases of
``tests/test_fleet.py`` but the mesh (``tests/test_torch_parallel_fleet.py``
holds that one), at JAX's bars, plus the
fleet against JAX's fleet from the same params, and a CIFAR fleet with BN
and GN against its per-member loop (per-member BN statistics and the
stacked model state)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neural_ode_metasolver_tpu.models.api import build_model as j_build_model
from neural_ode_metasolver_tpu.ops import SolverOptions as JSolverOptions
from neural_ode_metasolver_tpu.ops import create_solver as j_create_solver
from neural_ode_metasolver_tpu.training import make_optimizer as j_make_opt
from neural_ode_metasolver_tpu.training.fleet import (
    create_fleet_state as j_create_fleet_state,
    fleet_keys as j_fleet_keys,
    make_fleet_eval_step as j_make_fleet_eval_step,
    make_fleet_train_step as j_make_fleet_train_step,
    stack_fleet_solvers as j_stack_fleet_solvers,
)
from neural_ode_metasolver_tpu_torch.data import (batch_iterator,
                                                  synthetic_dataset)
from neural_ode_metasolver_tpu_torch.models import (build_model,
                                                    mnist_params_from_jax,
                                                    rmsprop_state_from_jax,
                                                    stack_members)
from neural_ode_metasolver_tpu_torch.ops import SolverOptions, create_solver
from neural_ode_metasolver_tpu_torch.training import (
    AttackConfig,
    LossConfig,
    NoiseConfig,
    accuracy,
    adversarial_accuracy,
    create_fleet_state,
    create_train_state,
    fleet_generators,
    fleet_member,
    make_adversarial_predict,
    make_fleet_eval_step,
    make_fleet_train_step,
    make_optimizer,
    make_train_step,
    stack_fleet_solvers,
    tile_fleet,
)
from tests.test_torch_runners import one_torch_thread  # noqa: F401

SOLVERS = [create_solver("rk2", "u", n_steps=2, u0=0.5)]
OPTS = SolverOptions()


def tiny_model(seed=0):
    return build_model("mnist", device="cpu", dim=8,
                       generator=torch.Generator().manual_seed(seed))


def member_batches(n_members, bs=8, shape=(28, 28, 1)):
    """Each member its own batch, stacked (S, B, ...)."""
    xs, ys = [], []
    for i in range(n_members):
        ds = synthetic_dataset(bs, shape, seed=100 + i)
        x, y = next(iter(batch_iterator(ds, bs, seed=i)))
        xs.append(torch.from_numpy(x))
        ys.append(torch.from_numpy(y).long())
    return torch.stack(xs), torch.stack(ys)


def assert_params_close(fleet_params, i, params, rtol, atol):
    for k, v in params.items():
        np.testing.assert_allclose(fleet_params[k][i].detach().double(),
                                   v.detach().double(), rtol=rtol,
                                   atol=atol, err_msg=k)


def member_model(model_fn, fts, i):
    """A model carrying member i's params and state, for the single-run
    harnesses."""
    m = model_fn()
    m.load_state_dict({**fleet_member(fts.params, i),
                       **fleet_member(fts.model_state, i)})
    return m


def test_fleet_generators_match_single_run_roots():
    gens = fleet_generators([3, 7, 42])
    for g, s in zip(gens, [3, 7, 42]):
        want = torch.Generator().manual_seed(s)
        assert torch.equal(torch.randint(0, 2 ** 62, (4,), generator=g),
                           torch.randint(0, 2 ** 62, (4,), generator=want))


def test_create_fleet_state_members_match_single():
    model = tiny_model()
    opt = make_optimizer("sgd", 0.05, momentum=0.9)
    fts = create_fleet_state(model, opt, [1, 2])
    assert set(fts.opt_state["momentum"]) == set(fts.params)
    for i, s in enumerate([1, 2]):
        single = create_train_state(tiny_model(s), opt)
        assert_params_close(fts.params, i, single.params, 0, 0)
    # the same members from their state dicts, stacked
    again = create_fleet_state(model, opt, state_dict=stack_members(
        [tiny_model(s).state_dict() for s in (1, 2)]))
    assert set(again.params) == set(fts.params)
    for k, v in fts.params.items():
        assert torch.equal(again.params[k], v)


def test_fleet_step_matches_per_member_loop():
    """The flagship recipe (fgsm_random and smoothing noise) as a fleet of
    3 reproduces each member's single-run steps for 2 steps."""
    model = tiny_model()
    opt = make_optimizer("sgd", 0.05, momentum=0.9, weight_decay=5e-4)
    attack = AttackConfig(mode="fgsm_random", eps=8 / 255, alpha=10 / 255)
    noise = NoiseConfig(noise_type="normal", sigma=0.0125, prob=1.0)
    fstep = make_fleet_train_step(model, opt, SOLVERS, OPTS, attack, noise,
                                  donate=False)
    seeds = [1, 2, 3]
    fts = create_fleet_state(model, opt, seeds)
    x, y = member_batches(len(seeds))
    gens = fleet_generators([10 + s for s in seeds])
    f1, m1 = fstep(fts, x, y, gens)
    loss1 = m1["loss"].clone()
    f2, m2 = fstep(f1, x, y, gens)
    assert m2["grad_norm"].shape == (3,)
    for i, s in enumerate(seeds):
        single = tiny_model(s)
        ts = create_train_state(single, opt)
        sstep = make_train_step(single, opt, SOLVERS, OPTS, attack, noise)
        g = torch.Generator().manual_seed(10 + s)
        ts, sm1 = sstep(ts, x[i], y[i], g)
        ts, sm2 = sstep(ts, x[i], y[i], g)
        np.testing.assert_allclose(float(loss1[i]), float(sm1["loss"]),
                                   rtol=2e-5)
        np.testing.assert_allclose(float(m2["loss"][i]), float(sm2["loss"]),
                                   rtol=2e-5)
        assert_params_close(f2.params, i, ts.params, 5e-5, 5e-7)


def test_fleet_dynamic_solvers_usweep_one_step():
    """Per-member coefficients: a u-sweep trains as one fleet step and
    matches each u's single run."""
    model = tiny_model()
    opt = make_optimizer("rmsprop", 1e-3)
    us = [0.3, 0.5, 0.9]
    member_solvers = [[create_solver("rk2", "u", n_steps=2, u0=u)]
                      for u in us]
    stacked = stack_fleet_solvers(member_solvers)
    assert stacked[0].u.shape == (3,)
    fstep = make_fleet_train_step(model, opt, SOLVERS, OPTS)
    fts = create_fleet_state(model, opt, [5, 5, 5])
    x0, y0 = member_batches(1)
    x, y = tile_fleet(x0[0], 3), tile_fleet(y0[0], 3)
    _, fm = fstep(fts, x, y, fleet_generators([77] * 3), stacked)
    losses = fm["loss"].numpy()
    assert len(set(np.round(losses, 10))) == 3  # u changes the step
    for i, ms in enumerate(member_solvers):
        single = tiny_model(5)
        sstep = make_train_step(single, opt, SOLVERS, OPTS)
        _, sm = sstep(create_train_state(single, opt), x0[0], y0[0],
                      torch.Generator().manual_seed(77), ms)
        np.testing.assert_allclose(losses[i], float(sm["loss"]), rtol=2e-5)


def test_fleet_eval_counts_match_harnesses():
    """Clean and FGSM fleet counts reproduce the single-run accuracy and
    adversarial_accuracy harnesses member for member."""
    model = tiny_model()
    opt = make_optimizer("sgd", 0.05)
    seeds = [1, 2]
    fts = create_fleet_state(model, opt, seeds)
    ds = synthetic_dataset(24, (28, 28, 1), seed=9)
    batches = list(batch_iterator(ds, 8, seed=0, shuffle=False))
    total = sum(len(b[1]) for b in batches)
    clean_step = make_fleet_eval_step(model, SOLVERS, OPTS)
    adv_cfg = AttackConfig(mode="fgsm", eps=0.15)
    adv_step = make_fleet_eval_step(model, SOLVERS, OPTS, attack_cfg=adv_cfg)
    counts_c = torch.zeros(2, dtype=torch.long)
    counts_a = torch.zeros(2, dtype=torch.long)
    gens = fleet_generators([0, 0])
    for x, y in batches:
        xs, ys = tile_fleet(x, 2), tile_fleet(torch.from_numpy(y).long(), 2)
        counts_c += clean_step(fts.params, fts.model_state, xs, ys)
        counts_a += adv_step(fts.params, fts.model_state, xs, ys, gens)
    for i in range(2):
        m = member_model(tiny_model, fts, i)
        assert float(counts_c[i]) / total == accuracy(m, SOLVERS, OPTS,
                                                      batches)
        acc_a = adversarial_accuracy(
            m, SOLVERS, OPTS, batches, adv_cfg,
            torch.Generator().manual_seed(0),
            predict=make_adversarial_predict(m, SOLVERS, OPTS, adv_cfg))
        assert abs(float(counts_a[i]) / total - acc_a) <= 1.0 / total


def test_tile_and_member_roundtrip():
    x = torch.arange(12.0).reshape(3, 4)
    t = tile_fleet(x, 5)
    assert t.shape == (5, 3, 4) and t.is_contiguous()
    assert torch.equal(fleet_member(t, 2), x)


def test_fleet_eval_dynamic_solvers_per_member():
    """A u-sweep fleet is evaluated under each member's own coefficients."""
    model = tiny_model()
    opt = make_optimizer("sgd", 0.05)
    u_grid = [0.35, 0.5, 1.0]
    fts = create_fleet_state(model, opt, [7] * 3)
    member_solvers = [[create_solver("rk2", "u", n_steps=2, u0=u)]
                      for u in u_grid]
    dyn = stack_fleet_solvers(member_solvers)
    ds = synthetic_dataset(16, (28, 28, 1), seed=5)
    batches = list(batch_iterator(ds, 16, seed=0, shuffle=False))
    x, y = batches[0]
    xs, ys = tile_fleet(x, 3), tile_fleet(torch.from_numpy(y).long(), 3)
    step = make_fleet_eval_step(model, member_solvers[0], OPTS)
    counts = step(fts.params, fts.model_state, xs, ys, None, dyn)
    assert counts.shape == (3,)
    for i in range(3):
        m = member_model(tiny_model, fts, i)
        assert float(counts[i]) / len(y) == accuracy(m, member_solvers[i],
                                                     OPTS, batches)
    shared = step(fts.params, fts.model_state, xs, ys)
    m = member_model(tiny_model, fts, 2)
    assert float(shared[2]) / len(y) == accuracy(m, member_solvers[0], OPTS,
                                                 batches)


@pytest.mark.parametrize("optim", ["rmsprop", "sgd"])
def test_fleet_matches_jax_fleet(optim):
    """The port's fleet against JAX's from the same params: 3 members, u
    0.3 / 0.5 / 0.9, clean training (no draw to pin), one step: the losses
    within 1e-5, the params within 1e-4 of max|p| and the clean eval
    counts equal.  RMSprop (the u-sweep's optimizer) divides each gradient
    element by its own magnitude, so its first update is about 10 lr
    sign(g): an element whose gradient is at rounding level moves by about
    10 lr either way in any two implementations.  At dim 8 these are the
    elements whose exact gradient is 0, since a one-channel GN group
    follows them: the conv biases, the ConcatConvs' t-channel weights and
    the RHS's last GN bias (64 a member).  So the
    RMSprop case also holds each member's gradient, read from ``nu`` =
    0.01 g^2, within 1e-4 of its max|g| against JAX's, and leaves out of
    the params only the elements with |g_ref| <= 1e-6 max|g_ref|."""
    us = [np.float32(u) for u in (0.3, 0.5, 0.9)]
    lr = 1e-3
    jmodel = j_build_model("mnist", dim=8)
    jtx = j_make_opt(optim, lr)
    jfts = j_create_fleet_state(jmodel, jtx, [1, 2, 3])
    jsolver = j_create_solver("rk2", "u", n_steps=2, u0=0.5)
    jdyn = j_stack_fleet_solvers([[jsolver.replace(u=jnp.float32(u))]
                                  for u in us])
    jstep = j_make_fleet_train_step(jmodel, jtx, [jsolver], JSolverOptions(),
                                    donate=False)
    x, y = member_batches(3)
    jx, jy = jnp.asarray(x.numpy()), jnp.asarray(y.numpy().astype(np.int32))
    jfts2, jm = jstep(jfts, jx, jy, j_fleet_keys([1, 2, 3]), jdyn)

    model = tiny_model()
    opt = make_optimizer(optim, lr)
    np_params = jax.tree_util.tree_map(np.asarray, jfts.params)
    fts = create_fleet_state(model, opt,
                             state_dict=mnist_params_from_jax(np_params))
    dyn = stack_fleet_solvers([[SOLVERS[0].replace(u=torch.tensor(u))]
                               for u in us])
    step = make_fleet_train_step(model, opt, SOLVERS, OPTS)
    fts2, m = step(fts, x, y, fleet_generators([1, 2, 3]), dyn)
    np.testing.assert_allclose(m["loss"].numpy(), np.asarray(jm["loss"]),
                               rtol=0, atol=1e-5)
    want = mnist_params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                        jfts2.params))
    big = max(v.abs().max() for v in want.values())
    keep = {k: torch.ones_like(v, dtype=torch.bool) for k, v in want.items()}
    if optim == "rmsprop":
        jnu = rmsprop_state_from_jax(
            jax.tree_util.tree_map(np.asarray, jfts2.opt_state), 1)["nu"]
        g_ref = {k: (v / 0.01).sqrt() for k, v in jnu.items()}
        g_max = torch.stack([v.flatten(1).max(1).values
                             for v in g_ref.values()]).max(0).values
        left_out, where = 0, set()
        for k, v in g_ref.items():
            scale = g_max.view(-1, *[1] * (v.dim() - 1))
            g = (fts2.opt_state["nu"][k] / 0.01).sqrt()
            assert ((g - v).abs() <= 1e-4 * scale).all(), k
            keep[k] = v > 1e-6 * scale
            left_out += int((~keep[k]).sum())
            where |= {k} if not keep[k].all() else set()
        print(f"rmsprop: {left_out} of "
              f"{sum(v.numel() for v in want.values())} params left out, "
              f"in {sorted(where)}")
    for k, v in want.items():
        diff = (fts2.params[k].detach() - v).abs()[keep[k]]
        assert diff.numel() == 0 or diff.max() <= 1e-4 * big, k
    jcounts = j_make_fleet_eval_step(jmodel, [jsolver], JSolverOptions())(
        jfts2.params, jfts2.model_state, jx, jy, j_fleet_keys([1, 2, 3]),
        jdyn)
    counts = make_fleet_eval_step(model, SOLVERS, OPTS)(
        fts2.params, fts2.model_state, x, y, None, dyn)
    assert counts.tolist() == np.asarray(jcounts).tolist()


def test_cifar_fleet_with_bn_and_gn_matches_member_loop():
    """metanode4 with BN in the res slots and GN in the ODE RHS: the fleet
    against each member's own steps, two steps, the per-member BN running
    statistics included."""
    def cifar(seed=0):
        return build_model("metanode4", device="cpu", in_planes=8,
                           norms=("BN", "GN", "BN"), num_gn_groups=4,
                           generator=torch.Generator().manual_seed(seed))

    model = cifar()
    opt = make_optimizer("sgd", 0.05, momentum=0.9, weight_decay=5e-4)
    seeds = [4, 5]
    fts = create_fleet_state(model, opt, seeds)
    assert fts.model_state and all(v.shape[0] == 2
                                   for v in fts.model_state.values())
    x, y = member_batches(2, bs=4, shape=(32, 32, 3))
    fstep = make_fleet_train_step(model, opt, SOLVERS, OPTS)
    gens = fleet_generators([20, 21])
    for _ in range(2):
        fts, fm = fstep(fts, x, y, gens)
    for i, s in enumerate(seeds):
        single = cifar(s)
        ts = create_train_state(single, opt)
        sstep = make_train_step(single, opt, SOLVERS, OPTS)
        g = torch.Generator().manual_seed(20 + i)
        for _ in range(2):
            ts, sm = sstep(ts, x[i], y[i], g)
        np.testing.assert_allclose(float(fm["loss"][i]), float(sm["loss"]),
                                   rtol=2e-5)
        assert_params_close(fts.params, i, ts.params, 5e-5, 5e-6)
        for k, v in single.named_buffers():
            np.testing.assert_allclose(fts.model_state[k][i].double(),
                                       v.double(), rtol=1e-5, atol=1e-6,
                                       err_msg=k)


def test_cifar_fleet_no_grad_forward_runs_b2_per_member():
    """premetanode4's ODE block goes to B2 where no gradient flows; a
    fleet's no-grad forward runs it once per member, each member with its
    own u, and gives each member its single run's logits."""
    model = build_model("premetanode4", device="cpu", in_planes=8)
    opt = make_optimizer("sgd", 0.05)
    us = [0.3, 0.9]
    fts = create_fleet_state(model, opt, [1, 2])
    dyn = stack_fleet_solvers([[create_solver("rk2", "u", n_steps=2,
                                              u0=u)] for u in us])
    x = member_batches(2, bs=3, shape=(32, 32, 3))[0]
    with torch.no_grad():
        got = model(x, dyn, OPTS, params=model.param_tree(fts.params),
                    model_state=model.state_tree(fts.model_state))
    for i, u in enumerate(us):
        single = build_model("premetanode4", device="cpu", in_planes=8,
                             generator=torch.Generator().manual_seed(i + 1))
        with torch.no_grad():
            want = single(x[i], [create_solver("rk2", "u", n_steps=2,
                                               u0=u)], OPTS)
        torch.testing.assert_close(got[i], want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("opt_kw", [dict(grad_clip=0.05), dict(every_k=2)])
def test_fleet_clipping_and_every_k_are_per_member(opt_kw):
    """Global-norm clipping (each member by its own norm) and every_k
    accumulation: the fleet against its per-member loop, two steps."""
    model = tiny_model()
    opt = make_optimizer("sgd", 0.05, momentum=0.9, **opt_kw)
    seeds = [1, 2]
    fts = create_fleet_state(model, opt, seeds)
    x, y = member_batches(2)
    fstep = make_fleet_train_step(model, opt, SOLVERS, OPTS)
    gens = fleet_generators([30, 31])
    for _ in range(2):
        fts, fm = fstep(fts, x, y, gens)
    for i, s in enumerate(seeds):
        single = tiny_model(s)
        ts = create_train_state(single, opt)
        sstep = make_train_step(single, opt, SOLVERS, OPTS)
        g = torch.Generator().manual_seed(30 + i)
        for _ in range(2):
            ts, sm = sstep(ts, x[i], y[i], g)
        np.testing.assert_allclose(float(fm["grad_norm"][i]),
                                   float(sm["grad_norm"]), rtol=1e-5)
        assert_params_close(fts.params, i, ts.params, 5e-5, 5e-7)


def test_fleet_skip_nonfinite_keeps_only_the_bad_member():
    """A non-finite member keeps its params and optimizer buffers; the
    others step as their single runs do."""
    model = tiny_model()
    opt = make_optimizer("sgd", 0.05, momentum=0.9)
    fts = create_fleet_state(model, opt, [1, 2])
    before = {k: v.detach().clone() for k, v in fts.params.items()}
    x, y = member_batches(2)
    x[1, 0, 0, 0, 0] = float("nan")
    fstep = make_fleet_train_step(model, opt, SOLVERS, OPTS,
                                  skip_nonfinite=True)
    fts, m = fstep(fts, x, y, fleet_generators([5, 6]))
    assert m["skipped_nonfinite"].tolist() == [0.0, 1.0]
    for k, v in before.items():
        assert torch.equal(fts.params[k][1], v[1])
        assert torch.equal(fts.opt_state["momentum"][k][1],
                           torch.zeros_like(v[1]))
    single = tiny_model(1)
    ts = create_train_state(single, opt)
    ts, _ = make_train_step(single, opt, SOLVERS, OPTS)(
        ts, x[0], y[0], torch.Generator().manual_seed(5))
    assert_params_close(fts.params, 0, ts.params, 5e-5, 5e-7)


def test_fleet_ss_loss_and_data_noise_match_member_loop():
    """The ss-loss (each member's own mean) and Gaussian data noise (drawn
    from each member's seed) in a fleet step against its per-member
    loop."""
    model = tiny_model()
    opt = make_optimizer("sgd", 0.05, momentum=0.9)
    loss_cfg = LossConfig(ss_loss=True, ss_loss_reg=0.1, data_noise_std=0.05)
    fts = create_fleet_state(model, opt, [1, 2])
    x, y = member_batches(2)
    fts, fm = make_fleet_train_step(model, opt, SOLVERS, OPTS,
                                    loss_cfg=loss_cfg)(
        fts, x, y, fleet_generators([8, 9]))
    assert fm["ss_loss"].shape == (2,) and (fm["ss_loss"] > 0).all()
    for i, s in enumerate([1, 2]):
        single = tiny_model(s)
        ts = create_train_state(single, opt)
        ts, sm = make_train_step(single, opt, SOLVERS, OPTS,
                                 loss_cfg=loss_cfg)(
            ts, x[i], y[i], torch.Generator().manual_seed(8 + i))
        np.testing.assert_allclose(float(fm["ss_loss"][i]),
                                   float(sm["ss_loss"]), rtol=2e-5)
        np.testing.assert_allclose(float(fm["loss"][i]), float(sm["loss"]),
                                   rtol=2e-5)
        assert_params_close(fts.params, i, ts.params, 5e-5, 5e-7)


def test_fleet_under_the_adjoint_matches_member_loop():
    """integration_method="adjoint": the stacked coefficients scale every
    leaf of the augmented state (y, a and the params' gradients) along the
    member axis; each member against its single run."""
    model = tiny_model()
    opt = make_optimizer("sgd", 0.05, momentum=0.9)
    us = [0.3, 0.9]
    member_solvers = [[create_solver("rk2", "u", n_steps=2, u0=u)]
                      for u in us]
    fts = create_fleet_state(model, opt, [1, 2])
    x, y = member_batches(2)
    fts, fm = make_fleet_train_step(
        model, opt, SOLVERS, OPTS, integration_method="adjoint")(
        fts, x, y, fleet_generators([3, 4]),
        stack_fleet_solvers(member_solvers))
    for i, s in enumerate([1, 2]):
        single = tiny_model(s)
        ts = create_train_state(single, opt)
        ts, sm = make_train_step(single, opt, SOLVERS, OPTS,
                                 integration_method="adjoint")(
            ts, x[i], y[i], torch.Generator().manual_seed(3 + i),
            member_solvers[i])
        np.testing.assert_allclose(float(fm["loss"][i]), float(sm["loss"]),
                                   rtol=2e-5)
        assert_params_close(fts.params, i, ts.params, 5e-5, 5e-7)
