"""The regime evaluation of the PyTorch port against the JAX package, on
the CPU: the Evaluate-notebook regime grid, the ensemble attack, clean and
FGSM accuracy per regime, model ensembling, ``sn_test``, and a train step
under switch.

The MNIST MetaNODE at dim 16 (RK2 in 2 steps), 64 seeded images whose
labels are JAX's own standalone predictions, so a count is near 64 and any
prediction apart shows.  Draws are pinned where the streams differ: the
noised members to JAX's u, switch and ensemble through degenerate
probabilities (the grid's solver_ens row, ensemble_prob 1, is one).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neural_ode_metasolver_tpu.attacks import fgsm2ensemble as j_fgsm2ensemble
from neural_ode_metasolver_tpu.models.api import build_model as j_build_model
from neural_ode_metasolver_tpu.ops import SolverOptions as JSolverOptions
from neural_ode_metasolver_tpu.ops import create_solver as j_create_solver
from neural_ode_metasolver_tpu.training import (
    AttackConfig as JAttackConfig,
    LossConfig as JLossConfig,
    TrainState as JTrainState,
    accuracy as j_accuracy,
    accuracy_ensemble as j_accuracy_ensemble,
    adversarial_accuracy as j_adversarial_accuracy,
    adversarial_accuracy_ensemble as j_adversarial_accuracy_ensemble,
    make_optimizer as j_make_optimizer,
    make_train_step as j_make_train_step,
    notebook_regime_grid as j_notebook_regime_grid,
    sn_test as j_sn_test,
)
from neural_ode_metasolver_tpu_torch.attacks import attacks as p_attacks
from neural_ode_metasolver_tpu_torch.models import (
    build_model,
    mnist_params_from_jax,
)
from neural_ode_metasolver_tpu_torch.ops import SolverOptions, create_solver
from neural_ode_metasolver_tpu_torch.training import (
    AttackConfig,
    LossConfig,
    RegimeSpec,
    accuracy,
    accuracy_ensemble,
    adversarial_accuracy,
    adversarial_accuracy_ensemble,
    create_train_state,
    make_ensemble_attacked_probs,
    make_ensemble_probs,
    make_optimizer,
    make_train_step,
    notebook_regime_grid,
    sn_test,
)

DIM, N_RK, EPS = 16, 2, 0.3


@pytest.fixture(scope="module")
def setup():
    """The JAX model, params and state, the port's model with the same
    params, the base solvers, and two batches of 32 images labelled by
    JAX's standalone predictions."""
    jmodel = j_build_model("mnist", dim=DIM)
    params, state = jmodel.init(jax.random.key(0))
    pmodel = build_model("mnist", device="cpu", dim=DIM)
    pmodel.load_state_dict(mnist_params_from_jax(
        jax.tree_util.tree_map(np.asarray, params)))
    js = j_create_solver("rk2", "u", n_steps=N_RK, u0=np.float32(0.5))
    ps = create_solver("rk2", "u", n_steps=N_RK, u0=0.5)
    x = np.random.RandomState(7).rand(64, 28, 28, 1).astype(np.float32)
    logits = jax.jit(lambda xi: jmodel.apply(
        params, state, xi, [js], JSolverOptions(), train=False)[0])(
        jnp.asarray(x))
    y = np.asarray(jnp.argmax(logits, -1)).astype(np.int64)
    batches = [(x[:32], y[:32]), (x[32:], y[32:])]
    return dict(jmodel=jmodel, params=params, state=state, pmodel=pmodel,
                js=js, ps=ps, data=lambda: iter(batches))


def _grids(s):
    """JAX's grid and the port's, the port's noised members pinned to
    JAX's drawn u."""
    jgrid = j_notebook_regime_grid(s["js"], jax.random.key(15))
    pgrid = notebook_regime_grid(s["ps"], torch.Generator().manual_seed(15))
    pinned = [m.with_params(u=float(jm.u)) for m, jm in
              zip(pgrid[3].solvers, jgrid[3].solvers)]
    return jgrid, pgrid[:3] + [pgrid[3]._replace(solvers=pinned)]


def test_notebook_regime_grid_matches_jax(setup):
    """The same four rows: names, options, needs_key and model-ensemble
    flags, solvers' u and grids; the noised member is the original first,
    then a copy noised around u0 = 0.5."""
    jgrid = j_notebook_regime_grid(setup["js"], jax.random.key(15))
    pgrid = notebook_regime_grid(setup["ps"],
                                 torch.Generator().manual_seed(15))
    assert [r.name for r in pgrid] == [r.name for r in jgrid] == [
        "standalone", "switch[0.6,0.4]", "solver_ens[0.6,0.4]",
        "model_ensembling"]
    for pr, jr in zip(pgrid, jgrid):
        assert isinstance(pr, RegimeSpec)
        assert (pr.needs_key, pr.is_model_ensemble) == (jr.needs_key,
                                                        jr.is_model_ensemble)
        po, jo = pr.options, jr.options
        assert (po.solver_mode, po.ensemble_prob) == (jo.solver_mode,
                                                      jo.ensemble_prob)
        for a, b in ((po.switch_probs, jo.switch_probs),
                     (po.ensemble_weights, jo.ensemble_weights)):
            assert (a is None and b is None) or list(a) == list(b)
        assert len(pr.solvers) == len(jr.solvers)
        for ps, js in zip(pr.solvers, jr.solvers):
            assert (ps.method, ps.n_steps, ps.u0) == (js.method, js.n_steps,
                                                      float(js.u0))
            if not pr.is_model_ensemble:
                assert float(ps.u) == pytest.approx(float(js.u))
    noised = pgrid[3].solvers
    assert noised[0] is setup["ps"] and float(noised[1].u) != 0.5
    assert abs(float(noised[1].u) - 0.5) <= 0.4  # the rejection at 2 std
    assert float(pgrid[1].solvers[1].u) == 1.0
    assert pgrid[1].solvers[1].u.dtype == torch.float32


def _jax_fwds(s, solvers):
    return [lambda xi, sv=sv: s["jmodel"].apply(
        s["params"], s["state"], xi, [sv], JSolverOptions(), train=False)[0]
        for sv in solvers]


def test_fgsm2ensemble_matches_jax(setup):
    """The joint FGSM through the two model-ensembling members at eps 0.3:
    x_adv within 1e-6 of JAX's wherever the input gradient is above 1e-6
    of its largest; detached, the weights untouched."""
    s = setup
    jgrid, pgrid = _grids(s)
    x, y = next(s["data"]())
    j_adv = np.asarray(jax.jit(lambda xi, yi: j_fgsm2ensemble(
        _jax_fwds(s, jgrid[3].solvers), xi, yi, EPS)[0])(
        jnp.asarray(x), jnp.asarray(y)))
    frozen = s["pmodel"].detached_params()
    pfwds = [lambda xi, sv=sv: s["pmodel"](xi, [sv], params=frozen)
             for sv in pgrid[3].solvers]
    xt, yt = torch.tensor(x), torch.tensor(y)
    p_adv, _ = p_attacks.fgsm2ensemble(pfwds, xt, yt, EPS)
    assert not p_adv.requires_grad
    assert all(p.grad is None for p in s["pmodel"].parameters())
    xg = xt.clone().requires_grad_(True)
    probs = sum(torch.softmax(f(xg), -1) for f in pfwds) / 2
    (g,) = torch.autograd.grad(
        -torch.log(probs).gather(-1, yt[:, None]).mean(), xg)
    live = (g.abs() > 1e-6 * g.abs().max()).numpy()
    assert live.mean() > 0.9
    np.testing.assert_allclose(p_adv.numpy()[live], j_adv[live], rtol=0,
                               atol=1e-6)
    # the core on the mean softmax gives the same batch
    core, _ = p_attacks.fgsm_mean_prob_attack(
        lambda xn: sum(torch.softmax(f(xn), -1) for f in pfwds) / 2,
        xt, yt, EPS)
    torch.testing.assert_close(core, p_adv, rtol=0, atol=0)


@pytest.mark.parametrize("row", ["standalone", "switch(0,1)", "solver_ens",
                                 "model_ensembling"])
def test_regime_accuracies_match_jax(setup, row):
    """Clean and FGSM (eps 0.3) accuracy of one regime of the grid, counts
    against JAX's: standalone; switch pinned to the u=1.0 solver by
    switch_probs (0, 1); the solver_ens row (ensemble_prob 1 draws heads
    always); model ensembling with the noised member pinned.  Clean counts
    equal; FGSM counts within 1 of 64 (a sign step on an ulp-sized
    gradient)."""
    s = setup
    jgrid, pgrid = _grids(s)
    jatk, patk = JAttackConfig(mode="fgsm", eps=EPS), AttackConfig(
        mode="fgsm", eps=EPS)
    if row == "model_ensembling":
        jm = [(s["params"], s["state"], [sv], JSolverOptions())
              for sv in jgrid[3].solvers]
        pm = [(s["pmodel"], [sv], SolverOptions())
              for sv in pgrid[3].solvers]
        jc = j_accuracy_ensemble(s["jmodel"], jm, s["data"]())
        pc = accuracy_ensemble(pm, s["data"]())
        assert round(pc * 64) == round(jc * 64) and pc > 0.5
        # the closure can be built once and passed in
        assert accuracy_ensemble(pm, s["data"](),
                                 predict=make_ensemble_probs(pm)) == pc
        ja = j_adversarial_accuracy_ensemble(s["jmodel"], jm, s["data"](),
                                             jatk, jax.random.key(5))
        pa = adversarial_accuracy_ensemble(pm, s["data"](), patk,
                                           torch.Generator().manual_seed(5))
        assert abs(round(pa * 64) - round(ja * 64)) <= 1, (pa, ja)
        return
    jr, pr = {"standalone": (jgrid[0], pgrid[0]),
              "solver_ens": (jgrid[2], pgrid[2])}.get(row, (None, None))
    if row == "switch(0,1)":
        jr = jgrid[1]._replace(options=JSolverOptions(
            solver_mode="switch", switch_probs=(0.0, 1.0)))
        pr = pgrid[1]._replace(options=SolverOptions(
            solver_mode="switch", switch_probs=(0.0, 1.0)))
    jk = jax.random.key(3) if jr.needs_key else None
    pg = torch.Generator().manual_seed(3) if pr.needs_key else None
    jc = j_accuracy(s["jmodel"], s["params"], s["state"], jr.solvers,
                    jr.options, s["data"](), key=jk)
    pc = accuracy(s["pmodel"], pr.solvers, pr.options, s["data"](),
                  generator=pg)
    assert round(pc * 64) == round(jc * 64), (pc, jc)
    ja = j_adversarial_accuracy(s["jmodel"], s["params"], s["state"],
                                jr.solvers, jr.options, s["data"](), jatk,
                                jax.random.key(4))
    pa = adversarial_accuracy(s["pmodel"], pr.solvers, pr.options,
                              s["data"](), patk,
                              torch.Generator().manual_seed(4))
    assert abs(round(pa * 64) - round(ja * 64)) <= 1, (pa, ja)


def test_sn_test_matches_jax(setup):
    """The step-count sweep over [1, 2, 4]: counts equal JAX's at every
    count; a leftover custom grid is cleared by the regrid."""
    s = setup
    jr = j_sn_test(s["jmodel"], s["params"], s["state"], s["js"],
                   JSolverOptions(), s["data"], [1, 2, 4])
    custom = s["ps"].replace(custom_grid=(0.0, 1.0))
    pr = sn_test(s["pmodel"], custom, SolverOptions(), s["data"], [1, 2, 4])
    assert [round(a * 64) for a in pr] == [round(a * 64) for a in jr]
    assert pr[1] == 1.0  # 2 steps: the labels' own solver
    # with a generator each count starts from the same state (JAX reuses
    # its key): the solver_ens regime regridded, the switch draws fixed
    g = torch.Generator().manual_seed(9)
    opts = SolverOptions(solver_mode="switch", switch_probs=(1.0,))
    assert sn_test(s["pmodel"], s["ps"], opts, s["data"], [2, 2], g) == \
        [1.0, 1.0]


def test_mnist_train_step_under_switch_matches_jax(setup):
    """One step of the MNIST make_train_step (FGSM at eps 0.3, the
    ss-loss, RMSprop lr 1e-3, weight decay 5e-4) under switch_probs
    (0, 1), whose draws (the attack's forward, the training forward and
    the ss-loss's replay) all take the u = 1.0 solver: loss within 1e-5 of
    JAX's."""
    s = setup
    jgrid, pgrid = _grids(s)
    jopts = JSolverOptions(solver_mode="switch", switch_probs=(0.0, 1.0))
    popts = SolverOptions(solver_mode="switch", switch_probs=(0.0, 1.0))
    tx = j_make_optimizer("rmsprop", 1e-3, weight_decay=5e-4)
    jts = JTrainState(step=jnp.zeros((), jnp.int32), params=s["params"],
                      model_state=s["state"], opt_state=tx.init(s["params"]))
    pmodel = build_model("mnist", device="cpu", dim=DIM)
    pmodel.load_state_dict(s["pmodel"].state_dict())
    opt = make_optimizer("rmsprop", 1e-3, weight_decay=5e-4)
    jstep = j_make_train_step(s["jmodel"], tx, jgrid[1].solvers, jopts,
                              JAttackConfig(mode="fgsm", eps=EPS),
                              loss_cfg=JLossConfig(ss_loss=True),
                              donate=False)
    pstep = make_train_step(pmodel, opt, pgrid[1].solvers, popts,
                            AttackConfig(mode="fgsm", eps=EPS),
                            loss_cfg=LossConfig(ss_loss=True))
    x, y = next(s["data"]())
    _, jm = jstep(jts, jnp.asarray(x), jnp.asarray(y), jax.random.key(0))
    _, pm = pstep(create_train_state(pmodel, opt), torch.tensor(x),
                  torch.tensor(y), torch.Generator().manual_seed(0))
    assert abs(pm["loss"].item() - float(jm["loss"])) < 1e-5
    assert abs(pm["ss_loss"].item() - float(jm["ss_loss"])) < \
        1e-5 * float(jm["ss_loss"])


def test_mesh_and_missing_generators_raise(setup):
    """A one-rank mesh gives the member loop's clean and FGSM results (the
    members on the member axis); the draw of a switch regime needs a
    generator in every entry point, the mesh path's too."""
    from neural_ode_metasolver_tpu_torch.parallel import make_mesh

    mesh = make_mesh({"ensemble": 1})
    pm = [(setup["pmodel"], [setup["ps"].replace(u=torch.tensor(u))],
           SolverOptions()) for u in (0.5, 0.7)]
    assert accuracy_ensemble(pm, setup["data"](), mesh=mesh) == \
        accuracy_ensemble(pm, setup["data"]())
    x, y = (torch.tensor(a) for a in next(setup["data"]()))
    atk = AttackConfig(mode="fgsm", eps=EPS)
    torch.testing.assert_close(
        make_ensemble_attacked_probs(pm, atk, mesh=mesh)(x, y),
        make_ensemble_attacked_probs(pm, atk)(x, y), rtol=0, atol=1e-6)
    sw_members = [(setup["pmodel"], [setup["ps"]],
                   SolverOptions(solver_mode="switch"))] * 2
    with pytest.raises(ValueError, match="needs a PRNG key"):
        accuracy_ensemble(sw_members, setup["data"](), mesh=mesh)
    sw = SolverOptions(solver_mode="switch")
    with pytest.raises(ValueError, match="needs a PRNG key"):
        accuracy(setup["pmodel"], [setup["ps"]], sw, setup["data"]())
    with pytest.raises(ValueError, match="needs a PRNG key"):
        accuracy_ensemble([(setup["pmodel"], [setup["ps"]], sw)],
                          setup["data"]())
