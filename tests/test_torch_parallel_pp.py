"""Pipeline parallelism (a ``pp`` mesh axis, ``parallel/pipeline.py``) of
the PyTorch port on the CPU, against the JAX package.

Four gloo ranks run, on a ``pp=4`` mesh, ``pipeline_apply`` over four
stacked ODE blocks in eight microbatches (its output and its gradient
against JAX's sequential composition, atol 1e-5 / rtol 1e-4) and its
validation errors; then, on a ``data=2, pp=2`` mesh, a custom deep stack
(``num_blocks ((1,2),(1,2))``, two microbatches) built sequential and
pipelined: a full train step against JAX's sequential step (loss abs 1e-6,
params 1e-6), the switch regime's draws in the sequential loop's order,
the fallbacks to the sequential loop, and the no-grad forward that runs
B2 per microbatch (mirrors ``tests/test_parallel.py:304-418`` and
``:555-648``).  This file is its own worker (``tests/torch_mesh.py``).
"""
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_mesh import REPO, run_ranks, worker_main  # noqa: E402

if REPO not in sys.path:
    sys.path.insert(0, REPO)

S, M = 4, 8
ORDER = [(c, k) for c in ("c1", "c2") for k in ("kernel", "bias")]


def _stages(inputs):
    return [{c: {k: torch.tensor(v) for k, v in inputs["stages"][i][c]
                 .items()} for c in ("c1", "c2")} for i in range(S)]


def _block(solver):
    import torch.nn.functional as F

    from neural_ode_metasolver_tpu_torch.models import nn as fnn

    def block(p, xb):
        def rhs(t, yv):
            h = F.gelu(fnn.conv2d(p["c1"], yv, padding=1),
                       approximate="tanh")
            return fnn.conv2d(p["c2"], h, padding=1)

        return solver.integrate_final(rhs, xb)

    return block


def _pipeline_scenarios(inputs):
    from neural_ode_metasolver_tpu_torch.ops import create_solver
    from neural_ode_metasolver_tpu_torch.parallel import (
        make_mesh, pipeline_apply, stack_stage_params)

    mesh = make_mesh({"pp": S, "data": 1})
    block = _block(create_solver("rk2", "u", n_steps=2, u0=0.5))
    stacked = stack_stage_params(_stages(inputs))
    stacked = torch.utils._pytree.tree_map(
        lambda t: t.requires_grad_(True), stacked)
    x = torch.tensor(inputs["x8"]).requires_grad_(True)
    y = pipeline_apply(block, stacked, x, mesh, axis="pp", n_microbatches=M)
    loss = (y ** 2).mean()
    leaves = [stacked[c][k] for c, k in ORDER]
    grads = torch.autograd.grad(loss, leaves + [x])
    out = {"y": y.detach(), "grads": [g.detach() for g in grads]}
    errors = []
    for bad, xb in (({"w": torch.zeros(3, 2)}, torch.zeros(8, 2)),
                    ({"w": torch.zeros(4, 2)}, torch.zeros(7, 2))):
        try:
            pipeline_apply(lambda p, v: v, bad, xb, mesh, axis="pp",
                           n_microbatches=4)
            errors.append("no error")
        except ValueError as e:
            errors.append(str(e))
    out["errors"] = errors
    return out


def _models(inputs, mesh, num_blocks=((1, 2), (1, 2))):
    from neural_ode_metasolver_tpu_torch.models import make_cifar_model
    from neural_ode_metasolver_tpu_torch.models.odenet_cifar10 import (
        CifarConfig)
    from neural_ode_metasolver_tpu_torch.parallel import PipelineConfig

    cfg = CifarConfig(num_blocks=num_blocks, block_type="prebasic",
                      in_planes=8)
    seq = make_cifar_model(cfg, "cpu")
    pp = make_cifar_model(cfg, "cpu", pipeline=PipelineConfig(
        mesh=mesh, axis="pp", n_microbatches=2, batch_axis="data"))
    if num_blocks == ((1, 2), (1, 2)):
        seq.load_state_dict(inputs["params"])
        pp.load_state_dict(inputs["params"])
    else:
        pp.load_state_dict(seq.state_dict())
    return seq, pp


def _model_scenarios(inputs):
    from neural_ode_metasolver_tpu_torch.backend import (
        launch_counts, reset_launch_counts)
    from neural_ode_metasolver_tpu_torch.ops import (
        SolverOptions, create_solver)
    from neural_ode_metasolver_tpu_torch.parallel import (
        batch_sharding, make_mesh, make_parallel_train_step)
    from neural_ode_metasolver_tpu_torch.training import (
        create_train_state, make_optimizer, make_train_step)
    import neural_ode_metasolver_tpu_torch.ops.ode_block as ob

    mesh = make_mesh({"data": 2, "pp": 2})
    x, y = torch.tensor(inputs["x"]), torch.tensor(inputs["y"])
    solvers = [create_solver("rk2", "u", n_steps=2, u0=0.5)]
    out = {}

    # a full train step through the pipelined stacks
    _, pp = _models(inputs, mesh)
    opt = make_optimizer("sgd", 0.05, momentum=0.9)
    ts = create_train_state(pp, opt)
    step = make_parallel_train_step(make_train_step(pp, opt, solvers), mesh)
    rows = batch_sharding(mesh).local
    ts, m = step(ts, rows(x), rows(y), torch.Generator().manual_seed(9))
    out["step"] = {"loss": float(m["loss"]),
                   **{k: v.detach().clone() for k, v in ts.params.items()}}

    # the switch regime's draws: the sequential loop's order
    seq, pp = _models(inputs, mesh)
    two = [create_solver("rk2", "u", n_steps=2, u0=0.5 + 0.2 * i)
           for i in range(2)]
    sw = SolverOptions(solver_mode="switch")
    out["switch"] = []
    for trial in range(3):
        g = lambda: torch.Generator().manual_seed(100 + trial)  # noqa
        with torch.no_grad():
            out["switch"].append((seq(x, two, sw, generator=g()),
                                  pp(x, two, sw, generator=g())))

    # the fallbacks: tail batches, the ss-loss, the adjoint, one block
    fb = {}
    with torch.no_grad():
        for n in (5, 6):
            fb[f"tail{n}"] = (seq(x[:n], solvers), pp(x[:n], solvers))
    _, a_seq = seq(x, solvers, ss_loss=True, return_aux=True)
    _, a_pp = pp(x, solvers, ss_loss=True, return_aux=True)
    fb["ss_loss"] = (a_seq["ss_loss"].detach(), a_pp["ss_loss"].detach())
    xg = x.clone().requires_grad_(True)
    fb["adjoint"] = tuple(
        torch.autograd.grad(
            model(xg, solvers, integration_method="adjoint").sum(), xg)[0]
        for model in (seq, pp))
    seq1, pp1 = _models(inputs, mesh, num_blocks=((1, 1), (1, 1)))
    with torch.no_grad():
        fb["one_block"] = (seq1(x, solvers), pp1(x, solvers))
    out["fallbacks"] = fb

    # no-grad forward of the exact-GELU NF stack: B2 per microbatch
    calls = []
    orig = ob.ode_block_rk2_forward

    def spy(y0, *a, **kw):
        calls.append(y0.shape[0])
        return orig(y0, *a, **kw)

    import neural_ode_metasolver_tpu_torch.models.odenet_cifar10 as oc
    oc.ode_block_rk2_forward = spy
    try:
        reset_launch_counts()
        with torch.no_grad():
            out["b2"] = (seq(x, solvers), pp(x, solvers), list(calls))
        out["counts"] = launch_counts()
    finally:
        oc.ode_block_rk2_forward = orig
    return out


def run(inputs, world, rank):
    return {"pipeline": _pipeline_scenarios(inputs),
            "models": _model_scenarios(inputs)}


def _jax_reference(inputs):
    import jax
    import jax.numpy as jnp

    from neural_ode_metasolver_tpu.models import nn as jnn
    from neural_ode_metasolver_tpu.models.api import make_cifar_model as jmk
    from neural_ode_metasolver_tpu.models.odenet_cifar10 import (
        CifarConfig as JCfg)
    from neural_ode_metasolver_tpu.ops import SolverOptions as JOpts
    from neural_ode_metasolver_tpu.ops import create_solver as jsolver
    from neural_ode_metasolver_tpu.training import (
        create_train_state as jstate, make_optimizer as jopt,
        make_train_step as jstep)

    solver = jsolver("rk2", "u", n_steps=2, u0=np.float32(0.5))
    stages = [{c: {k: jnp.asarray(v) for k, v in inputs["stages"][i][c]
                   .items()} for c in ("c1", "c2")} for i in range(S)]

    def block(p, xb):
        def rhs(t, yv):
            h = jax.nn.gelu(jnn.conv2d(p["c1"], yv, padding=1))
            return jnn.conv2d(p["c2"], h, padding=1)

        return solver.integrate_final(rhs, xb)

    def loss_seq(stage_list, x):
        y = x
        for p in stage_list:
            y = block(p, y)
        return jnp.mean(y ** 2), y

    x8 = jnp.asarray(inputs["x8"])
    (_, y_seq), (g_st, g_x) = jax.value_and_grad(
        loss_seq, argnums=(0, 1), has_aux=True)(stages, x8)
    g_leaves = [np.asarray(jnp.stack([g[c][k] for g in g_st]))
                for c, k in ORDER]

    cfg = JCfg(num_blocks=((1, 2), (1, 2)), block_type="prebasic",
               in_planes=8)
    jmodel = jmk(cfg)
    tx = jopt("sgd", 0.05, momentum=0.9)
    ts = jstate(jmodel, tx, jax.random.key(0))
    raw = jstep(jmodel, tx, [solver], JOpts(), jit_compile=False,
                donate=False)
    ts2, m = jax.jit(raw)(ts, jnp.asarray(inputs["x"]),
                          jnp.asarray(inputs["y"]), jax.random.key(9))
    return dict(y=np.asarray(y_seq), grads=g_leaves + [np.asarray(g_x)],
                loss=float(m["loss"]), params0=ts.params,
                params=ts2.params)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    import jax

    from neural_ode_metasolver_tpu_torch.models import cifar_params_from_jax

    torch.set_num_threads(1)
    rs = np.random.RandomState(3)
    bound = 1 / np.sqrt(8 * 9)
    stages = [{c: {"kernel": rs.uniform(-bound, bound, (3, 3, 8, 8))
                   .astype(np.float32),
                   "bias": rs.uniform(-bound, bound, 8).astype(np.float32)}
               for c in ("c1", "c2")} for _ in range(S)]
    inputs = {"stages": stages,
              "x8": rs.randn(16, 8, 8, 8).astype(np.float32),
              "x": np.random.RandomState(3).rand(8, 32, 32, 3)
              .astype(np.float32),
              "y": (np.arange(8) % 10).astype(np.int64)}
    ref = _jax_reference(inputs)
    conv = lambda t: cifar_params_from_jax(jax.tree_util.tree_map(  # noqa
        lambda a: np.asarray(a, np.float32), t))
    inputs["params"] = conv(ref.pop("params0"))
    ref["params"] = conv(ref["params"])
    ranks = run_ranks(__file__, 4, inputs, tmp_path_factory.mktemp("pp"))
    return dict(ref=ref, ranks=ranks)


def test_pipeline_apply_matches_sequential(runs):
    """GPipe over 4 stacked ODE blocks on a pp axis of 4 ranks, 8
    microbatches, equals JAX's sequential composition at atol 1e-5 on
    every rank (mirrors JAX ``test_pipeline_apply_matches_sequential``)."""
    for res in runs["ranks"]:
        np.testing.assert_allclose(res["pipeline"]["y"].numpy(),
                                   runs["ref"]["y"], atol=1e-5, rtol=1e-5)


def test_pipeline_apply_is_trainable(runs):
    """The gradient of the pipelined loss in every stacked param (and the
    input) equals JAX's gradient of the sequential composition at atol
    1e-5 rtol 1e-4, on every rank (mirrors JAX
    ``test_pipeline_apply_is_trainable``)."""
    for res in runs["ranks"]:
        got = res["pipeline"]["grads"]
        assert len(got) == len(runs["ref"]["grads"]) == 4 + 1
        for a, b in zip(got, runs["ref"]["grads"]):
            np.testing.assert_allclose(a.numpy(), b, atol=1e-5, rtol=1e-4)


def test_pipeline_apply_validates(runs):
    """JAX's ValueErrors: stacked leading dims other than the axis size;
    a batch that does not split into the microbatches (mirrors JAX
    ``test_pipeline_apply_validates``); also with no process group."""
    from neural_ode_metasolver_tpu_torch.parallel import (
        make_mesh, pipeline_apply)

    for res in runs["ranks"]:
        assert res["pipeline"]["errors"] == [
            "stacked_params leading dims {3} != pp axis size 4",
            "batch 7 not divisible by 4 microbatches"]
    mesh = make_mesh({"pp": 1, "data": 1})
    with pytest.raises(ValueError, match=r"leading dims \{3\} != pp axis"):
        pipeline_apply(lambda p, v: v, {"w": torch.zeros(3, 2)},
                       torch.zeros(8, 2), mesh, axis="pp", n_microbatches=4)
    with pytest.raises(ValueError, match="batch 7 not divisible by 4"):
        pipeline_apply(lambda p, v: v, {"w": torch.zeros(1, 2)},
                       torch.zeros(7, 2), mesh, axis="pp", n_microbatches=4)


def test_pp_train_step_matches_jax_sequential(runs):
    """A full train step through the pipelined stacks on data=2 x pp=2
    equals JAX's sequential step: loss at abs 1e-6, every param within
    1e-6 (mirrors JAX ``test_pp_train_step_matches_sequential``)."""
    ref = runs["ref"]
    for res in runs["ranks"]:
        got = res["models"]["step"]
        assert got["loss"] == pytest.approx(ref["loss"], abs=1e-6)
        d = max(float((got[k] - ref["params"][k]).abs().max())
                for k in ref["params"])
        assert d < 1e-6


def test_pp_switch_mode_key_parity(runs):
    """The pipelined blocks' switch draws are made in the sequential
    loop's order, so the logits equal the sequential model's at 1e-6
    (mirrors JAX ``test_pp_switch_mode_key_parity``)."""
    for res in runs["ranks"]:
        for l_seq, l_pp in res["models"]["switch"]:
            np.testing.assert_allclose(l_pp.numpy(), l_seq.numpy(),
                                       atol=1e-6)


def test_pp_fallbacks_are_sequential(runs):
    """Tail batches of 5 (not 2 microbatches) and 6 (microbatches of 3 do
    not split over data=2), the ss-loss, the adjoint and single-block
    layers take the sequential loop: bit-equal to the sequential model
    (mirrors JAX ``test_pp_fallbacks_are_sequential``)."""
    for res in runs["ranks"]:
        fb = res["models"]["fallbacks"]
        for name in ("tail5", "tail6", "ss_loss", "adjoint", "one_block"):
            a, b = fb[name]
            assert torch.equal(a, b), name
        assert torch.isfinite(fb["ss_loss"][1])


def test_pp_no_grad_forward_runs_b2_per_microbatch(runs):
    """The exact-GELU NF stack's no-grad forward: the sequential model
    calls B2 once a block on the batch (4 blocks), the pipelined one once
    a microbatch on each stage's rank for its block (one block a stage, 2
    microbatches of 4, 2 layers); the logits agree at 1e-6."""
    for res in runs["ranks"]:
        l_seq, l_pp, calls = res["models"]["b2"]
        assert calls == [8] * 4 + [4] * 4
        np.testing.assert_allclose(l_pp.numpy(), l_seq.numpy(), atol=1e-6)
        assert res["models"]["counts"] == {}  # the CPU's plain versions


if __name__ == "__main__" and sys.argv[1] == "worker":
    worker_main(run)
