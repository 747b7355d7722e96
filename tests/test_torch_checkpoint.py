"""Checkpoints, metrics log, profiling, accuracy tables and utilities of the
PyTorch port, on the CPU: save and restore bit for bit (blocking and on the
background thread), ``latest_step`` skipping an uncommitted step, the config
sidecar and the ``metrics.jsonl`` records against the JAX package's for the
same inputs, and the reference pickle schema read across packages."""
import dataclasses
import json
import os
import pickle

import jax
import numpy as np
import pytest
import torch

from neural_ode_metasolver_tpu.models.api import build_model as j_build_model
from neural_ode_metasolver_tpu.ops import SolverOptions as JSolverOptions
from neural_ode_metasolver_tpu.ops import create_solver as j_create_solver
from neural_ode_metasolver_tpu.training import (
    create_train_state as j_create_train_state,
    make_optimizer as j_make_optimizer,
    restore_checkpoint as j_restore_checkpoint,
    save_checkpoint as j_save_checkpoint,
)
from neural_ode_metasolver_tpu.training import accuracy_tables as j_tables
from neural_ode_metasolver_tpu.training.logging import (
    MetricsLogger as JMetricsLogger,
)
from neural_ode_metasolver_tpu.utils import count_parameters as j_count
from neural_ode_metasolver_tpu_torch.models import (
    build_model,
    cifar_params_from_jax,
    cifar_state_from_jax,
)
from neural_ode_metasolver_tpu_torch.ops import create_solver
from neural_ode_metasolver_tpu_torch.training import (
    AttackConfig,
    MetricsLogger,
    create_train_state,
    make_train_step,
    latest_step,
    load_accuracy_table,
    load_checkpoint_config,
    make_optimizer,
    restore_checkpoint,
    save_accuracy_table,
    save_checkpoint,
    wait_for_checkpoints,
)
from neural_ode_metasolver_tpu_torch.training import profiling
from neural_ode_metasolver_tpu_torch.utils import (
    atomic_write,
    count_parameters,
    fix_seeds,
    get_logger,
)
from test_torch_runners import one_torch_thread  # noqa: F401 (autouse)

CONFIG = {"args": {"optim": "sgd", "lr": 0.1, "switch_probs": None,
                   "data_mean": (0.4914, 0.4822, 0.4465),
                   "val_solver_modes": ["standalone"], "seed": 502,
                   "odd": np.float32(0.5)},
          "solvers": "rk2,u,8,-1,0.5,-1", "model": "mnist"}


def _trained_state(seed, kind="sgd", **kw):
    """A small MNIST model's state after three updates, so every optimizer
    buffer is nonzero."""
    model = build_model("mnist", device="cpu", dim=8,
                        generator=torch.Generator().manual_seed(seed))
    opt = make_optimizer(kind, 0.01, **kw)
    state = create_train_state(model, opt)
    g = torch.Generator().manual_seed(seed)
    for _ in range(3):
        grads = [torch.randn(p.shape, generator=g)
                 for p in state.params.values()]
        opt.update(state.params, grads, state.opt_state)
    return model, opt, dataclasses.replace(state, step=3)


def _assert_state_equal(a, b):
    assert a.step == b.step
    assert set(a.params) == set(b.params)
    for k in a.params:
        assert torch.equal(a.params[k], b.params[k]), k
    assert set(a.opt_state) == set(b.opt_state)
    for key, v in a.opt_state.items():
        if isinstance(v, dict):
            for k in v:
                assert torch.equal(v[k], b.opt_state[key][k]), (key, k)
        else:
            assert v == b.opt_state[key], key


@pytest.mark.parametrize("block", [True, False])
@pytest.mark.parametrize("opt", [("sgd", {}), ("adam", {"every_k": 2,
                                                        "nonfinite_backoff":
                                                            0.5})])
def test_save_and_restore_bit_for_bit(tmp_path, block, opt):
    kind, kw = opt
    model, tx, state = _trained_state(1, kind, **kw)
    base = str(tmp_path / "last")
    saved = dataclasses.replace(
        state, params={k: p.detach().clone() for k, p in state.params.items()})
    path = save_checkpoint(base, state, CONFIG, block=block)
    # the async save copied the tensors before it returned
    with torch.no_grad():
        for p in state.params.values():
            p.add_(1.0)
    wait_for_checkpoints()
    assert os.path.isfile(os.path.join(path, "state"))
    assert latest_step(base) == 3
    _, _, fresh = _trained_state(2, kind, **kw)
    restored, cfg = restore_checkpoint(base, fresh)
    _assert_state_equal(restored, saved)
    # in place, into the target model's own parameters
    assert all(restored.params[k] is fresh.params[k] for k in fresh.params)
    assert cfg == json.loads(json.dumps(CONFIG, default=str))
    assert load_checkpoint_config(base) == cfg


# a CIFAR net with a model state: BN running statistics and SN vectors
STATEFUL = dict(in_planes=8, norms=("BN", "BN", "BN"),
                param_norms=("SN", "SN", "PNF"))


@pytest.mark.parametrize("block", [True, False])
def test_model_state_round_trips_bit_for_bit(tmp_path, block):
    """Two FGSM steps move BN's statistics and SN's vectors; the
    checkpoint restores them into another model's buffers bit for bit, in
    place, and the restored model's eval logits equal the trained one's."""
    model = build_model("premetanode6", device="cpu", **STATEFUL)
    opt = make_optimizer("sgd", 0.05, momentum=0.9)
    state = create_train_state(model, opt)
    start = {k: b.clone() for k, b in state.model_state.items()}
    step = make_train_step(model, opt,
                           [create_solver("rk2", "u", n_steps=1, u0=0.5)],
                           attack_cfg=AttackConfig(mode="fgsm"))
    g = torch.Generator().manual_seed(0)
    for i in range(2):
        state, _ = step(state, torch.rand(4, 32, 32, 3, generator=g),
                        torch.tensor([0, 1, 2, 3]),
                        torch.Generator().manual_seed(i))
    assert {k for k in state.model_state} == {
        k for k, _ in model.named_buffers()}
    assert any(k.endswith("sn_u") for k in start)
    for k, b in state.model_state.items():
        # BN inside the ODE RHS normalizes with the batch's statistics and
        # keeps its running ones at the init, as in JAX
        rhs_bn = ".ode." in k and not k.endswith("sn_u")
        assert torch.equal(b, start[k]) == rhs_bn, k
    saved = {k: b.clone() for k, b in state.model_state.items()}
    save_checkpoint(str(tmp_path / "last"), state, block=block)
    with torch.no_grad():  # the async save copied before it returned
        for b in state.model_state.values():
            b.add_(1.0)
    wait_for_checkpoints()
    fresh = build_model("premetanode6", device="cpu",
                        generator=torch.Generator().manual_seed(7),
                        **STATEFUL)
    target = create_train_state(fresh, opt)
    restored, _ = restore_checkpoint(str(tmp_path / "last"), target)
    assert restored.step == 2
    for k, b in fresh.named_buffers():
        assert restored.model_state[k] is b
        assert torch.equal(b, saved[k]), k
    with torch.no_grad():
        for b, v in zip(state.model_state.values(), saved.values()):
            b.copy_(v)
    x = torch.rand(2, 32, 32, 3, generator=g)
    solvers = [create_solver("rk2", "u", n_steps=1, u0=0.5)]
    with torch.inference_mode():
        assert torch.equal(fresh(x, solvers), model(x, solvers))


def test_jax_checkpoint_with_model_state_resumes_in_port(tmp_path):
    """A JAX checkpoint of a BN + SN net (its BN statistics moved off the
    init) restored by JAX, carried across with ``cifar_params_from_jax``
    and ``cifar_state_from_jax``: the port's eval logits match JAX's with
    that state, and the port trains on from it."""
    jmodel = j_build_model("metanode6", **STATEFUL)
    tx = j_make_optimizer("sgd", 0.05, momentum=0.9)
    jts = j_create_train_state(jmodel, tx, jax.random.key(3))
    rs = np.random.RandomState(4)
    moved = jax.tree_util.tree_map_with_path(
        lambda p, a: (np.float32(rs.rand(*a.shape) + 0.5)
                      if jax.tree_util.keystr(p).endswith("['var']")
                      else np.float32(rs.randn(*a.shape) * 0.1)
                      if jax.tree_util.keystr(p).endswith("['mean']")
                      else a), jts.model_state)
    jts = jts.replace(model_state=moved, step=jts.step + 5)
    j_save_checkpoint(str(tmp_path / "jax"), jts)
    jr, _ = j_restore_checkpoint(
        str(tmp_path / "jax"), j_create_train_state(jmodel, tx,
                                                    jax.random.key(0)))
    to_np = lambda t: jax.tree_util.tree_map(  # noqa: E731
        lambda a: np.asarray(a, np.float32), t)
    x = np.random.RandomState(5).rand(2, 32, 32, 3).astype(np.float32)
    jl, _, _ = jmodel.apply(jr.params, jr.model_state, x,
                            [j_create_solver("rk2", "u", n_steps=1,
                                             u0=np.float32(0.5))],
                            JSolverOptions())
    model = build_model("metanode6", device="cpu", **STATEFUL)
    opt = make_optimizer("sgd", 0.05, momentum=0.9)
    state = create_train_state(
        model, opt, {**cifar_params_from_jax(to_np(jr.params)),
                     **cifar_state_from_jax(to_np(jr.model_state))},
        step=int(jr.step))
    assert state.step == 5 and any(
        k.endswith("sn_u") for k in state.model_state)
    solvers = [create_solver("rk2", "u", n_steps=1, u0=0.5)]
    with torch.inference_mode():
        pl = model(torch.tensor(x), solvers)
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), atol=3e-4)
    state, m = make_train_step(model, opt, solvers)(
        state, torch.tensor(x), torch.tensor([1, 2]),
        torch.Generator().manual_seed(0))
    assert state.step == 6 and torch.isfinite(m["loss"])


def test_latest_step_skips_an_uncommitted_step(tmp_path):
    _, _, state = _trained_state(1)
    base = str(tmp_path / "best")
    assert latest_step(base) is None
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(base, state)
    save_checkpoint(base, state, CONFIG)
    # a crash between the sidecar and the state's commit
    torn = os.path.join(base, "step_00000009")
    os.makedirs(torn)
    with open(os.path.join(torn, "config.json"), "w") as f:
        f.write("{}")
    open(os.path.join(torn, "state.123.tmp"), "w").close()
    assert latest_step(base) == 3
    assert load_checkpoint_config(base)["model"] == "mnist"
    # a mismatched template refuses to restore
    other = create_train_state(
        build_model("mnist", device="cpu", dim=16),
        make_optimizer("sgd", 0.01))
    with pytest.raises(ValueError):
        restore_checkpoint(base, other)


def test_sidecar_equals_the_jax_packages(tmp_path):
    jmodel = j_build_model("mnist", dim=8)
    jts = j_create_train_state(jmodel, j_make_optimizer("sgd", 0.01),
                               jax.random.key(0))
    jpath = j_save_checkpoint(str(tmp_path / "jax"), jts, CONFIG)
    _, _, state = _trained_state(1)
    state = dataclasses.replace(state, step=0)
    ppath = save_checkpoint(str(tmp_path / "port"), state, CONFIG)
    assert os.path.basename(jpath) == os.path.basename(ppath) == \
        "step_00000000"
    with open(os.path.join(jpath, "config.json")) as f:
        jtext = f.read()
    with open(os.path.join(ppath, "config.json")) as f:
        assert f.read() == jtext


def test_metrics_log_records_have_the_jax_keys(tmp_path):
    recs = [({"epoch": 0, "train_loss": np.float32(2.3), "batch_time": 0.1,
              "loss": torch.tensor(2.2)}, 4),
            ({"epoch": 0, "best_standalone_0": 0.125}, 4),
            ({"best": 0.5, "note": object}, None)]
    for logger_cls, sub in ((JMetricsLogger, "jax"), (MetricsLogger, "port")):
        with logger_cls(str(tmp_path / sub), config=CONFIG) as log:
            for metrics, step in recs:
                log.log({k: (float(v) if isinstance(v, torch.Tensor)
                             and sub == "jax" else v)
                         for k, v in metrics.items()}, step=step)
    lines = {}
    for sub in ("jax", "port"):
        with open(tmp_path / sub / "metrics.jsonl") as f:
            lines[sub] = [json.loads(line) for line in f]
    assert len(lines["port"]) == len(lines["jax"]) == 4
    for j, p in zip(lines["jax"], lines["port"]):
        assert list(j) == list(p)
        j.pop("_time", None), p.pop("_time", None)
        assert j == p
    assert lines["port"][0]["_type"] == "config"


def test_accuracy_tables_and_utilities(tmp_path):
    accs, steps = [[0.5, 0.625], [0.75, 1.0]], [1, 8]
    save_accuracy_table(str(tmp_path / "p.pkl"), accs, steps)
    j_tables.save_accuracy_table(str(tmp_path / "j.pkl"), accs, steps)
    assert j_tables.load_accuracy_table(str(tmp_path / "p.pkl")) == \
        load_accuracy_table(str(tmp_path / "j.pkl"))
    for suffix in (".pkl", ".pkl.csv"):
        with open(tmp_path / f"p{suffix}", "rb") as a, \
                open(tmp_path / f"j{suffix}", "rb") as b:
            assert a.read() == b.read()
    with open(tmp_path / "bad.pkl", "wb") as f:
        pickle.dump([1], f)
    with pytest.raises(ValueError):
        load_accuracy_table(str(tmp_path / "bad.pkl"))

    jmodel = j_build_model("mnist", dim=8)
    jparams, _ = jmodel.init(jax.random.key(0))
    model = build_model("mnist", device="cpu", dim=8)
    assert count_parameters(model) == j_count(jparams) == count_parameters(
        dict(model.named_parameters()))
    assert fix_seeds(7) == 7
    a = torch.rand(3)
    fix_seeds(7)
    assert torch.equal(a, torch.rand(3)) and np.random.rand() == \
        np.random.RandomState(7).rand()
    with atomic_write(str(tmp_path / "out.txt")) as f:
        f.write("done")
    with pytest.raises(RuntimeError):
        with atomic_write(str(tmp_path / "out.txt")) as f:
            f.write("torn")
            raise RuntimeError
    assert (tmp_path / "out.txt").read_text() == "done"
    assert not [p for p in os.listdir(tmp_path) if p.endswith(".tmp")]
    log = get_logger(str(tmp_path / "logs" / "run"), displaying=False,
                     name="test_torch_checkpoint")
    log.info("hello")
    assert "hello" in (tmp_path / "logs" / "run").read_text()


def test_profiling_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path / "prof")):
        with profiling.annotate("nodems.test"):
            torch.ones(4).sum()
    with open(tmp_path / "prof" / "trace.json") as f:
        trace = json.load(f)
    assert any(e.get("name") == "nodems.test"
               for e in trace["traceEvents"])
    with pytest.raises(RuntimeError):
        profiling.stop_trace()
    with pytest.raises(ZeroDivisionError):  # the trace is written anyway
        with profiling.trace(str(tmp_path / "prof2")):
            1 / 0
    assert os.path.exists(tmp_path / "prof2" / "trace.json")
