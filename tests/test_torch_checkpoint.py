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
from neural_ode_metasolver_tpu.training import (
    create_train_state as j_create_train_state,
    make_optimizer as j_make_optimizer,
    save_checkpoint as j_save_checkpoint,
)
from neural_ode_metasolver_tpu.training import accuracy_tables as j_tables
from neural_ode_metasolver_tpu.training.logging import (
    MetricsLogger as JMetricsLogger,
)
from neural_ode_metasolver_tpu.utils import count_parameters as j_count
from neural_ode_metasolver_tpu_torch.models import build_model
from neural_ode_metasolver_tpu_torch.training import (
    MetricsLogger,
    create_train_state,
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
