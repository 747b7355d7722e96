"""The port's serving export (``serving.export_model`` / ``load_model`` on
``torch.export``, kernels B1, B2 and B3 as the ``nodems::`` custom ops of
``ops/library.py``) against the JAX package's StableHLO export.

On the CPU every op runs its kernel's plain version, so an exported graph
computes what the live CPU path computes; the card's side (the ops'
kernels, launch counts, the move of a CPU artifact onto the card) is in
``test_torch_cuda.py`` and ``chip_smoke.py`` phase 26.
"""
import json
import os
import subprocess
import sys
from collections import Counter

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neural_ode_metasolver_tpu_torch.models import (
    build_model,
    mnist_params_from_jax,
)
from neural_ode_metasolver_tpu_torch.ops import (
    SolverOptions,
    conv3x3,
    group_norm,
    ode_block,
    parse_solver_dsl,
)
from neural_ode_metasolver_tpu_torch.serving import (
    ServedModel,
    export_model,
    load_model,
)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.join(REPO, "examples", "checkpoints")
CKPT = os.path.join(ROOT, "mnist_digits_smoothing")
SERVED = os.path.join(ROOT, "mnist_digits_smoothing_served")
SOLVERS = "rk2,u,8,-1,0.5,-1"
# launches a request on the card (PERF.md section 2): MNIST's 51 B3 and 32
# B1, premetanode10's 4 B1 and 2 solves of B2 at 33 launches each
CARD_LAUNCHES = {"mnist": {"group_norm_act": 51, "conv3x3_same": 32},
                 "premetanode10": {"conv3x3_same": 4, "ode_block_rk2": 66}}
OP_LAUNCHES = {"conv3x3_same": 1, "group_norm_act": 1, "ode_block_rk2": 33}


def _images(n, shape, seed):
    return np.random.RandomState(seed).rand(n, *shape).astype(np.float32)


def _mnist(dim=16, seed=0):
    return build_model("mnist", device="cpu", dim=dim,
                       generator=torch.Generator().manual_seed(seed))


@pytest.fixture(scope="module")
def artifact(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("served") / "mnist")
    model = _mnist()
    solvers = parse_solver_dsl(SOLVERS)
    export_model(path, model, solvers, SolverOptions(),
                 input_shape=(1, 28, 28, 1),
                 config={"model": "mnist", "solvers": SOLVERS,
                         "input_shape": "overridden", "platforms": ["tpu"]})
    return path, ServedModel(model, solvers)


def _graph_ops(path):
    program = torch.export.load(os.path.join(path, "model.pt2"))
    return Counter(str(n.target).split(".")[1] for n in program.graph.nodes
                   if n.op == "call_function"
                   and str(n.target).startswith("nodems."))


def _live_calls(monkeypatch, served, x):
    """The kernel wrappers' no-grad calls of one live request, by op."""
    calls = Counter()
    for mod, fn, name in ((conv3x3, "_launch_conv", "conv3x3_same"),
                          (group_norm, "_forward", "group_norm_act"),
                          (ode_block, "_solve", "ode_block_rk2")):
        def counted(*a, _f=getattr(mod, fn), _n=name, **k):
            calls[_n] += 1
            return _f(*a, **k)
        monkeypatch.setattr(mod, fn, counted)
    served(x)
    monkeypatch.undo()
    return calls


def test_roundtrip_matches_the_live_model(artifact):
    path, live = artifact
    served = load_model(path, "cpu")
    x = _images(4, (28, 28, 1), 1)
    got = served(x)
    assert got.dtype == torch.float32 and got.shape == (4, 10)
    np.testing.assert_allclose(got.numpy(), live(x).numpy(), atol=1e-5,
                               rtol=1e-5)
    assert served.config["model"] == "mnist"


@pytest.mark.parametrize("batch", [1, 3, 16])
def test_export_is_batch_polymorphic(artifact, batch):
    path, live = artifact
    served = load_model(path, "cpu")
    x = _images(batch, (28, 28, 1), batch)
    got = served(x)
    assert got.shape == (batch, 10)
    np.testing.assert_allclose(got.numpy(), live(x).numpy(), atol=1e-5,
                               rtol=1e-5)


def test_config_sidecar_reserved_keys_win(artifact):
    path, _ = artifact
    assert os.path.exists(os.path.join(path, "model.pt2"))
    with open(os.path.join(path, "config.json")) as f:
        cfg = json.load(f)
    assert list(cfg)[:2] == ["model", "solvers"]
    assert cfg["input_shape"] == [1, 28, 28, 1]
    assert cfg["input_dtype"] == "float32"
    assert cfg["batch_polymorphic"] is True
    assert cfg["platforms"] == ["cpu"]


def test_static_batch_export(tmp_path):
    model = _mnist(seed=1)
    solvers = parse_solver_dsl("rk2,u,2,-1,0.5,-1")
    path = str(tmp_path / "static")
    export_model(path, model, solvers, input_shape=(4, 28, 28, 1),
                 batch_polymorphic=False)
    served = load_model(path, "cpu")
    x = _images(4, (28, 28, 1), 2)
    np.testing.assert_allclose(
        served(x).numpy(), ServedModel(model, solvers)(x).numpy(),
        atol=1e-5, rtol=1e-5)
    assert served.config["batch_polymorphic"] is False
    with pytest.raises(Exception):
        served(_images(3, (28, 28, 1), 3))


def test_loaded_graph_keeps_only_what_a_request_needs(artifact):
    """load_model drops the metadata asserts, the no-op casts and the
    constant arithmetic (computed once at load) and keeps every kernel op
    and the input guards; the results stay those of the whole program, bit
    for bit."""
    path, _ = artifact
    whole = torch.export.load(os.path.join(path, "model.pt2")).module()
    lean = load_model(path, "cpu")

    def calls(graph):
        return Counter(str(n.target) for n in graph.nodes
                       if n.op == "call_function")

    before, after = calls(whole.graph), calls(lean._module.graph)
    assert before["aten._assert_tensor_metadata.default"] > 0
    assert after["aten._assert_tensor_metadata.default"] == 0
    assert after["aten.select.int"] == 0 and after["aten.to.dtype"] == 0
    assert sum(after.values()) < sum(before.values()) / 2
    assert {k: v for k, v in after.items() if k.startswith("nodems.")} == \
        {k: v for k, v in before.items() if k.startswith("nodems.")}
    x = torch.tensor(_images(3, (28, 28, 1), 8))
    with torch.inference_mode():
        assert torch.equal(lean(x), whole(x))


def test_mnist_graph_holds_the_ops_the_live_path_launches(artifact,
                                                         monkeypatch):
    path, live = artifact
    ops = _graph_ops(path)
    assert ops == _live_calls(monkeypatch, live, _images(2, (28, 28, 1), 4))
    assert {k: v * OP_LAUNCHES[k] for k, v in ops.items()} == \
        CARD_LAUNCHES["mnist"]


def test_premetanode10_bf16_graph_and_logits(tmp_path, monkeypatch):
    """in_planes 8 in bf16: B1 and B2 as ops, as many as the live path
    calls; the loaded logits equal the live path's (the same plain
    versions run on the CPU)."""
    model = build_model("premetanode10", device="cpu", in_planes=8,
                        generator=torch.Generator().manual_seed(0))
    solvers = parse_solver_dsl(SOLVERS)
    live = ServedModel(model, solvers, compute_dtype=torch.bfloat16)
    path = str(tmp_path / "cifar")
    export_model(path, model, solvers, input_shape=(1, 32, 32, 3),
                 compute_dtype=torch.bfloat16)
    ops = _graph_ops(path)
    x = _images(3, (32, 32, 3), 5)
    assert ops == _live_calls(monkeypatch, live, x)
    assert {k: v * OP_LAUNCHES[k] for k, v in ops.items()} == \
        CARD_LAUNCHES["premetanode10"]
    got = load_model(path, "cpu")(x)
    assert got.dtype == torch.float32 and got.shape == (3, 10)
    assert torch.equal(got, live(x))


def test_fake_kernels_agree_with_the_real_ones():
    """torch.library.opcheck: schema, fake kernel (shape, dtype, strides)
    against the CPU implementation, and the dynamic-shape trace; members'
    5-D inputs included."""
    rs = np.random.RandomState(0)

    def t(*shape, dtype=torch.float32):
        return torch.tensor(rs.randn(*shape).astype(np.float32)).to(dtype)

    cases = [
        (torch.ops.nodems.conv3x3_same, (t(2, 6, 6, 5), t(3, 3, 5, 4))),
        (torch.ops.nodems.conv3x3_same,
         (t(2, 3, 6, 6, 5), t(2, 3, 3, 5, 4))),
        (torch.ops.nodems.group_norm_act,
         (t(2, 5, 5, 8), t(8), t(8), 4, 1e-5, "relu")),
        (torch.ops.nodems.group_norm_act,
         (t(2, 3, 5, 5, 8), t(2, 8), t(2, 8), 4, 1e-5, None)),
        (torch.ops.nodems.ode_block_rk2,
         (t(2, 6, 6, 4, dtype=torch.bfloat16),
          t(3, 3, 4, 4, dtype=torch.bfloat16) * 0.1,
          t(3, 3, 4, 4, dtype=torch.bfloat16) * 0.1, 0.5, 2)),
    ]
    for op, args in cases:
        torch.library.opcheck(op, args)


def test_regimes_that_draw_on_the_host_refuse_to_export(tmp_path):
    """The switch regime draws its branch at each forward: JAX's export
    raises without a PRNG key, and so does the port's, instead of baking
    one draw into the graph."""
    from neural_ode_metasolver_tpu.models.api import build_model as j_build
    from neural_ode_metasolver_tpu.ops import (
        SolverOptions as JSolverOptions,
        parse_solver_dsl as j_parse,
    )
    from neural_ode_metasolver_tpu.serving import export_model as j_export

    j_model = j_build("mnist", dim=8)
    params, state = j_model.init(jax.random.key(0))
    j_solvers = j_parse(SOLVERS) + j_parse("rk2,u,8,-1,1.0,-1")
    with pytest.raises(ValueError, match="needs a PRNG key"):
        j_export(str(tmp_path / "j"), j_model, params, state, j_solvers,
                 JSolverOptions(solver_mode="switch"),
                 input_shape=(1, 28, 28, 1))
    solvers = parse_solver_dsl(SOLVERS) + parse_solver_dsl(
        "rk2,u,8,-1,1.0,-1")
    for mode in ("switch", "ensemble"):
        with pytest.raises(ValueError, match="needs a PRNG key"):
            export_model(str(tmp_path / mode), _mnist(dim=8), solvers,
                         SolverOptions(solver_mode=mode),
                         input_shape=(1, 28, 28, 1))


def test_load_moves_an_artifact_of_another_device(artifact, tmp_path,
                                                  monkeypatch):
    """An artifact whose platforms name another device type goes through
    move_to_device_pass onto the requested device; without a card and
    without "cpu" loading raises, as every entry point does."""
    from torch.export import passes

    path, live = artifact
    other = tmp_path / "other"
    other.mkdir()
    (other / "model.pt2").write_bytes(
        open(os.path.join(path, "model.pt2"), "rb").read())
    with open(os.path.join(path, "config.json")) as f:
        cfg = json.load(f)
    cfg["platforms"] = ["cuda"]
    (other / "config.json").write_text(json.dumps(cfg))
    moved = []

    def spy(program, location):
        moved.append(torch.device(location))
        return move(program, location)

    move = passes.move_to_device_pass
    monkeypatch.setattr(passes, "move_to_device_pass", spy)
    served = load_model(str(other), "cpu")
    assert moved == [torch.device("cpu")]
    x = _images(2, (28, 28, 1), 6)
    np.testing.assert_allclose(served(x).numpy(), live(x).numpy(),
                               atol=1e-5, rtol=1e-5)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            load_model(path)


def test_loading_needs_no_model_code(artifact):
    """A fresh interpreter loads and serves the artifact importing the
    port's serving module alone: no models package, no JAX."""
    path, live = artifact
    x = _images(2, (28, 28, 1), 7)
    code = (
        "import sys, numpy as np, torch\n"
        "from neural_ode_metasolver_tpu_torch.serving import load_model\n"
        f"y = load_model({path!r}, 'cpu')(np.load(sys.argv[1]))\n"
        "np.save(sys.argv[2], y.numpy())\n"
        "bad = [m for m in sys.modules if m.startswith(("
        "'neural_ode_metasolver_tpu_torch.models', 'jax'))]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    xin, yout = path + "_x.npy", path + "_y.npy"
    np.save(xin, x)
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", code, xin, yout], env=env,
                          cwd=REPO, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    np.testing.assert_allclose(np.load(yout), live(x).numpy(), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.skipif(not os.path.isdir(CKPT),
                    reason="shipped artifact not present")
def test_exported_shipped_model_matches_the_jax_artifact(tmp_path):
    """The shipped checkpoint, restored through JAX and carried into the
    port, exported and loaded: within 1e-4 of JAX's shipped StableHLO
    artifact on 64 digits images (tests/test_shipped_artifact.py's bar)."""
    from neural_ode_metasolver_tpu.data import load_digits_dataset
    from neural_ode_metasolver_tpu.models.api import build_model as j_build
    from neural_ode_metasolver_tpu.serving import load_model as j_load
    from neural_ode_metasolver_tpu.training import (
        create_train_state,
        make_optimizer,
        restore_checkpoint,
    )

    j_model = j_build("mnist", dim=64)
    tx = make_optimizer("rmsprop", 1e-3, weight_decay=5e-4)
    target = jax.eval_shape(lambda k: create_train_state(j_model, tx, k),
                            jax.random.key(0))
    cpu = jax.sharding.SingleDeviceSharding(jax.devices("cpu")[0])
    target = jax.tree_util.tree_map(
        lambda s: jax.ShapeDtypeStruct(s.shape, s.dtype, sharding=cpu),
        target)
    ts, cfg = restore_checkpoint(CKPT, target)
    model = build_model("mnist", device="cpu", dim=64)
    model.load_state_dict(mnist_params_from_jax(
        jax.tree_util.tree_map(np.asarray, ts.params)))
    path = str(tmp_path / "served")
    export_model(path, model, parse_solver_dsl(cfg["solvers"]),
                 SolverOptions(), input_shape=(1, 28, 28, 1), config=cfg)
    served = load_model(path, "cpu")
    assert served.config["pgd_robust_acc"] > 0.7

    _, test_ds = load_digits_dataset(seed=0)
    x = test_ds.images[:64]
    ref = np.asarray(j_load(SERVED)(jnp.asarray(x)))
    np.testing.assert_allclose(served(x).numpy(), ref, atol=1e-4,
                               rtol=1e-4)
