"""Data parallelism of the PyTorch port on the CPU, against the JAX
package's mesh and against the port's own one-process runs.

Two processes form a gloo group on localhost and each runs the scenarios
below on its half of every global batch through
``make_parallel_train_step``; the test process runs the same scenarios with
no process group.  This file is its own worker: ``python
tests/test_torch_parallel_dp.py worker PORT WORLD RANK IN OUT``.  Workers
import no JAX and run one torch thread each.

Scenarios (one step each unless said): the MNIST MetaNODE at dim 16, SGD
with momentum, a clean step from JAX's init (the inputs of JAX's
``test_dp_matches_single_device``), then a PGD step with a random start,
solver smoothing, data noise and the ss-loss (every batch-sized draw made
at the global shape); a small premetanode10 with BatchNorm in every slot
under FGSM with a random start (BN's statistics inside the attack and the
training pass, the running statistics); a ``skip_nonfinite`` step with a
NaN in rank 1's rows; a trainable-u step (``make_solver_train_step``).
"""
import json
import os
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

DIM, B = 16, 32
LOSS_RTOL, P_ATOL, P_RTOL = 2e-5, 2e-5, 2e-4  # JAX's dp bars (:54)
BN_TOL = 1e-5


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def launch(argvs, timeout=300):
    """Run one process per argument list, together, with one torch thread
    each; raise with the log of one that failed."""
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1",
               MKL_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    procs = [subprocess.Popen([sys.executable] + argv, env=env,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, cwd=REPO)
             for argv in argvs]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0].decode())
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for argv, p, log in zip(argvs, procs, logs):
        assert p.returncode == 0, f"{argv}:\n{log[-3000:]}"
    return logs


# ------------------------------------------------------------- scenarios


def _mnist(params, dim=DIM):
    from neural_ode_metasolver_tpu_torch.models import build_model

    model = build_model("mnist", device="cpu", dim=dim)
    if params is not None:
        model.load_state_dict(params)
    return model


def _params(model):
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def run_scenarios(inputs, mesh=None):
    """Every scenario on ``inputs``; ``mesh`` (a data axis over the ranks)
    makes each step data-parallel on this rank's rows, None runs one
    process.  Returns {name: tensors}."""
    from neural_ode_metasolver_tpu_torch.ops import create_solver
    from neural_ode_metasolver_tpu_torch.parallel import (
        batch_sharding, make_parallel_train_step)
    from neural_ode_metasolver_tpu_torch.models import build_model
    from neural_ode_metasolver_tpu_torch.training import (
        AttackConfig, LossConfig, NoiseConfig, create_solver_train_state,
        create_train_state, make_optimizer, make_solver_train_step,
        make_train_step)

    torch.manual_seed(0)
    rows = (lambda t: t) if mesh is None else batch_sharding(mesh).local
    par = ((lambda step: step) if mesh is None else
           (lambda step: make_parallel_train_step(step, mesh)))
    solvers = [create_solver("rk2", "u", n_steps=2, u0=0.5)]
    x, y = torch.tensor(inputs["x"]), torch.tensor(inputs["y"])
    out = {}

    # MNIST: a clean step from JAX's init, then a PGD step with every draw
    model = _mnist(inputs["params"])
    opt = make_optimizer("sgd", 0.05, momentum=0.9)
    ts = create_train_state(model, opt)
    ts, m = par(make_train_step(model, opt, solvers))(
        ts, rows(x), rows(y), torch.Generator().manual_seed(5))
    out["clean"] = {"loss": m["loss"], "accuracy": m["accuracy"],
                    "grad_norm": m["grad_norm"], **_params(model)}
    pgd = make_train_step(
        model, opt, solvers,
        attack_cfg=AttackConfig(mode="at", eps=0.3, pgd_lr=0.05,
                                pgd_niter=1),
        noise_cfg=NoiseConfig(noise_type="normal", sigma=0.0125, prob=1.0),
        loss_cfg=LossConfig(ss_loss=True, data_noise_std=0.01))
    ts, m = par(pgd)(ts, rows(x), rows(y), torch.Generator().manual_seed(6))
    out["pgd"] = {"loss": m["loss"], "ss_loss": m["ss_loss"], **_params(model)}

    # a small premetanode10 with BatchNorm in every slot, FGSM random start
    cx, cy = torch.tensor(inputs["cx"]), torch.tensor(inputs["cy"])
    net = build_model("premetanode10", device="cpu", in_planes=8,
                      norms=("BN",) * 3,
                      generator=torch.Generator().manual_seed(3))
    opt = make_optimizer("sgd", 0.05, momentum=0.9)
    ts = create_train_state(net, opt)
    step = make_train_step(net, opt, solvers, attack_cfg=AttackConfig(
        mode="fgsm_random", eps=8 / 255, alpha=10 / 255))
    for i in range(2):
        ts, m = par(step)(ts, rows(cx), rows(cy),
                          torch.Generator().manual_seed(10 + i))
    out["bn"] = {"loss": m["loss"], **{
        k: v.detach().clone() for k, v in net.state_dict().items()}}

    # skip_nonfinite: a NaN in rank 1's rows skips the step everywhere
    model = _mnist(None, dim=8)
    before = _params(model)
    opt = make_optimizer("sgd", 0.05, momentum=0.9)
    ts = create_train_state(model, opt)
    xn = x.clone()
    xn[B - 3, 5, 5, 0] = float("nan")
    ts, m = par(make_train_step(model, opt, solvers, skip_nonfinite=True))(
        ts, rows(xn), rows(y), torch.Generator().manual_seed(7))
    out["skip"] = {"skipped": m["skipped_nonfinite"],
                   "unchanged": torch.tensor(float(all(
                       torch.equal(before[k], v)
                       for k, v in _params(model).items())))}

    # trainable u: u's gradient in the model's bucket
    model = _mnist(None, dim=8)
    opt, sopt = make_optimizer("sgd", 0.05), make_optimizer("sgd", 0.5)
    sts = create_solver_train_state(model, opt, sopt, solvers)
    step = make_solver_train_step(model, opt, sopt, solvers)
    sts, m = par(step)(sts, rows(x), rows(y),
                       torch.Generator().manual_seed(8))
    out["solver"] = {"loss": m["loss"], "u": m["solver0_u"],
                     **_params(model)}
    return out


def worker(port, world, rank, in_path, out_path):
    torch.set_num_threads(1)
    from neural_ode_metasolver_tpu_torch.data.prefetch import (
        prefetch_to_device)
    from neural_ode_metasolver_tpu_torch.parallel import (
        batch_sharding, host_local_batch_to_global, initialize_distributed,
        make_mesh, replicated)

    dev = initialize_distributed(f"localhost:{port}", world, rank,
                                 device="cpu")
    inputs = torch.load(in_path, weights_only=False)
    mesh = make_mesh({"data": -1})
    # the mesh's shapes, its rows and the global batch they make up
    shapes = {"fill": mesh.shape,
              "two_axes": make_mesh({"data": world, "ensemble": 1}).shape,
              "ensemble_axis": make_mesh({"ensemble": world,
                                          "data": 1}).shape}
    try:
        make_mesh({"data": world + 1})
        shapes["wrong_size"] = "no error"
    except ValueError as e:
        shapes["wrong_size"] = str(e)
    gx = torch.arange(8 * 3, dtype=torch.float32).reshape(8, 3)
    rule = batch_sharding(mesh)
    local = rule.local((gx, gx[:, 0].long()))
    via_prefetch = list(prefetch_to_device(iter([(gx, gx[:, 0])]), size=2,
                                           device=dev, sharding=rule))[0]
    slices = {"rows": [rule.rows(8).start, rule.rows(8).stop],
              "gathered": host_local_batch_to_global(local, mesh)[0],
              "prefetched": via_prefetch[0],
              "replicated": replicated(mesh).local(gx)}
    out = run_scenarios(inputs, mesh)
    torch.save({"shapes": shapes, "slices": slices, "scenarios": out,
                "backend": torch.distributed.get_backend()}, out_path)
    torch.distributed.destroy_process_group()


# ----------------------------------------------------------------- tests


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """JAX's dp step on its 8-device CPU mesh, the port's scenarios in one
    process and in two gloo ranks."""
    import jax
    import jax.numpy as jnp

    from neural_ode_metasolver_tpu.data import batch_iterator, \
        synthetic_dataset
    from neural_ode_metasolver_tpu.models.api import build_model as jbuild
    from neural_ode_metasolver_tpu.ops import SolverOptions as JOpts
    from neural_ode_metasolver_tpu.ops import create_solver as jsolver
    from neural_ode_metasolver_tpu.parallel import make_mesh as jmesh
    from neural_ode_metasolver_tpu.parallel import (
        make_parallel_train_step as jparallel)
    from neural_ode_metasolver_tpu.training import (
        create_train_state as jstate, make_optimizer as jopt,
        make_train_step as jstep)
    from neural_ode_metasolver_tpu_torch.models import mnist_params_from_jax

    tmp = tmp_path_factory.mktemp("dp")
    jmodel = jbuild("mnist", dim=DIM)
    tx = jopt("sgd", 0.05, momentum=0.9)
    jts = jstate(jmodel, tx, jax.random.key(0))
    ds = synthetic_dataset(B, (28, 28, 1), seed=0)
    x, y = next(iter(batch_iterator(ds, B, shuffle=False)))
    x, y = np.asarray(x, np.float32), np.asarray(y, np.int64)
    raw = jstep(jmodel, tx, [jsolver("rk2", "u", n_steps=2,
                                     u0=np.float32(0.5))], JOpts(),
                jit_compile=False, donate=False)
    mesh = jmesh({"data": 8})
    jts_dp, jm = jparallel(raw, mesh, jts, data_axis="data")(
        jts, jnp.asarray(x), jnp.asarray(y), jax.random.key(5))
    rs = np.random.RandomState(1)
    inputs = {"params": mnist_params_from_jax(jax.tree_util.tree_map(
                  np.asarray, jts.params)),
              "x": x, "y": y,
              "cx": rs.randn(16, 32, 32, 3).astype(np.float32),
              "cy": rs.randint(0, 10, 16).astype(np.int64)}
    in_path = str(tmp / "inputs.pt")
    torch.save(inputs, in_path)
    port = free_port()
    outs = [str(tmp / f"rank{r}.pt") for r in range(2)]
    t0 = time.perf_counter()
    launch([[__file__, "worker", str(port), "2", str(r), in_path, outs[r]]
            for r in range(2)])
    two_s = time.perf_counter() - t0
    torch.set_num_threads(1)
    one = run_scenarios(inputs)
    ranks = [torch.load(o, weights_only=False) for o in outs]
    jparams = mnist_params_from_jax(jax.tree_util.tree_map(
        np.asarray, jts_dp.params))
    return dict(one=one, ranks=ranks, jax_loss=float(jm["loss"]),
                jax_params=jparams, two_s=two_s)


def _close(a, b, atol=P_ATOL, rtol=P_RTOL, skip=("loss",)):
    for k in a:
        if k in skip:
            continue
        np.testing.assert_allclose(np.asarray(a[k]), np.asarray(b[k]),
                                   atol=atol, rtol=rtol, err_msg=k)


def test_make_mesh_shapes(runs):
    """Row-major axes over the ranks, -1 fills, a product other than the
    world size raises JAX's message; without a process group a mesh
    covers the one local device (mirrors JAX ``test_make_mesh_shapes``)."""
    from neural_ode_metasolver_tpu_torch.parallel import make_mesh

    for r in runs["ranks"]:
        assert r["backend"] == "gloo"
        assert r["shapes"]["fill"] == {"data": 2}
        assert r["shapes"]["two_axes"] == {"data": 2, "ensemble": 1}
        assert r["shapes"]["ensemble_axis"] == {"ensemble": 2, "data": 1}
        assert r["shapes"]["wrong_size"] == "mesh {'data': 3} != 2 devices"
    assert make_mesh({"data": -1}).shape == {"data": 1}
    with pytest.raises(ValueError, match=r"mesh \{'data': 2\} != 1 devices"):
        make_mesh({"data": 2})


def test_rank_slices_make_up_the_global_batch(runs):
    """Rank r keeps rows [4r, 4r+4) of 8; the gathered slices are the
    global batch; the prefetch's ``sharding=`` gives the same slice; the
    replicated rule keeps every row; a batch that does not split raises,
    never truncated (mirrors JAX ``:431``, ``:455`` and
    ``tests/test_prefetch.py::test_multihost_batches_rejects_indivisible_batch``)."""
    from neural_ode_metasolver_tpu_torch.parallel import Shard

    with pytest.raises(ValueError, match="does not split"):
        Shard("data", 2, 1).local(torch.zeros(7, 3))
    gx = torch.arange(8 * 3, dtype=torch.float32).reshape(8, 3)
    for r, res in enumerate(runs["ranks"]):
        s = res["slices"]
        assert s["rows"] == [4 * r, 4 * r + 4]
        assert torch.equal(s["gathered"], gx)
        assert torch.equal(s["prefetched"], gx[4 * r:4 * r + 4])
        assert torch.equal(s["replicated"], gx)


def test_dp_matches_single_device(runs):
    """The two-rank clean step against JAX's dp step on its 8-device mesh
    and against the port's one-process step, at JAX's bars; both ranks
    hold the same params (mirrors JAX ``test_dp_matches_single_device``)."""
    one = runs["one"]["clean"]
    for res in runs["ranks"]:
        two = res["scenarios"]["clean"]
        assert float(two["loss"]) == pytest.approx(runs["jax_loss"],
                                                   rel=LOSS_RTOL)
        assert float(two["loss"]) == pytest.approx(float(one["loss"]),
                                                   rel=LOSS_RTOL)
        assert float(two["accuracy"]) == float(one["accuracy"])
        _close(two, runs["jax_params"], skip=("loss", "accuracy",
                                              "grad_norm"))
        _close(two, one, skip=("loss", "accuracy"))
    a, b = (r["scenarios"]["clean"] for r in runs["ranks"])
    assert all(torch.equal(a[k], b[k]) for k in a)


def test_dp_global_draws_match_one_process(runs):
    """PGD's random start, the smoothing noise, the data noise and the
    ss-loss: two ranks reproduce one process's step."""
    one = runs["one"]["pgd"]
    for res in runs["ranks"]:
        two = res["scenarios"]["pgd"]
        for k in ("loss", "ss_loss"):
            assert float(two[k]) == pytest.approx(float(one[k]),
                                                  rel=LOSS_RTOL)
        _close(two, one, skip=("loss", "ss_loss"))


def test_dp_batch_norm_takes_the_global_statistics(runs):
    """premetanode10 with BN in every slot: the two ranks' params and
    running statistics after two FGSM-random steps equal one process's at
    1e-5 (BN's statistics are the global batch's in the attack's RHS, the
    training pass and the running variance's n)."""
    one = runs["one"]["bn"]
    for res in runs["ranks"]:
        two = res["scenarios"]["bn"]
        assert float(two["loss"]) == pytest.approx(float(one["loss"]),
                                                   abs=BN_TOL)
        assert any(k.endswith(".var") for k in two)
        _close(two, one, atol=BN_TOL, rtol=BN_TOL)


def test_dp_skip_nonfinite_skips_on_every_rank(runs):
    """A NaN in rank 1's rows: every rank skips and keeps its params, as
    the one process does."""
    assert float(runs["one"]["skip"]["skipped"]) == 1.0
    for res in runs["ranks"]:
        sk = res["scenarios"]["skip"]
        assert float(sk["skipped"]) == 1.0
        assert float(sk["unchanged"]) == 1.0


def test_dp_trainable_u(runs):
    """u's gradient goes through the model's all-reduce: u and the params
    after a joint step equal one process's."""
    one = runs["one"]["solver"]
    for res in runs["ranks"]:
        two = res["scenarios"]["solver"]
        assert float(two["loss"]) == pytest.approx(float(one["loss"]),
                                                   rel=LOSS_RTOL)
        assert float(two["u"]) != 0.5
        _close(two, one)


# ------------------------------------------------------- the runner CLI


def runner_worker(port, world, rank, save_dir, out_json):
    """``mnist_runner`` with JAX's two-process test flags (``--mesh
    data=-1``; with world > 1 the multi-host flags), then every rank
    restores the last checkpoint; rank 0 reads the losses."""
    torch.set_num_threads(1)
    from neural_ode_metasolver_tpu_torch.models import build_model
    from neural_ode_metasolver_tpu_torch.runners import mnist_runner
    from neural_ode_metasolver_tpu_torch.runners.common import (
        optimizer_from_saved_args)
    from neural_ode_metasolver_tpu_torch.training import (
        create_train_state, load_checkpoint_config, restore_checkpoint)

    argv = ["--solvers", "rk2,u,2,-1,0.5,-1", "--nepochs", "2",
            "--batch_size", "16", "--test_batch_size", "16",
            "--synthetic_train_size", "48", "--synthetic_test_size", "16",
            "--lr", "0.05", "--optim", "sgd", "--mesh", "data=-1",
            "--save_dir", save_dir, "--device", "cpu"]
    if world > 1:
        argv += ["--coordinator", f"localhost:{port}", "--num_hosts",
                 str(world), "--process_id", str(rank)]
    mnist_runner.main(argv)
    ws = (torch.distributed.get_world_size()
          if torch.distributed.is_initialized() else 1)
    last = os.path.join(save_dir, "last")
    cfg = load_checkpoint_config(last)
    model = build_model("mnist", device="cpu",
                        generator=torch.Generator().manual_seed(99))
    ts, _ = restore_checkpoint(last, create_train_state(
        model, optimizer_from_saved_args(cfg["args"])))
    flat = torch.cat([v.reshape(-1) for v in ts.params.values()])
    losses = None
    if rank == 0:
        with open(os.path.join(save_dir, "metrics.jsonl")) as f:
            recs = [json.loads(line) for line in f]
        losses = [r["train_loss"] for r in recs if "train_loss" in r]
    files = sorted(os.listdir(save_dir))
    with open(out_json, "w") as f:
        json.dump({"world": ws, "step": ts.step, "train_losses": losses,
                   "param_checksum": float(flat.double().sum()),
                   "param_head": flat[:32].tolist(), "files": files}, f)
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()


def test_runner_cli_two_process_matches_single(tmp_path):
    """The port's ``mnist_runner`` launched as two gloo ranks with
    ``--mesh data=-1 --coordinator ... --num_hosts 2 --process_id r
    --device cpu`` against one process with the same flags: per-epoch
    losses (abs 2e-5), the checkpoint's param checksum (rel 1e-5) and head
    (rtol 1e-4, atol 1e-6), JAX's bars; every rank restores the same
    checkpoint, rank 0 alone wrote it and ``metrics.jsonl`` (mirrors JAX
    ``:677``)."""
    port = free_port()
    outs = {tag: str(tmp_path / f"{tag}.json")
            for tag in ("single", "two0", "two1")}
    launch([[__file__, "runner", "0", "1", "0", str(tmp_path / "single"),
             outs["single"]]]
           + [[__file__, "runner", str(port), "2", str(r),
               str(tmp_path / "two"), outs[f"two{r}"]] for r in range(2)],
           timeout=480)
    single, two, two1 = (json.load(open(outs[t]))
                         for t in ("single", "two0", "two1"))
    assert (single["world"], two["world"], two1["world"]) == (1, 2, 2)
    assert two1["param_checksum"] == two["param_checksum"]
    assert two1["train_losses"] is None
    assert single["step"] == two["step"] == two1["step"] > 0
    assert len(two["train_losses"]) == len(single["train_losses"]) == 2
    for a, b in zip(two["train_losses"], single["train_losses"]):
        assert a == pytest.approx(b, abs=2e-5)
    assert two["param_checksum"] == pytest.approx(
        single["param_checksum"], rel=1e-5)
    np.testing.assert_allclose(two["param_head"], single["param_head"],
                               rtol=1e-4, atol=1e-6)
    assert "logs_p1" in two["files"] and "metrics.jsonl" in two["files"]


def test_multihost_flags_validation():
    """The multi-host flags exist on both runner CLIs; ``setup_multihost``
    is a no-op returning rank 0 for a single-host invocation and gives
    JAX's errors for the incomplete flag shapes and for a multi-host run
    without ``--mesh`` (mirrors JAX ``:736``)."""
    import argparse

    from neural_ode_metasolver_tpu_torch.runners import (cifar_runner,
                                                         mnist_runner)
    from neural_ode_metasolver_tpu_torch.runners.common import (
        setup_multihost)

    for mod in (mnist_runner, cifar_runner):
        args = mod.parse_args(["--solvers", "rk2,u,2,-1,0.5,-1"])
        for f in ("coordinator", "num_hosts", "process_id"):
            assert hasattr(args, f), (mod.__name__, f)
        assert setup_multihost(args) == 0
        assert not torch.distributed.is_initialized()
    ns = lambda **kw: argparse.Namespace(**{  # noqa: E731
        "coordinator": None, "num_hosts": None, "process_id": None,
        "mesh": None, "device": "cpu", **kw})
    with pytest.raises(ValueError, match="--mesh"):
        setup_multihost(ns(coordinator="localhost:1", num_hosts=2,
                           process_id=0))
    with pytest.raises(ValueError, match="given without --coordinator"):
        setup_multihost(ns(num_hosts=2, process_id=0, mesh="data=2"))
    with pytest.raises(ValueError, match="missing: --process_id"):
        setup_multihost(ns(coordinator="localhost:1", num_hosts=2,
                           mesh="data=2"))
    assert not torch.distributed.is_initialized()


def test_threaded_iterator_passthrough_order_and_identity():
    """``threaded_iterator`` yields the items themselves, in order, hands a
    producer's error to the consumer, and refuses a size below 1 (mirrors
    JAX ``tests/test_prefetch.py:126``)."""
    from neural_ode_metasolver_tpu_torch.data import threaded_iterator

    items = [(np.full((2,), i), i) for i in range(5)]
    out = list(threaded_iterator(iter(items), size=2))
    assert len(out) == len(items)
    assert all(a is b for a, b in zip(out, items))

    def failing():
        yield items[0]
        raise RuntimeError("producer failed")

    with pytest.raises(RuntimeError, match="producer failed"):
        list(threaded_iterator(failing(), size=2))
    with pytest.raises(ValueError):
        threaded_iterator(iter(items), size=0)


def test_backend_rule():
    """NCCL only when every rank owns a CUDA device of its own; gloo for
    CPU ranks and for ranks that share a card."""
    from neural_ode_metasolver_tpu_torch.parallel.mesh import choose_backend

    assert choose_backend([("h", "cuda:0"), ("h", "cuda:1")]) == "nccl"
    assert choose_backend([("a", "cuda:0"), ("b", "cuda:0")]) == "nccl"
    assert choose_backend([("h", "cuda:0")]) == "nccl"
    assert choose_backend([("h", "cuda:0"), ("h", "cuda:0")]) == "gloo"
    assert choose_backend([("h", "cpu"), ("h", "cpu")]) == "gloo"
    assert choose_backend([("h", "cuda:0"), ("h", "cpu")]) == "gloo"


if __name__ == "__main__" and sys.argv[1] == "worker":
    port_, world_, rank_, in_, out_ = sys.argv[2:7]
    worker(int(port_), int(world_), int(rank_), in_, out_)
if __name__ == "__main__" and sys.argv[1] == "runner":
    port_, world_, rank_, dir_, out_ = sys.argv[2:7]
    runner_worker(int(port_), int(world_), int(rank_), dir_, out_)
