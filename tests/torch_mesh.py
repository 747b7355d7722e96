"""Launching the port's gloo ranks on the CPU for the parallel tests.

A parallel test file is its own worker: the test process writes the inputs
with ``torch.save``, ``run_ranks`` starts one process a rank running
``python <test file> worker PORT WORLD RANK IN OUT``, and each rank writes
its results with ``torch.save``.  Workers import no JAX and run one torch
thread each.
"""
import os
import socket
import subprocess
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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


def run_ranks(test_file, world, inputs, tmp):
    """``world`` ranks of ``test_file``'s worker on ``inputs``; returns
    each rank's results in rank order."""
    in_path = os.path.join(str(tmp), "inputs.pt")
    torch.save(inputs, in_path)
    port = free_port()
    outs = [os.path.join(str(tmp), f"rank{r}.pt") for r in range(world)]
    launch([[test_file, "worker", str(port), str(world), str(r), in_path,
             outs[r]] for r in range(world)])
    return [torch.load(o, weights_only=False) for o in outs]


def worker_main(run):
    """The ``worker`` entry point: form the group, run ``run(inputs,
    world, rank)``, save what it returns."""
    port, world, rank, in_path, out_path = sys.argv[2:7]
    torch.set_num_threads(1)
    sys.path.insert(0, REPO)
    from neural_ode_metasolver_tpu_torch.parallel import (
        initialize_distributed)

    initialize_distributed(f"localhost:{port}", int(world), int(rank),
                           device="cpu")
    inputs = torch.load(in_path, weights_only=False)
    out = run(inputs, int(world), int(rank))
    torch.save(out, out_path)
    torch.distributed.destroy_process_group()


def b2_forward(x, mesh=None, kind=None):
    """The no-grad forward of a small exact-GELU NF premetanode10 (seed 7),
    whose ODE blocks go to B2: its logits and the shape of every input B2
    took.  ``kind`` "tp" runs it on this rank's output channels of
    ``mesh``'s model axis, "sp" on this rank's rows of its sp axis (x is
    this rank's rows of the data axis); None in one process."""
    from neural_ode_metasolver_tpu_torch.models import build_model
    from neural_ode_metasolver_tpu_torch.models import odenet_cifar10 as oc
    from neural_ode_metasolver_tpu_torch.ops import create_solver
    from neural_ode_metasolver_tpu_torch.parallel import shard_params_tp
    from neural_ode_metasolver_tpu_torch.parallel.mesh import (
        shard_state_tp, spatial_rows)
    from neural_ode_metasolver_tpu_torch.training import (
        create_train_state, make_optimizer)

    net = build_model("premetanode10", device="cpu", in_planes=8,
                      acts=("GeLU",) * 3,
                      generator=torch.Generator().manual_seed(7))
    solvers = [create_solver("rk2", "u", n_steps=2, u0=0.5)]
    sp = None
    if kind == "tp":
        ts = create_train_state(net, make_optimizer("sgd", 0.0))
        shard_state_tp(ts, shard_params_tp(ts.params, mesh, "model"))
    elif kind == "sp":
        sp = mesh.shard("sp")
        x = x[:, sp.rows(x.shape[1])]
    shapes, orig = [], oc.ode_block_rk2_forward

    def spy(y0, *a, **kw):
        shapes.append(tuple(y0.shape))
        return orig(y0, *a, **kw)

    oc.ode_block_rk2_forward = spy
    try:
        with torch.no_grad(), spatial_rows(sp):
            logits = net(x, solvers)
    finally:
        oc.ode_block_rk2_forward = orig
    return {"logits": logits, "b2_inputs": shapes}
