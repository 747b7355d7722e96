"""The CIFAR runner over a ``model``, ``sp`` or ``pp`` mesh axis, as two
gloo ranks on the CPU, against one process.

Each scenario launches ``cifar_runner --mesh data=1,<axis>=2
--coordinator ... --num_hosts 2 --process_id r`` (a custom deep stack,
``--num_blocks "1,2;1,2"``, so every ODE stack pipelines under pp), then
resumes it for one more epoch in the same process group; rank 0 alone
writes ``metrics.jsonl`` and the checkpoints, which hold the global tree
(the tp slices gathered).  The test process runs the same flags with no
mesh, with the same resume.  Losses and the final checkpoint's params
must agree (as
``tests/test_torch_parallel_dp.py::test_runner_cli_two_process_matches_single``
holds the data axis).  This file is its own worker
(``tests/torch_mesh.py``).
"""
import json
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_mesh import REPO, free_port, launch  # noqa: E402

if REPO not in sys.path:
    sys.path.insert(0, REPO)

ARGV = ["--network", "premetanode10", "--in_planes", "4", "--num_blocks",
        "1,2;1,2", "--solvers", "rk2,u,1,-1,0.5,-1", "--batch_size", "8",
        "--test_batch_size", "8", "--synthetic_train_size", "32",
        "--synthetic_test_size", "8", "--device", "cpu", "--prefetch", "0",
        "--adv_testing_mode", "fgsm"]
AXES = ["model", "sp", "pp"]


def _result(save_dir):
    """The losses rank 0 logged and the last checkpoint's params."""
    from neural_ode_metasolver_tpu_torch.models import build_model
    from neural_ode_metasolver_tpu_torch.runners.common import (
        optimizer_from_saved_args)
    from neural_ode_metasolver_tpu_torch.training import (
        create_train_state, load_checkpoint_config, restore_checkpoint)

    last = os.path.join(save_dir, "last")
    cfg = load_checkpoint_config(last)
    model = build_model("premetanode10", device="cpu", in_planes=4,
                        num_blocks=((1, 2), (1, 2)))
    ts, _ = restore_checkpoint(last, create_train_state(
        model, optimizer_from_saved_args(cfg["args"])))
    with open(os.path.join(save_dir, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    return {"losses": [r["train_loss"] for r in recs if "train_loss" in r],
            "evals": [(r["epoch"], k, r[k]) for r in recs for k in (
                "best_standalone_0", "adv_test_acc") if k in r],
            "step": ts.step, "params": {k: v.detach().clone()
                                        for k, v in ts.params.items()},
            "steps": sorted(os.listdir(last))}


def worker(port, world, rank, axis, save_dir, out_path):
    torch.set_num_threads(1)
    from neural_ode_metasolver_tpu_torch.runners import cifar_runner

    mesh = ["--mesh", f"data=1,{axis}=2", "--save_dir", save_dir]
    cifar_runner.main(ARGV + mesh + ["--nepochs", "1", "--coordinator",
                                     f"localhost:{port}", "--num_hosts",
                                     str(world), "--process_id", str(rank)])
    # the group stays formed: the resume runs on it
    ts = cifar_runner.main(ARGV + mesh + ["--nepochs", "1", "--resume"])
    if rank == 0:
        torch.save({"step": ts.step, **_result(save_dir)}, out_path)
    torch.distributed.destroy_process_group()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from neural_ode_metasolver_tpu_torch.runners import cifar_runner

    torch.set_num_threads(1)
    tmp = tmp_path_factory.mktemp("runners")
    one = str(tmp / "one")
    cifar_runner.main(ARGV + ["--nepochs", "1", "--save_dir", one])
    cifar_runner.main(ARGV + ["--nepochs", "1", "--save_dir", one,
                              "--resume"])
    out = {"one": _result(one)}
    argvs = []
    for axis in AXES:
        port = free_port()
        argvs += [[__file__, "worker", str(port), "2", str(r), axis,
                   str(tmp / axis), str(tmp / f"{axis}.pt")]
                  for r in range(2)]
    launch(argvs)
    for axis in AXES:
        out[axis] = torch.load(str(tmp / f"{axis}.pt"), weights_only=False)
    return out


@pytest.mark.parametrize("axis", AXES)
def test_runner_cli_two_process_matches_single(runs, axis):
    """Two ranks on ``data=1,<axis>=2``: one epoch, a resume for a second
    (the global checkpoint resharded): the same two epoch losses and final
    params as one process without a mesh, the same validation and FGSM
    test accuracies, and one checkpoint a save."""
    one, two = runs["one"], runs[axis]
    assert two["step"] == one["step"] > 0
    np.testing.assert_allclose(two["losses"], one["losses"], rtol=1e-5)
    assert len(two["losses"]) == 2
    assert two["steps"] == one["steps"]
    # validation and the FGSM test on the same axis count what one does
    assert two["evals"] == one["evals"] and len(one["evals"]) == 4
    for k, v in one["params"].items():
        assert two["params"][k].shape == v.shape, k
        np.testing.assert_allclose(two["params"][k].numpy(), v.numpy(),
                                   atol=2e-6, rtol=1e-5, err_msg=k)


if __name__ == "__main__" and sys.argv[1] == "worker":
    worker(sys.argv[2], int(sys.argv[3]), int(sys.argv[4]), *sys.argv[5:8])
