"""MNIST demo on the PyTorch port: build the MetaNODE and evaluate clean and
PGD robust accuracy -- the port's counterpart of
``examples/mnist_build_and_evaluate.py`` (the script form of the reference's
``examples/mnist/Build the model.ipynb`` + ``Evaluate the model.ipynb``:
an rk4,u3 solver, PGD eps=0.3, lr=2/255, 7 iterations).

    python examples/torch/mnist_build_and_evaluate.py \\
        --checkpoint examples/checkpoints/mnist_digits_smoothing_torch
    python examples/torch/mnist_build_and_evaluate.py --device cpu

It runs on the CUDA card unless ``--device cpu`` is given, and raises
without a card.  ``--checkpoint`` takes a checkpoint of the port
(``training/checkpoint.py``; the shipped JAX checkpoint is carried over by
``scripts/convert_shipped_mnist_checkpoint.py``); without one the model is
a random init.  ``--data_root`` reads MNIST from disk; without it the
images are synthetic.  The last line printed is a JSON record of the run
(with the kernels' launches: none on the CPU).
"""
import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

import torch

from neural_ode_metasolver_tpu_torch import launch_counts, resolve_device
from neural_ode_metasolver_tpu_torch.data import (
    batch_iterator,
    load_mnist,
    synthetic_dataset,
)
from neural_ode_metasolver_tpu_torch.models import build_model
from neural_ode_metasolver_tpu_torch.ops import SolverOptions, create_solver
from neural_ode_metasolver_tpu_torch.runners.common import (
    optimizer_from_saved_args,
)
from neural_ode_metasolver_tpu_torch.training import (
    AttackConfig,
    accuracy,
    adversarial_accuracy,
    create_train_state,
    load_checkpoint_config,
    restore_checkpoint,
    sn_test,
)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--checkpoint", type=str, default=None)
    p.add_argument("--data_root", type=str, default=None)
    p.add_argument("--batch_size", type=int, default=256)
    p.add_argument("--n_steps", type=int, default=8)
    p.add_argument("--n_eval", type=int, default=512)
    p.add_argument("--device", type=str, default=None,
                   help="'cpu' for the CPU; the default is the CUDA card")
    args = p.parse_args(argv)
    t0 = time.perf_counter()
    device = resolve_device(args.device)

    cfg = (load_checkpoint_config(args.checkpoint) or {}
           if args.checkpoint else {})
    model = build_model("mnist", device=device, dim=int(cfg.get("dim", 64)))
    if args.checkpoint:
        # the saved optimizer flags shape the state the checkpoint holds
        template = create_train_state(
            model, optimizer_from_saved_args(cfg.get("args", {})))
        restore_checkpoint(args.checkpoint, template)
        print(f"loaded checkpoint {args.checkpoint}")
    else:
        print("random init (pass --checkpoint for trained weights)")

    if args.data_root:
        ds = load_mnist(args.data_root, train=False)
    else:
        ds = synthetic_dataset(args.n_eval, (28, 28, 1), seed=1)

    def data():
        return batch_iterator(ds, args.batch_size, shuffle=False)

    # rk4 'u3' solver as in the reference notebook
    solver = create_solver("rk4", "u3", n_steps=args.n_steps, u0=1 / 3)
    opts = SolverOptions()

    acc = accuracy(model, [solver], opts, data())
    pgd = AttackConfig(mode="at", eps=0.3, pgd_lr=2 / 255, pgd_niter=7)
    adv = adversarial_accuracy(model, [solver], opts, data(), pgd,
                               torch.Generator().manual_seed(0))
    print(f"clean acc {acc}   PGD(0.3, 2/255, 7) acc {adv}")

    # step-count sweep (sn_test, the pkl-table generator)
    steps = [1, 2, 4, 8]
    accs = sn_test(model, solver, opts, data, nsteps_grid=steps)
    print(f"sn_test steps {steps}: {accs}")
    print(json.dumps({"example": "mnist", "device": str(device),
                      "clean_acc": acc, "pgd_acc": adv,
                      "sn_test": dict(zip(steps, accs)),
                      "launches": launch_counts(),
                      "seconds": time.perf_counter() - t0}))


if __name__ == "__main__":
    main()
