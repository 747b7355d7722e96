"""CIFAR-10 demo on the PyTorch port: build premetanode10 and evaluate it
under all four meta-solver regimes -- the port's counterpart of
``examples/cifar10_build_and_evaluate.py`` (the script form of the
reference's ``examples/cifar10/Build the model.ipynb`` + ``Evaluate the
model.ipynb``).

Regimes demonstrated (Evaluate nb cells 13-28):
  1. standalone          -- one 8-step RK2(u=0.5)
  2. solver switching    -- probs [0.6, 0.4] over u in {0.5, 1.0}
  3. solver ensembling   -- weights [0.6, 0.4]
  4. model ensembling    -- softmax-prob averaging over solvers noised with
                            Normal(std=0.2), attacked with ensemble-FGSM

    python examples/torch/cifar10_build_and_evaluate.py [--precision bf16]
    python examples/torch/cifar10_build_and_evaluate.py --device cpu \\
        --in_planes 8 --batch_size 8 --n_eval 16 --n_steps 2

It runs on the CUDA card unless ``--device cpu`` is given, and raises
without a card.  ``--checkpoint <dir>`` evaluates trained weights (a
``cifar_runner`` checkpoint of the port, e.g. ``<save_dir>/last``);
otherwise random init and synthetic data demonstrate the API end to end.
``--data_root`` reads CIFAR-10 from disk.  ``--precision bf16`` evaluates
in mixed precision (bf16 activations, f32 logits).  The last line printed
is a JSON record of the run (with the kernels' launches: none on the
CPU).
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
    CIFAR10_MEAN,
    CIFAR10_STD,
    batch_iterator,
    load_cifar10,
    synthetic_dataset,
)
from neural_ode_metasolver_tpu_torch.models import build_model
from neural_ode_metasolver_tpu_torch.ops import (
    SolverOptions,
    create_solver,
    solver_ensemble_by_noising,
)
from neural_ode_metasolver_tpu_torch.runners.common import (
    compute_dtype_of,
    optimizer_from_saved_args,
)
from neural_ode_metasolver_tpu_torch.training import (
    AttackConfig,
    accuracy,
    accuracy_ensemble,
    adversarial_accuracy,
    adversarial_accuracy_ensemble,
    create_train_state,
    load_checkpoint_config,
    make_adversarial_predict,
    make_eval_step,
    restore_checkpoint,
)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--checkpoint", type=str, default=None)
    p.add_argument("--data_root", type=str, default=None)
    p.add_argument("--in_planes", type=int, default=64)
    p.add_argument("--batch_size", type=int, default=256)
    p.add_argument("--eps", type=float, default=8 / 255)
    p.add_argument("--n_steps", type=int, default=8)
    p.add_argument("--n_eval", type=int, default=512)
    p.add_argument("--precision", type=str, default="f32",
                   choices=["f32", "bf16"])
    p.add_argument("--device", type=str, default=None,
                   help="'cpu' for the CPU; the default is the CUDA card")
    args = p.parse_args(argv)
    t0 = time.perf_counter()
    device = resolve_device(args.device)
    dtype = compute_dtype_of(args.precision)

    # --- Build the model (Build nb) -------------------------------------
    model = build_model("premetanode10", device=device,
                        in_planes=args.in_planes)
    if args.checkpoint:
        # the saved config determines the optimizer state's layout
        # (cycle_momentum / clipping / every_k / nan_backoff), so the
        # template optimizer is rebuilt from it
        cfg0 = load_checkpoint_config(args.checkpoint) or {}
        template = create_train_state(
            model, optimizer_from_saved_args(cfg0.get("args", {})))
        _, cfg = restore_checkpoint(args.checkpoint, template)
        print(f"loaded checkpoint (val acc {(cfg or {}).get('val_acc')})")
    else:
        print("random init (pass --checkpoint for trained weights)")

    if args.data_root:
        ds = load_cifar10(args.data_root, train=False)
    else:
        ds = synthetic_dataset(args.n_eval, (32, 32, 3), seed=1)

    def data():
        return batch_iterator(ds, args.batch_size, shuffle=False,
                              mean=CIFAR10_MEAN, std=CIFAR10_STD)

    fgsm = AttackConfig(mode="fgsm", eps=args.eps, mean=CIFAR10_MEAN,
                        std=CIFAR10_STD)
    rows = {}

    def evaluate(name, solvers, opts, clean_seed, adv_seed):
        clean_gen = (None if clean_seed is None
                     else torch.Generator().manual_seed(clean_seed))
        acc = accuracy(model, solvers, opts, data(), generator=clean_gen,
                       predict=make_eval_step(model, solvers, opts,
                                              compute_dtype=dtype))
        adv = adversarial_accuracy(
            model, solvers, opts, data(), fgsm,
            torch.Generator().manual_seed(adv_seed),
            predict=make_adversarial_predict(model, solvers, opts, fgsm,
                                             compute_dtype=dtype))
        rows[name] = {"clean": acc, "fgsm": adv}
        print(f"{name:22s}clean {acc}  fgsm {adv}", flush=True)

    # --- 1. standalone ---------------------------------------------------
    s05 = create_solver("rk2", "u", n_steps=args.n_steps, u0=0.5)
    evaluate("standalone", [s05], SolverOptions(), None, 0)

    # --- 2. solver switching --------------------------------------------
    s10 = create_solver("rk2", "u", n_steps=args.n_steps, u0=1.0)
    evaluate("switch [0.6,0.4]", [s05, s10],
             SolverOptions(solver_mode="switch", switch_probs=[0.6, 0.4]),
             1, 2)

    # --- 3. solver ensembling --------------------------------------------
    evaluate("solver ens [0.6,0.4]", [s05, s10],
             SolverOptions(solver_mode="ensemble", ensemble_prob=1.0,
                           ensemble_weights=[0.6, 0.4]), 3, 4)

    # --- 4. model ensembling (noised solvers, Evaluate nb cells 25-28) ---
    noised = solver_ensemble_by_noising(
        s05, torch.Generator().manual_seed(5), ensemble_size=2, std=0.2,
        noise_type="normal")
    members = [(model, [s], SolverOptions()) for s in noised]
    acc = accuracy_ensemble(members, data(), compute_dtype=dtype)
    adv = adversarial_accuracy_ensemble(
        members, data(), fgsm, torch.Generator().manual_seed(6),
        compute_dtype=dtype)
    rows["model ensembling"] = {"clean": acc, "fgsm": adv}
    print(f"{'model ensembling':22s}clean {acc}  fgsm {adv}")
    print(json.dumps({"example": "cifar10", "device": str(device),
                      "precision": args.precision, "regimes": rows,
                      "launches": launch_counts(),
                      "seconds": time.perf_counter() - t0}))


if __name__ == "__main__":
    main()
