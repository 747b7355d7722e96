"""CIFAR-10 train+attack CLI (port of runners/cifar_runner.py; flag parity
with examples/cifar10/train_and_attack.py, the flagship experiment driver).

Flagship reproduction, on the card:
  python -m neural_ode_metasolver_tpu_torch.runners.cifar_runner \
      --network premetanode10 --solvers "rk2,u,8,-1,0.5,-1" \
      --adv_training_mode fgsm_random --noise_type normal \
      --noise_sigma 0.0125 --noise_prob 1.0 --nepochs 36 \
      --precision bf16 --data_root /path/to/cifar  # or omit: synthetic

A GroupNorm net, and a BatchNorm + spectral-norm net with the
orthogonal init (the model state, BN's running statistics and SN's
vectors, is checkpointed with the step and restored by ``--resume``):
  ... --network metanode10 --normalization_resblock GN \
      --normalization_odeblock GN --normalization_bn1 GN --num_gn_groups 32
  ... --network premetanode10 --normalization_resblock BN \
      --normalization_bn1 BN --param_normalization_resblock SN \
      --param_normalization_odeblock SN --init orthogonal

``--device cpu`` runs the plain PyTorch versions on the CPU; without a card
and without it the run raises.  The flags are the JAX runner's; those the
port does not run raise (``runners/common.py::check_unported_flags``).
``--mesh data=-1`` with ``--coordinator``, ``--num_hosts`` and
``--process_id`` trains one run data-parallel over that many processes,
one device each; BatchNorm then normalizes with the global batch's
statistics.  A ``model``, ``sp`` or ``pp`` axis trains tensor parallel,
with the height sharded, or with the ODE-block stacks pipelined
(``--pp_microbatches``; e.g. ``--num_blocks "1,2;1,2" --mesh
data=1,pp=2``), over ranks of one host.
"""
from __future__ import annotations

import argparse
import os

import torch

from ..backend import resolve_device
from ..data import (
    CIFAR10_MEAN,
    CIFAR10_STD,
    batch_iterator,
    data_backend,
    load_cifar10,
    synthetic_dataset,
    train_val_split,
)
from ..data.download import ensure_dataset
from ..models.api import build_model
from ..ops import parse_solver_dsl
from ..training import cyclic_lr, cyclic_momentum, make_optimizer
from ..utils import count_parameters, fix_seeds, get_logger
from .common import (
    add_device_flag,
    add_multihost_flags,
    bool_flag,
    check_unported_flags,
    fit,
    parse_num_blocks,
    setup_multihost,
)

ACTIVATIONS = ["ReLU", "GeLU", "GeLUtanh", "GeLUpoly", "Softsign", "Tanh",
               "AF"]
NETWORKS = [
    "metanode34", "metanode18", "metanode10", "metanode6", "metanode4",
    "premetanode34", "premetanode18", "premetanode10", "premetanode6",
    "premetanode4",
]


def build_parser():
    p = argparse.ArgumentParser(description=__doc__)
    # architecture (train_and_attack.py:40-45, 161-182)
    p.add_argument("--is_odenet", type=bool_flag, default=True,
                   choices=[True, False])
    p.add_argument("--network", type=str, choices=NETWORKS,
                   default="premetanode10")
    p.add_argument("--in_planes", type=int, default=64)
    p.add_argument("--normalization_resblock", type=str, default="NF",
                   choices=["BN", "GN", "LN", "IN", "NF"])
    p.add_argument("--normalization_odeblock", type=str, default="NF",
                   choices=["BN", "GN", "LN", "IN", "NF"])
    p.add_argument("--normalization_bn1", type=str, default="NF",
                   choices=["BN", "GN", "LN", "IN", "NF"])
    p.add_argument("--num_gn_groups", type=int, default=32)
    p.add_argument("--param_normalization_resblock", type=str, default="PNF",
                   choices=["WN", "SN", "PNF"])
    p.add_argument("--param_normalization_odeblock", type=str, default="PNF",
                   choices=["WN", "SN", "PNF"])
    p.add_argument("--param_normalization_bn1", type=str, default="PNF",
                   choices=["WN", "SN", "PNF"])
    p.add_argument("--activation_resblock", type=str, default="GeLU",
                   choices=ACTIVATIONS)
    p.add_argument("--activation_odeblock", type=str, default="GeLU",
                   choices=ACTIVATIONS)
    p.add_argument("--activation_bn1", type=str, default="GeLU",
                   choices=ACTIVATIONS)
    p.add_argument("--init", type=str, default=None,
                   help="None, 'orthogonal' or 'xavier': re-initialize the "
                        "conv (and, orthogonal, the linear) kernels")
    # solver / regime (train_and_attack.py:48-79)
    p.add_argument("--solvers", type=str, default="rk2,u,8,-1,0.5,-1")
    p.add_argument("--solver_mode", type=str, default="standalone",
                   choices=["switch", "ensemble", "standalone"])
    p.add_argument("--val_solver_modes",
                   type=lambda s: s.strip().split(","),
                   default=["standalone"])
    p.add_argument("--switch_probs",
                   type=lambda s: [float(i) for i in s.split(",")],
                   default=None)
    p.add_argument("--ensemble_weights",
                   type=lambda s: [float(i) for i in s.split(",")],
                   default=None)
    p.add_argument("--ensemble_prob", type=float, default=1.0)
    p.add_argument("--noise_type", type=str, default=None,
                   choices=[None, "cauchy", "normal"])
    p.add_argument("--noise_sigma", type=float, default=0.001)
    p.add_argument("--noise_prob", type=float, default=0.0)
    p.add_argument("--minimize_rk2_error", type=bool_flag, default=False,
                   choices=[True, False])
    # training (train_and_attack.py:83-119)
    p.add_argument("--seed", type=int, default=602)
    p.add_argument("--nepochs", "--nepochs_nn", dest="nepochs", type=int,
                   default=36)
    p.add_argument("--data_aug", type=bool_flag, default=True,
                   choices=[True, False])
    p.add_argument("--batch_size", type=int, default=256)
    p.add_argument("--test_batch_size", type=int, default=256)
    p.add_argument("--val_perc", type=float, default=0.1)
    p.add_argument("--optim", type=str, default="sgd",
                   choices=["sgd", "rmsprop", "adam"])
    p.add_argument("--weight_decay", type=float, default=0.0005)
    p.add_argument("--momentum", type=float, default=0.9)
    p.add_argument("--cycle_momentum", type=bool_flag, default=True,
                   choices=[True, False],
                   help="cycle momentum 0.8<->0.9 inversely to the cyclic "
                        "lr, like the reference's CyclicLR "
                        "cycle_momentum=(optim != 'adam') "
                        "(train_and_attack.py:503-508) — applies to sgd "
                        "AND rmsprop (torch RMSprop has a momentum buffer "
                        "that CyclicLR drives)")
    p.add_argument("--base_momentum", type=float, default=0.8)
    p.add_argument("--max_momentum", type=float, default=0.9)
    p.add_argument("--zero_grad_every", type=int, default=1)
    p.add_argument("--base_lr", type=float, default=1e-7)
    p.add_argument("--max_lr", type=float, default=0.1)
    p.add_argument("--step_size_up", type=int, default=3186)
    p.add_argument("--cyclic_lr_mode", type=str, default="triangular2")
    p.add_argument("--grad_clipping_threshold", type=float, default=None)
    # adversarial (train_and_attack.py:130-158)
    p.add_argument("--data_noise_std", type=float, default=0.0)
    p.add_argument("--adv_training_mode", default="clean",
                   choices=["clean", "fgsm", "at", "fgsm_random"])
    p.add_argument("--eps_adv_training", type=float, default=8 / 255)
    p.add_argument("--fgsm_random_step_size_training", type=float,
                   default=10 / 255)
    p.add_argument("--pgd_lr_training", type=float, default=2 / 255)
    p.add_argument("--pgd_niter_training", type=int, default=7)
    p.add_argument("--ss_loss", type=bool_flag, default=False,
                   choices=[True, False])
    p.add_argument("--ss_loss_reg", type=float, default=0.1)
    p.add_argument("--adv_testing_mode", default="clean",
                   choices=["clean", "fgsm", "at"])
    p.add_argument("--eps_adv_testing", type=float, default=8 / 255)
    p.add_argument("--pgd_lr_testing", type=float, default=2 / 255)
    p.add_argument("--pgd_niter_testing", type=int, default=7)
    # io
    p.add_argument("--download", action="store_true",
                   help="fetch CIFAR-10 into --data_root (default data/) if "
                        "missing — the torchvision download=True analog")
    p.add_argument("--data_root", type=str, default=None)
    p.add_argument("--save_dir", type=str, default="./experiment_cifar")
    p.add_argument("--debug", action="store_true")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--integration_method", type=str, default="backprop",
                   choices=["backprop", "adjoint"],
                   help="gradient path through the ODE solve: backprop "
                   "through the RK steps, or the continuous adjoint")
    p.add_argument("--nan_backoff", type=float, default=None,
                   help="on non-finite grads: drop the update and dip the "
                   "effective step size by this factor (recovers over "
                   "subsequent finite steps)")
    p.add_argument("--skip_nonfinite", action="store_true",
                   help="skip (not apply) updates with non-finite "
                        "loss/grads; logs skipped_nonfinite metric")
    p.add_argument("--unroll", type=int, default=1,
                   help="the JAX scan's unroll factor; no effect in the "
                        "port, whose RK step loop is a Python loop")
    p.add_argument("--precision", type=str, default="f32",
                   choices=["f32", "bf16"],
                   help="compute precision (bf16 = mixed precision, the "
                        "apex-O1 analog; master params stay f32)")
    p.add_argument("--mesh", type=str, default=None,
                   help="device mesh over the process group, e.g. "
                        "'data=-1' (every rank), 'data=2,model=2' "
                        "(tensor parallelism), 'data=1,sp=2' (the "
                        "height sharded), 'data=1,pp=2' (GPipe over "
                        "the ODE-block stacks; CIFAR family)")
    p.add_argument("--pp_microbatches", type=int, default=0,
                   help="GPipe microbatches per step under --mesh pp= "
                        "(0 = the pp axis size); no effect without a pp "
                        "axis")
    p.add_argument("--num_blocks", type=str, default=None,
                   help="override the registry's per-stage (res,ode) "
                        "counts, e.g. '1,2;1,2' for two stages of one res "
                        "+ two ODE blocks")
    p.add_argument("--compiler_option", action="append", default=None,
                   metavar="NAME=VALUE",
                   help="an XLA compiler flag of the JAX runner; raises "
                        "(the port compiles no XLA program)")
    p.add_argument("--profile_dir", type=str, default=None,
                   help="write a torch.profiler Chrome trace of "
                        "steady-state steps 1-3 (epoch 0) into this dir")
    p.add_argument("--prefetch", type=int, default=2,
                   help="batches copied to the card ahead of the train "
                        "step (0 disables; overlaps the copy with compute)")
    p.add_argument("--synthetic_train_size", type=int, default=8192)
    p.add_argument("--synthetic_test_size", type=int, default=1024)
    add_multihost_flags(p)
    add_device_flag(p)
    return p


def parse_args(argv=None):
    return build_parser().parse_args(argv)


def build_cifar_model(margs: dict, device, seed: int = 0):
    """The CIFAR model of the runner args (or a sidecar's saved args),
    its weights drawn from ``seed`` and re-initialized by ``--init``."""
    nb_override = {}
    if margs.get("num_blocks"):
        nb_override["num_blocks"] = parse_num_blocks(margs["num_blocks"])
    return build_model(
        margs.get("network", "premetanode10"), device=device,
        generator=torch.Generator().manual_seed(seed),
        init_scheme=margs.get("init"),
        is_odenet=margs.get("is_odenet", True),
        in_planes=margs.get("in_planes", 64),
        **nb_override,
        norms=(margs.get("normalization_resblock", "NF"),
               margs.get("normalization_odeblock", "NF"),
               margs.get("normalization_bn1", "NF")),
        num_gn_groups=margs.get("num_gn_groups", 32),
        param_norms=(margs.get("param_normalization_resblock", "PNF"),
                     margs.get("param_normalization_odeblock", "PNF"),
                     margs.get("param_normalization_bn1", "PNF")),
        acts=(margs.get("activation_resblock", "GeLU"),
              margs.get("activation_odeblock", "GeLU"),
              margs.get("activation_bn1", "GeLU")),
    )


def main(argv=None):
    """Train, validate, attack and checkpoint; returns the final
    TrainState."""
    args = parse_args(argv)
    check_unported_flags(args)
    rank = setup_multihost(args)  # before any device use
    dev = resolve_device(args.device)
    fix_seeds(args.seed)
    logger = get_logger(
        os.path.join(args.save_dir,
                     "logs" if rank == 0 else f"logs_p{rank}"),
        debug=args.debug, name="cifar")
    logger.info(str(vars(args)))

    solvers = parse_solver_dsl(args.solvers)
    model = build_cifar_model(vars(args), dev, seed=args.seed)
    logger.info(f"Number of parameters: {count_parameters(model)}")

    args.data_mean = CIFAR10_MEAN
    args.data_std = CIFAR10_STD

    if args.download:
        fetched = ensure_dataset("cifar10", args.data_root)
        if fetched:
            args.data_root = fetched
    if args.data_root:
        full_train = load_cifar10(args.data_root, train=True)
        test_ds = load_cifar10(args.data_root, train=False)
    else:
        logger.warning("no --data_root: falling back to synthetic data")
        full_train = synthetic_dataset(args.synthetic_train_size, (32, 32, 3),
                                       seed=args.seed)
        test_ds = synthetic_dataset(args.synthetic_test_size, (32, 32, 3),
                                    seed=args.seed + 1)
    train_ds, val_ds = train_val_split(full_train, args.val_perc,
                                      seed=args.seed)

    backend = data_backend("auto")
    logger.info(f"data backend: {backend}")
    crop = 4 if args.data_aug else 0

    def train_data(epoch):
        return batch_iterator(
            train_ds, args.batch_size, seed=args.seed + epoch,
            crop_padding=crop, hflip=True,
            mean=CIFAR10_MEAN, std=CIFAR10_STD, backend=backend,
        )

    def eval_data():
        # drop_last=False: evaluate every sample (PARITY.md
        # eval-denominator note)
        return batch_iterator(
            val_ds, args.test_batch_size, shuffle=False, drop_last=False,
            mean=CIFAR10_MEAN, std=CIFAR10_STD, backend=backend,
        )

    def test_data():
        return batch_iterator(
            test_ds, args.test_batch_size, shuffle=False, drop_last=False,
            mean=CIFAR10_MEAN, std=CIFAR10_STD, backend=backend,
        )

    sched = cyclic_lr(args.base_lr, args.max_lr, args.step_size_up,
                      args.cyclic_lr_mode)
    momentum = args.momentum
    if args.optim in ("sgd", "rmsprop") and args.cycle_momentum:
        momentum = cyclic_momentum(
            args.step_size_up, args.cyclic_lr_mode,
            args.base_momentum, args.max_momentum,
        )
    tx = make_optimizer(
        args.optim, sched, momentum=momentum,
        weight_decay=args.weight_decay,
        grad_clip=args.grad_clipping_threshold,
        every_k=args.zero_grad_every,
        nonfinite_backoff=args.nan_backoff,
    )

    config = {"args": vars(args), "solvers": args.solvers,
              "model": args.network}
    return fit(model, solvers, tx, args, logger, train_data, eval_data,
               test_data_factory=test_data, config=config)


if __name__ == "__main__":
    main()
