"""Carry the shipped MNIST checkpoint over to the PyTorch port's format.

``examples/checkpoints/mnist_digits_smoothing`` is an orbax checkpoint of
the JAX package (the digits MetaNODE, dim 64, trained with RMSprop 1e-3
and weight decay 5e-4).  The port reads its own checkpoints
(``neural_ode_metasolver_tpu_torch/training/checkpoint.py``: ``torch.save``
of the TrainState and a ``config.json`` sidecar), and its machine may have
no orbax, so this script restores the JAX checkpoint and writes the same
step in the port's format, params and RMSprop state carried by
``mnist_params_from_jax`` / ``rmsprop_state_from_jax``, bit for bit:

    python scripts/convert_shipped_mnist_checkpoint.py \\
        [--src examples/checkpoints/mnist_digits_smoothing] \\
        [--dst examples/checkpoints/mnist_digits_smoothing_torch]

``tests/test_torch_examples.py`` holds the written params equal to the
JAX restore.  The sidecar keeps the JAX sidecar's keys and adds the
optimizer flags under ``"args"``, from which the port's restore paths
rebuild the optimizer (``runners.common.optimizer_from_saved_args``).
"""
import argparse
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

SHIPPED = os.path.join(REPO, "examples", "checkpoints",
                       "mnist_digits_smoothing")
CONVERTED = os.path.join(REPO, "examples", "checkpoints",
                         "mnist_digits_smoothing_torch")
# the recipe of scripts/digits_regimes_eval.py, which trained it
ARGS = {"optim": "rmsprop", "lr": 1e-3, "weight_decay": 5e-4}


def restore_jax(src):
    """The shipped TrainState (numpy leaves) and its sidecar."""
    import jax
    import numpy as np

    from neural_ode_metasolver_tpu.models.api import build_model
    from neural_ode_metasolver_tpu.training import (
        create_train_state,
        make_optimizer,
        restore_checkpoint,
    )

    model = build_model("mnist", dim=64)
    tx = make_optimizer(ARGS["optim"], ARGS["lr"],
                        weight_decay=ARGS["weight_decay"])
    target = jax.eval_shape(lambda k: create_train_state(model, tx, k),
                            jax.random.key(0))
    cpu = jax.sharding.SingleDeviceSharding(jax.devices("cpu")[0])
    target = jax.tree_util.tree_map(
        lambda s: jax.ShapeDtypeStruct(s.shape, s.dtype, sharding=cpu),
        target)
    ts, cfg = restore_checkpoint(src, target)
    return jax.tree_util.tree_map(np.asarray, ts), cfg


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--src", default=SHIPPED)
    p.add_argument("--dst", default=CONVERTED)
    args = p.parse_args(argv)
    import jax

    jax.config.update("jax_platforms", "cpu")
    from neural_ode_metasolver_tpu_torch.models import (
        build_model,
        mnist_params_from_jax,
        rmsprop_state_from_jax,
    )
    from neural_ode_metasolver_tpu_torch.training import (
        create_train_state,
        make_optimizer,
        save_checkpoint,
    )

    ts, cfg = restore_jax(args.src)
    step = int(ts.step)
    model = build_model("mnist", device="cpu", dim=int(cfg.get("dim", 64)))
    opt = make_optimizer(ARGS["optim"], ARGS["lr"],
                         weight_decay=ARGS["weight_decay"])
    state = create_train_state(model, opt, mnist_params_from_jax(ts.params),
                               rmsprop_state_from_jax(ts.opt_state, step),
                               step=step)
    config = dict(cfg or {}, args=ARGS,
                  converted_from=os.path.relpath(args.src, REPO))
    path = save_checkpoint(args.dst, state, config)
    print(json.dumps({"written": os.path.relpath(path, REPO),
                      "step": step}))


if __name__ == "__main__":
    main()
