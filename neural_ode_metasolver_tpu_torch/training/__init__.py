"""Adversarial training of the port (mirrors the JAX ``training``)."""
from .optimizers import SGD, make_optimizer
from .schedules import constant_lr, cyclic_lr, cyclic_momentum
from .train import (
    AttackConfig,
    LossConfig,
    NoiseConfig,
    TrainState,
    create_train_state,
    make_train_step,
)

__all__ = [
    "AttackConfig",
    "LossConfig",
    "NoiseConfig",
    "SGD",
    "TrainState",
    "constant_lr",
    "create_train_state",
    "cyclic_lr",
    "cyclic_momentum",
    "make_optimizer",
    "make_train_step",
]
