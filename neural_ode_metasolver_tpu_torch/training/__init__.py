"""Adversarial training and evaluation of the port (mirrors the JAX
``training``)."""
from .evaluate import accuracy, adversarial_accuracy, make_adversarial_predict
from .optimizers import SGD, RMSprop, make_optimizer
from .schedules import (
    constant_lr,
    cyclic_lr,
    cyclic_momentum,
    learning_rate_with_decay,
)
from .train import (
    AttackConfig,
    LossConfig,
    NoiseConfig,
    TrainState,
    create_train_state,
    make_eval_step,
    make_train_step,
)

__all__ = [
    "AttackConfig",
    "LossConfig",
    "NoiseConfig",
    "RMSprop",
    "SGD",
    "TrainState",
    "accuracy",
    "adversarial_accuracy",
    "constant_lr",
    "create_train_state",
    "cyclic_lr",
    "cyclic_momentum",
    "learning_rate_with_decay",
    "make_adversarial_predict",
    "make_eval_step",
    "make_optimizer",
    "make_train_step",
]
