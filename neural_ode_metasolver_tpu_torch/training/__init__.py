"""Adversarial training and evaluation of the port (mirrors the JAX
``training``)."""
from .evaluate import (
    RegimeSpec,
    accuracy,
    accuracy_ensemble,
    adversarial_accuracy,
    adversarial_accuracy_ensemble,
    make_adversarial_predict,
    make_ensemble_attacked_probs,
    make_ensemble_probs,
    notebook_regime_grid,
    sn_test,
)
from .accuracy_tables import load_accuracy_table, save_accuracy_table
from .fleet import (
    create_fleet_state,
    fleet_generators,
    fleet_member,
    make_fleet_eval_step,
    make_fleet_train_step,
    stack_fleet_solvers,
    tile_fleet,
)
from .checkpoint import (
    latest_step,
    load_checkpoint_config,
    restore_checkpoint,
    save_checkpoint,
    wait_for_checkpoints,
)
from .logging import MetricsLogger
from .metrics import RunningAverageMeter, nfe_per_forward, nfe_per_solve
from .optimizers import SGD, Adam, Optimizer, RMSprop, make_optimizer
from .schedules import (
    constant_lr,
    cyclic_lr,
    cyclic_momentum,
    learning_rate_with_decay,
)
from .solver_training import (
    SolverTrainState,
    create_solver_train_state,
    make_solver_train_step,
    solvers_from_state,
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
    "Adam",
    "AttackConfig",
    "LossConfig",
    "MetricsLogger",
    "NoiseConfig",
    "Optimizer",
    "RMSprop",
    "RegimeSpec",
    "RunningAverageMeter",
    "SGD",
    "SolverTrainState",
    "TrainState",
    "accuracy",
    "accuracy_ensemble",
    "adversarial_accuracy",
    "adversarial_accuracy_ensemble",
    "constant_lr",
    "create_fleet_state",
    "create_solver_train_state",
    "create_train_state",
    "cyclic_lr",
    "cyclic_momentum",
    "fleet_generators",
    "fleet_member",
    "latest_step",
    "learning_rate_with_decay",
    "load_accuracy_table",
    "load_checkpoint_config",
    "make_adversarial_predict",
    "make_ensemble_attacked_probs",
    "make_ensemble_probs",
    "make_eval_step",
    "make_fleet_eval_step",
    "make_fleet_train_step",
    "make_optimizer",
    "make_solver_train_step",
    "make_train_step",
    "nfe_per_forward",
    "nfe_per_solve",
    "notebook_regime_grid",
    "restore_checkpoint",
    "save_accuracy_table",
    "save_checkpoint",
    "sn_test",
    "solvers_from_state",
    "stack_fleet_solvers",
    "tile_fleet",
    "wait_for_checkpoints",
]
