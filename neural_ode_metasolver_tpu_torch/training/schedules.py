"""LR and momentum schedules with reference parity (port of
training/schedules.py).

Plain Python functions of the step count, evaluated on the host each step:
``cyclic_lr`` is torch.optim.lr_scheduler.CyclicLR ('triangular' /
'triangular2', step_size_down == step_size_up), the backbone of the flagship
CIFAR run (train_and_attack.py:104-108,503-508: base 1e-7, max 0.1,
step_size_up 3186, triangular2), and ``cyclic_momentum`` its
``cycle_momentum=True`` companion; ``learning_rate_with_decay`` is the
MNIST runner's piecewise-constant decay (runners/mnist_runner.py:222-226).
"""
from __future__ import annotations

import math
from typing import Callable, Sequence

__all__ = ["constant_lr", "cyclic_lr", "cyclic_momentum",
           "learning_rate_with_decay"]

Schedule = Callable[[int], float]


def constant_lr(lr: float) -> Schedule:
    return lambda step: float(lr)


def learning_rate_with_decay(
    lr0: float,
    batch_size: int,
    batches_per_epoch: int,
    batch_denom: int = 128,
    boundary_epochs: Sequence[int] = (60, 100, 140),
    decay_rates: Sequence[float] = (1.0, 0.1, 0.01, 0.001),
) -> Schedule:
    """Piecewise-constant decay on the iteration axis
    (odenet_mnist/utils.py:7-18): lr0 * batch_size / batch_denom times
    decay_rates[i], i the number of boundaries (batches_per_epoch *
    boundary_epochs) the step has reached."""
    if len(decay_rates) != len(boundary_epochs) + 1:
        raise ValueError(
            f"need len(boundary_epochs)+1 = {len(boundary_epochs) + 1} "
            f"decay_rates, got {len(decay_rates)}")
    initial = lr0 * batch_size / batch_denom
    boundaries = [batches_per_epoch * e for e in boundary_epochs]
    values = [initial * d for d in decay_rates]
    return lambda step: values[sum(step >= b for b in boundaries)]


def _cyclic_amplitude(step_size_up: int, mode: str) -> Schedule:
    """The shared CyclicLR triangle: amplitude(step) in [0, 1].

    cycle = floor(1 + step / (2 * s)),  x = |step/s - 2*cycle + 1|
    amplitude = max(0, 1-x) * scale(cycle)
    scale = 1 (triangular) or 1 / 2^(cycle-1) (triangular2).

    ``cyclic_lr`` and ``cyclic_momentum`` stay phase-locked (momentum cycles
    exactly inversely to the lr, as torch's cycle_momentum does) because
    both are built from this one triangle."""
    if mode not in ("triangular", "triangular2"):
        raise ValueError(f"unsupported CyclicLR mode {mode!r}")
    s = float(step_size_up)

    def amplitude(step: int) -> float:
        cycle = math.floor(1.0 + step / (2.0 * s))
        x = abs(step / s - 2.0 * cycle + 1.0)
        scale = 1.0 if mode == "triangular" else 1.0 / 2.0 ** (cycle - 1.0)
        return max(0.0, 1.0 - x) * scale

    return amplitude


def cyclic_lr(base_lr: float, max_lr: float, step_size_up: int,
              mode: str = "triangular2") -> Schedule:
    """lr = base + (max - base) * amplitude(step)."""
    amp = _cyclic_amplitude(step_size_up, mode)
    return lambda step: base_lr + (max_lr - base_lr) * amp(step)


def cyclic_momentum(step_size_up: int, mode: str = "triangular2",
                    base_momentum: float = 0.8, max_momentum: float = 0.9
                    ) -> Schedule:
    """momentum = max_m - (max_m - base_m) * amplitude(step): at its max
    when the lr is at its base, and the reverse."""
    amp = _cyclic_amplitude(step_size_up, mode)
    return lambda step: max_momentum - (max_momentum - base_momentum) * amp(
        step)
