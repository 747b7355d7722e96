"""LR and momentum schedules with reference parity (port of
training/schedules.py).

Plain Python functions of the step count, evaluated on the host each step:
``cyclic_lr`` is torch.optim.lr_scheduler.CyclicLR ('triangular' /
'triangular2', step_size_down == step_size_up), the backbone of the flagship
CIFAR run (train_and_attack.py:104-108,503-508: base 1e-7, max 0.1,
step_size_up 3186, triangular2), and ``cyclic_momentum`` its
``cycle_momentum=True`` companion.  ``learning_rate_with_decay`` (the MNIST
boundary decay) lands with ROADMAP A14.
"""
from __future__ import annotations

import math
from typing import Callable

__all__ = ["constant_lr", "cyclic_lr", "cyclic_momentum"]

Schedule = Callable[[int], float]


def constant_lr(lr: float) -> Schedule:
    return lambda step: float(lr)


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
