"""Evaluation harness: clean and adversarial accuracy (port of
training/evaluate.py, ``accuracy``, ``make_adversarial_predict`` and
``adversarial_accuracy``).

Parity targets: ``accuracy`` odenet_mnist/metrics.py:9-24, normalized by
the number of samples, tail batch included (PARITY.md quirk 12);
``adversarial_accuracy`` train_and_attack.py:212-243: attack every batch
with the model in eval mode on detached weights, then a no-grad forward.

Each batch's argmax count stays on the model's device; the counts are read
back once, after the last batch, so batches are not held up by a readback
each.  ``data`` yields (x, y) pairs, numpy arrays or tensors, x (B, H, W, C)
normalized images and y (B,) integer labels.

Not ported yet: the ensemble evaluations and the regime grid (ROADMAP
A10), ``sn_test`` (A13 with A2's grids).
"""
from __future__ import annotations

from typing import Iterable, Optional, Sequence, Tuple

import torch

from ..backend import full_f32
from ..ops.regimes import SolverOptions
from .train import AttackConfig, _model_forward, _run_attack, make_eval_step

__all__ = ["accuracy", "make_adversarial_predict", "adversarial_accuracy"]

Batches = Iterable[Tuple[object, object]]


def _accumulate_accuracy(model, data: Batches, batch_scores) -> float:
    """The counting loop of every accuracy entry point: ``batch_scores(x,
    y)`` returns a batch's logits; the correct counts add up on the device
    and are read once."""
    dev = model.device
    counts = []
    total = 0
    for x, y in data:
        x = torch.as_tensor(x, device=dev)
        y = torch.as_tensor(y, device=dev).long()
        counts.append((batch_scores(x, y).argmax(-1) == y).sum())
        total += int(y.shape[0])
    correct = int(torch.stack(counts).sum()) if counts else 0
    return correct / max(total, 1)


def accuracy(model, solvers: Sequence, solver_options: SolverOptions,
             data: Batches, predict=None) -> float:
    """Clean accuracy of ``model`` over ``data``; ``predict`` (from
    ``make_eval_step``) may be passed in, else one is built."""
    if predict is None:
        predict = make_eval_step(model, solvers, solver_options)
    return _accumulate_accuracy(model, data, lambda x, y: predict(x))


def make_adversarial_predict(model, solvers: Sequence,
                             solver_options: SolverOptions,
                             attack_cfg: AttackConfig, *,
                             remat: bool = False, unroll: int = 1,
                             use_kernels: bool = True):
    """``attacked_logits(x, y, generator) -> logits``: the attack of
    ``attack_cfg`` (the train step's dispatch) through the model in eval
    mode on detached weights, with grad mode on for its input gradients,
    then the eval-mode forward of the attacked batch under
    ``torch.inference_mode()``.  ``generator`` seeds the attack's random
    start on x's device.  ``remat`` checkpoints the attack's RK steps;
    ``unroll`` is accepted and ignored."""
    del unroll
    forward = _model_forward(model, solver_options, use_kernels, None,
                             remat)

    def attacked_logits(x: torch.Tensor, y: torch.Tensor,
                        generator: Optional[torch.Generator]
                        ) -> torch.Tensor:
        frozen = model.detached_params()
        with full_f32(), torch.enable_grad():
            xa = _run_attack(lambda xi: forward(xi, solvers, False,
                                                frozen)[0],
                             attack_cfg, x, y, generator)
        with torch.inference_mode():
            return forward(xa, solvers, False)[0]

    return attacked_logits


def adversarial_accuracy(model, solvers: Sequence,
                         solver_options: SolverOptions, data: Batches,
                         attack_cfg: AttackConfig,
                         generator: torch.Generator, predict=None, *,
                         remat: bool = False, unroll: int = 1) -> float:
    """Accuracy on attacked batches (train_and_attack.py:212-243).  Each
    batch's attack draws from a generator on the model's device seeded
    from ``generator`` (a CPU generator the caller seeds), one seed a
    batch.  ``predict`` (from ``make_adversarial_predict``) may be passed
    in, else one is built with ``remat`` and ``unroll``."""
    if predict is None:
        predict = make_adversarial_predict(model, solvers, solver_options,
                                           attack_cfg, remat=remat,
                                           unroll=unroll)
    dev = model.device

    def batch_scores(x, y):
        seed = int(torch.randint(0, 2 ** 62, (), generator=generator))
        return predict(x, y, torch.Generator(device=dev).manual_seed(seed))

    return _accumulate_accuracy(model, data, batch_scores)
