"""The plain float32 reference of a training run's first steps: the
solver-smoothing draw, the attack (clean or FGSM with a random start), the
forward, mean cross-entropy, the gradients by autograd and the optimizer
update, step after step from given weights, batches and the run's step
seed.  It returns what the benchmark compares: each step's loss, the first
step's gradient as the optimizer received it, and every parameter's
change over the steps.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch

from . import common


def train_steps(family, cfg: dict, recipe: dict,
                weights: Dict[str, torch.Tensor],
                batches: Sequence[Tuple[torch.Tensor, torch.Tensor]],
                step_seed: int, u0: float, precision: str = "f32",
                half_batch: bool = False) -> dict:
    """Run ``len(batches)`` steps of ``recipe`` on ``family`` (a reference
    module) from ``weights`` (not modified).  ``step_seed`` seeds the CPU
    generator the step's own seeds are drawn from; ``u0`` is the solver's
    u before smoothing.  ``half_batch`` (a planted fault) trains on the
    first half of every batch.  Returns ``{"losses": [...], "grads":
    {name: g}, "change": {name: dp}}``."""
    params = {k: v.detach().clone().float().requires_grad_(True)
              for k, v in weights.items()}
    start = {k: v.detach().clone() for k, v in params.items()}
    opt = recipe["optimizer"]
    attack = recipe.get("attack")
    noise = recipe.get("noise")
    act = recipe["activation"]
    gen = torch.Generator().manual_seed(int(step_seed))
    state: dict = {}
    losses: List[float] = []
    first = None
    with common.precision_flags(precision):
        for i, (x, y) in enumerate(batches):
            if half_batch:
                x, y = x[: x.shape[0] // 2], y[: y.shape[0] // 2]
            s_noise, s_attack, _ = common.step_seeds(gen)
            u = u0
            if noise:
                u = common.smoothed_u(s_noise, u0, noise["sigma"],
                                      noise["prob"], noise["type"])
            if attack:
                frozen = {k: v.detach() for k, v in params.items()}
                x = common.fgsm_random(
                    lambda xi: common.cross_entropy(family.forward(
                        cfg, frozen, xi, u, act, precision), y),
                    x, s_attack, attack["eps"], attack["alpha"],
                    cfg["normalization"]["mean"],
                    cfg["normalization"]["std"]).detach()
            loss = common.cross_entropy(
                family.forward(cfg, params, x, u, act, precision), y)
            grads = torch.autograd.grad(loss, list(params.values()))
            got = common.optimizer_step(opt, {k: p.data for k, p in
                                              params.items()},
                                        dict(zip(params, grads)), state, i)
            losses.append(loss.item())
            if first is None:
                first = got
    return {"losses": losses, "grads": first,
            "change": {k: (p.detach() - start[k]) for k, p in params.items()}}
