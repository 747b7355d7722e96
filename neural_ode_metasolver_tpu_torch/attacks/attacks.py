"""Adversarial attacks as functions of a forward closure (port of
attacks/attacks.py; reference MegaAdversarial/src/attacks).

An attack takes ``forward: x_normalized -> logits`` (already bound to the
parameters and solvers) and returns the attacked, normalized input,
detached.  The input gradient is ``torch.autograd.grad`` of the mean
cross-entropy with respect to the perturbation only.

Ported: ``cross_entropy``, ``normalize``/``inv_normalize``, ``clean`` and
``fgsm_random`` (FGSM with a random start in normalized space, per-channel
eps/alpha and box scaled by the dataset std, fgsm.py:54-106: the flagship
CIFAR recipe).  ``fgsm``, ``pgd`` and the ensemble attacks land with
ROADMAP A9 and raise until then.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F

Forward = Callable[[torch.Tensor], torch.Tensor]

__all__ = ["cross_entropy", "normalize", "inv_normalize", "clean",
           "clean2ensemble", "fgsm", "fgsm_random", "pgd", "fgsm2ensemble",
           "fgsm_mean_prob_attack", "uniform_like"]


def cross_entropy(logits: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Mean CE over the batch (torch nn.CrossEntropyLoss default)."""
    return F.cross_entropy(logits, y)


def _mean_std(mean, std, x: torch.Tensor):
    c = x.shape[-1]
    mean = (0.0,) * c if mean is None else mean
    std = (1.0,) * c if std is None else std
    m = torch.tensor(mean, dtype=x.dtype, device=x.device).reshape(1, 1, 1, -1)
    s = torch.tensor(std, dtype=x.dtype, device=x.device).reshape(1, 1, 1, -1)
    return m, s


def normalize(x01: torch.Tensor, mean=None, std=None) -> torch.Tensor:
    m, s = _mean_std(mean, std, x01)
    return (x01 - m) / s


def inv_normalize(x: torch.Tensor, mean=None, std=None) -> torch.Tensor:
    m, s = _mean_std(mean, std, x)
    return x * s + m


def clean(x: torch.Tensor, y: torch.Tensor
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """No-op attack (base.py:4-6) for uniform code paths."""
    return x, y


def uniform_like(x: torch.Tensor, generator: Optional[torch.Generator]
                 ) -> torch.Tensor:
    """U[0, 1) of x's shape, dtype and device (the attack's random start;
    tests pin it here)."""
    return torch.rand(x.shape, generator=generator, dtype=x.dtype,
                      device=x.device)


def fgsm_random(forward: Forward, generator: Optional[torch.Generator],
                x: torch.Tensor, y: torch.Tensor, epsilon: float,
                alpha: float, mean=None, std=None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """FGSM with random init, in normalized space (fgsm.py:54-106).

    With dataset mean/std given, eps/alpha and the valid box are
    per-channel scaled (:73-81); otherwise the box is [0, 1].  The uniform
    start is drawn on x's device from ``generator``."""
    if mean is not None and std is not None:
        m, s = _mean_std(mean, std, x)
        lower, upper = (0.0 - m) / s, (1.0 - m) / s
        eps_c, alpha_c = epsilon / s, alpha / s
    else:
        lower, upper = 0.0, 1.0
        eps_c = torch.tensor(epsilon, dtype=x.dtype, device=x.device)
        alpha_c = torch.tensor(alpha, dtype=x.dtype, device=x.device)
    x = x.detach()
    lo, hi = lower - x, upper - x
    # delta = eps - 2 eps U[0,1)  == Uniform(-eps, eps]  (fgsm.py:93)
    u = uniform_like(x, generator)
    delta = torch.clamp(eps_c - (2.0 * eps_c) * u, lo, hi)
    delta.requires_grad_(True)
    with torch.enable_grad():
        loss = cross_entropy(forward(x + delta), y)
        (grad,) = torch.autograd.grad(loss, delta)
    delta = torch.clamp(delta.detach() + alpha_c * torch.sign(grad),
                        -eps_c, eps_c)
    delta = torch.clamp(delta, lo, hi)
    return x + delta, y


def _not_ported(name: str):
    def attack(*args, **kwargs):
        raise NotImplementedError(
            f"attack {name!r} is not ported yet (ROADMAP A9)")

    attack.__name__ = name
    return attack


clean2ensemble = _not_ported("clean2ensemble")
fgsm = _not_ported("fgsm")
pgd = _not_ported("pgd")
fgsm2ensemble = _not_ported("fgsm2ensemble")
fgsm_mean_prob_attack = _not_ported("fgsm_mean_prob_attack")
