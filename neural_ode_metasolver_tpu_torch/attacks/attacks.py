"""Adversarial attacks as functions of a forward closure (port of
attacks/attacks.py; reference MegaAdversarial/src/attacks).

An attack takes ``forward: x_normalized -> logits`` (already bound to the
parameters and solvers) and returns the attacked, normalized input,
detached.  The input gradient is ``torch.autograd.grad`` of the mean
cross-entropy with respect to the perturbation only, inside the span
``train.backward`` (``backend.span``).

Ported: ``cross_entropy``, ``normalize``/``inv_normalize``, ``clean``,
``fgsm`` (one signed step in pixel space, fgsm.py:21-43), ``fgsm_random``
(FGSM with a random start in normalized space, per-channel eps/alpha and
box scaled by the dataset std, fgsm.py:54-106: the flagship CIFAR recipe)
``pgd`` (pgd.py:23-57: optional uniform start in the eps-box, n_iter
signed steps, each clipped to the eps-box and to [0, 1]; the MNIST recipe),
and the ensemble attacks: ``clean2ensemble`` (base.py:8-10) and
``fgsm2ensemble`` (fgsm.py:109-155), one signed step in pixel space on the
NLL of the log of the members' mean softmax, whose core is
``fgsm_mean_prob_attack``.

A fleet (``training/fleet.py``) attacks S members at once: its forward
returns logits (S, N, classes) for x (S, N, ...), the loss is the sum of
the members' mean cross-entropies (so each member's input gradient is its
own run's), and the random start is drawn member by member from a list of
generators, each exactly as a single run draws it.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from ..backend import span
from ..parallel.mesh import GlobalDraws

Forward = Callable[[torch.Tensor], torch.Tensor]

__all__ = ["cross_entropy", "member_cross_entropy", "normalize",
           "inv_normalize", "clean", "clean2ensemble", "fgsm", "fgsm_random",
           "pgd", "fgsm2ensemble", "fgsm_mean_prob_attack", "uniform_like"]


def member_cross_entropy(logits: torch.Tensor, y: torch.Tensor
                         ) -> torch.Tensor:
    """A fleet's per-member mean CE: logits (S, N, K), y (S, N) -> (S,)."""
    s, n, k = logits.shape
    return F.cross_entropy(logits.reshape(s * n, k), y.reshape(s * n),
                           reduction="none").reshape(s, n).mean(1)


def cross_entropy(logits: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Mean CE over the batch (torch nn.CrossEntropyLoss default); a
    fleet's (S, N, K) logits give the sum of the members' means."""
    if logits.dim() == 3:
        return member_cross_entropy(logits, y).sum()
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


def uniform_like(x: torch.Tensor, generator) -> torch.Tensor:
    """U[0, 1) of x's shape, dtype and device (the attack's random start;
    tests pin it here).  A list of generators draws member m's slice
    x[m] from generator m; a ``GlobalDraws`` draws the global batch and
    keeps this rank's rows (and, under an sp axis, its rows of the
    height)."""
    if isinstance(generator, GlobalDraws):
        return generator.draw(
            lambda shape: torch.rand(shape, generator=generator.generator,
                                     dtype=x.dtype, device=x.device),
            x.shape)
    if isinstance(generator, (list, tuple)):
        return torch.stack([torch.rand(x.shape[1:], generator=g,
                                       dtype=x.dtype, device=x.device)
                            for g in generator])
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
        with span("train.backward"):
            (grad,) = torch.autograd.grad(loss, delta)
    delta = torch.clamp(delta.detach() + alpha_c * torch.sign(grad),
                        -eps_c, eps_c)
    delta = torch.clamp(delta, lo, hi)
    return x + delta, y


def _input_grad(forward: Forward, x: torch.Tensor, y: torch.Tensor
                ) -> torch.Tensor:
    """d mean-CE(forward(x), y) / dx, with grad mode on whatever the
    caller's mode (an eval harness may run under no_grad)."""
    x = x.detach().requires_grad_(True)
    with torch.enable_grad():
        loss = cross_entropy(forward(x), y)
        with span("train.backward"):
            (grad,) = torch.autograd.grad(loss, x)
    return grad


def fgsm(forward: Forward, x: torch.Tensor, y: torch.Tensor, eps: float,
         mean=None, std=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single-step FGSM in pixel space (fgsm.py:21-43): x01 + eps *
    sign(grad), clipped to [0, 1], normalized again."""
    x01 = inv_normalize(x.detach(), mean, std)
    grad = _input_grad(lambda z: forward(normalize(z, mean, std)), x01, y)
    x_adv = torch.clamp(x01 + eps * torch.sign(grad), 0.0, 1.0)
    return normalize(x_adv, mean, std), y


def pgd(forward: Forward, generator: Optional[torch.Generator],
        x: torch.Tensor, y: torch.Tensor, eps: float, lr: float,
        n_iter: int, randomized_start: bool = True, mean=None, std=None,
        per_iteration: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Projected gradient descent (pgd.py:23-57) in pixel space.

    The start is x01, or with ``randomized_start`` x01 + U(-eps, eps)
    clipped to [0, 1], drawn on x's device from ``generator``.  Each of the
    ``n_iter`` steps adds lr * sign(grad) and clips to x01 +- eps and to
    [0, 1]; the result is normalized again.  With ``per_iteration``
    ``forward`` is called as ``forward(x, i)`` at iteration i: the hook
    through which switch and ensemble draw anew on every attack forward
    (the JAX ``fwd_key``; standalone draws nothing)."""
    x01 = inv_normalize(x.detach(), mean, std)
    xa = x01
    if randomized_start:
        if generator is None:
            raise ValueError("pgd with randomized_start needs a generator")
        u = uniform_like(x01, generator)
        xa = torch.clamp(x01 + (2.0 * eps * u - eps), 0.0, 1.0)
    for i in range(n_iter):
        call = ((lambda z, i=i: forward(normalize(z, mean, std), i))
                if per_iteration else
                (lambda z: forward(normalize(z, mean, std))))
        grad = _input_grad(call, xa, y)
        xa = torch.clamp(xa + lr * torch.sign(grad), x01 - eps, x01 + eps)
        xa = torch.clamp(xa, 0.0, 1.0)
    return normalize(xa, mean, std), y


def clean2ensemble(x: torch.Tensor, y: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """No-op ensemble attack (base.py:8-10)."""
    return x, y


def fgsm_mean_prob_attack(mean_probs_fn: Forward, x: torch.Tensor,
                          y: torch.Tensor, eps: float, mean=None, std=None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One signed step in pixel space on the mean NLL of
    ``log(mean_probs_fn(x_normalized))`` (fgsm.py:121-155), clipped to
    [0, 1], normalized again and detached."""
    x01 = inv_normalize(x.detach(), mean, std)

    def nll(z):
        logp = torch.log(mean_probs_fn(normalize(z, mean, std)))
        return -logp.gather(-1, y[:, None]).mean()

    x01 = x01.requires_grad_(True)
    with torch.enable_grad():
        loss = nll(x01)
        with span("train.backward"):
            (grad,) = torch.autograd.grad(loss, x01)
    x_adv = torch.clamp(x01.detach() + eps * torch.sign(grad), 0.0, 1.0)
    return normalize(x_adv, mean, std), y


def fgsm2ensemble(forwards: Sequence[Forward], x: torch.Tensor,
                  y: torch.Tensor, eps: float, mean=None, std=None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """FGSM against a softmax-averaged ensemble (fgsm.py:109-155): each of
    ``forwards`` is one member's closure."""

    def mean_probs(xn):
        probs = None
        for fwd in forwards:
            p = torch.softmax(fwd(xn), dim=-1)
            probs = p if probs is None else probs + p
        return probs / len(forwards)

    return fgsm_mean_prob_attack(mean_probs, x, y, eps, mean, std)
