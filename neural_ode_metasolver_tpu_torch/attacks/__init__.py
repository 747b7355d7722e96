"""Adversarial attacks of the port (mirrors the JAX ``attacks``)."""
from .attacks import (
    clean,
    clean2ensemble,
    cross_entropy,
    fgsm,
    fgsm2ensemble,
    fgsm_mean_prob_attack,
    fgsm_random,
    inv_normalize,
    normalize,
    pgd,
)

__all__ = [
    "clean",
    "clean2ensemble",
    "cross_entropy",
    "fgsm",
    "fgsm2ensemble",
    "fgsm_mean_prob_attack",
    "fgsm_random",
    "inv_normalize",
    "normalize",
    "pgd",
]
