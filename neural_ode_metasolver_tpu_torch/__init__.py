"""PyTorch/CUDA port of neural_ode_metasolver_tpu for one NVIDIA H100.

The JAX package beside it is the reference; this package imports ``torch``
and ``numpy`` (``scipy`` and ``sklearn`` lazily, in the SVHN and digits
readers), never ``jax`` and nothing of ``neural_ode_metasolver_tpu``.
Module names mirror the JAX package's.  Public functions keep its layouts:
NHWC activations, HWIO conv kernels.

It serves the flagship ``premetanode10`` forward and the MNIST MetaNODE,
builds every CIFAR net of the JAX registry (BN/GN/LN/IN norms, SN/WN, the
inits) with its model state (BN running statistics, SN vectors), trains
both families adversarially, measures clean, FGSM and PGD accuracy
and runs the four meta-solver regimes (standalone, switching, smoothing,
solver and model ensembling) with the reference's regime table and
step-count sweep, and has the reference's CLIs (``runners``: training with
checkpoints, resume and a metrics log, and the attack sweep; ``data``: the
readers and the batches, copied to the card ahead of the step), with
three hand-written CUDA kernels (``csrc/``) and their backward: B1,
the stride-1 3x3 conv (dgrad on B1, a wgrad kernel); B2, the RK2 solve of
a CIFAR ODE block (forward only); B3, GroupNorm fused with its activation
(a backward kernel).  Entry points run on the CUDA card unless the caller
passes ``device="cpu"``.
"""
from .backend import (launch_counts, record_spans, reset_launch_counts,
                      resolve_device, span)

__all__ = ["launch_counts", "reset_launch_counts", "resolve_device",
           "record_spans", "span"]
