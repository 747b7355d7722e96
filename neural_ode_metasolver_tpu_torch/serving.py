"""Serving (port of serving.py's ``ServedModel``).

``ServedModel(model, solvers, solver_options, compute_dtype=None)`` is a
callable that answers one request: a batch of NHWC images of any size in,
f32 logits out, under ``torch.inference_mode()``, for either family (MNIST
or CIFAR), in eval mode: a CIFAR net with BN or SN reads its running
statistics and SN vectors from the model's buffers and never writes them.  The default computes in f32, the dtype of the shipped MNIST
artifact (``examples/checkpoints/mnist_digits_smoothing_served``), and in
full f32: no TF32, whatever the process flags (``Model.forward``).  With
``compute_dtype=torch.bfloat16`` it is the port of the JAX
``training/train.py::_cast_model``: the input is cast to bf16, each conv
casts its f32 weights to bf16 at the call, and the logits come back in f32.

StableHLO export and load (``export_model`` / ``load_model``) have no
counterpart in this slice; ``torch.export`` lands with ROADMAP A19.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from .ops.regimes import SolverOptions

__all__ = ["ServedModel"]


class ServedModel:
    """A model with its solvers bound in; call it like a function."""

    def __init__(self, model, solvers: Sequence, solver_options:
                 Optional[SolverOptions] = None,
                 compute_dtype: Optional[torch.dtype] = None):
        if compute_dtype not in (None, torch.float32, torch.bfloat16):
            raise ValueError(f"compute_dtype {compute_dtype} not supported")
        self.model = model.eval()
        self.solvers = list(solvers)
        self.solver_options = solver_options or SolverOptions()
        self.compute_dtype = compute_dtype

    @property
    def device(self) -> torch.device:
        return self.model.device

    def __call__(self, x) -> torch.Tensor:
        """(B, *model.input_shape) images (tensor or array, any device):
        (B, 28, 28, 1) for MNIST, (B, 32, 32, 3) for CIFAR -> (B,
        num_classes) f32 logits on the model's device."""
        with torch.inference_mode():
            x = torch.as_tensor(x, device=self.device)
            if x.dim() != 4 or tuple(x.shape[1:]) != self.model.input_shape:
                raise ValueError(f"images {tuple(x.shape)} are not (B, "
                                 f"{', '.join(map(str, self.model.input_shape))})")
            x = x.to(self.compute_dtype or torch.float32).contiguous()
            logits = self.model(x, self.solvers, self.solver_options)
            return logits.float()
