"""Device resolution and kernel launch counters.

Entry points (``build_model``, ``ServedModel``) run on the CUDA card unless
the caller asks for the CPU with ``device="cpu"``; without a card and
without that request they raise instead of quietly running on the CPU.

Every kernel wrapper adds one to its counter here each time it launches its
CUDA kernel, and nowhere else, so a run can show that its main path went
through the kernels (``chip_smoke.py`` resets the counters, serves, reads
them).  The plain versions the wrappers take for CPU tensors count nothing.

``full_f32()`` pins f32 convs and matmuls to full f32 (no TF32) for the
duration of a call, whatever the process flags say.

``kernel_ops()`` says whether the kernel wrappers call their custom ops
(``ops/library.py``) rather than launch directly: only while
``torch.export`` traces.

``check_forward_only`` guards the wrapper of the forward-only kernel B2:
its outputs are fresh tensors with no ``grad_fn``, so where a gradient
could flow it raises instead of silently cutting it off.
"""
from __future__ import annotations

import contextlib
from collections import Counter
from typing import Dict, Iterator, Optional, Union

import torch

__all__ = [
    "resolve_device",
    "full_f32",
    "kernel_ops",
    "check_forward_only",
    "count_launch",
    "launch_counts",
    "reset_launch_counts",
]

_LAUNCHES: Counter = Counter()


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` means the CUDA card; raise when there is none.

    An explicit ``"cpu"`` is honoured; an explicit CUDA device without a
    card raises as well.
    """
    if device is None:
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions on the CPU"
        )
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device}")
    return device


@contextlib.contextmanager
def full_f32() -> Iterator[None]:
    """Turn TF32 off for cuDNN convs and cuBLAS matmuls, and restore the
    caller's flags on exit.  PyTorch's default lets cuDNN run f32 convs in
    TF32 (10-bit mantissa), which the JAX reference does not."""
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = cudnn.allow_tf32, matmul.allow_tf32
    cudnn.allow_tf32 = matmul.allow_tf32 = False
    try:
        yield
    finally:
        cudnn.allow_tf32, matmul.allow_tf32 = saved


def kernel_ops() -> bool:
    """Whether the wrappers of B1, B2 and B3 go through their
    ``torch.library`` ops (``ops/library.py``): while ``torch.export``
    traces, which cannot trace a ctypes launch.  Eager calls launch
    directly and skip the op's dispatch (PERF.md §6); both routes run the
    same launch code."""
    return torch.compiler.is_exporting()


def check_forward_only(what: str, **tensors: torch.Tensor) -> None:
    """Raise when grad mode is on and any of ``tensors`` requires grad: the
    kernel ``what`` has no backward and its output would be detached."""
    needs = [k for k, t in tensors.items() if t.requires_grad]
    if torch.is_grad_enabled() and needs:
        raise RuntimeError(
            f"{what} is a forward-only kernel, but {', '.join(needs)} "
            "requires grad: its output would be cut off from autograd. "
            "Run it under torch.no_grad() or take the differentiable path")


def count_launch(name: str) -> None:
    """Record one launch of kernel ``name`` (called by its wrapper only)."""
    _LAUNCHES[name] += 1


def launch_counts() -> Dict[str, int]:
    """A copy of the launch counters, by kernel name."""
    return dict(_LAUNCHES)


def reset_launch_counts() -> None:
    _LAUNCHES.clear()
