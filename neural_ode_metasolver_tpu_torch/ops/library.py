"""Kernels B1, B2, B3 and GeLUpoly as ``torch.library`` custom ops,
namespace ``nodems``, so that ``torch.export`` can trace the kernel path
(the ctypes launches of the wrappers cannot be traced):

  * ``nodems::conv3x3_same(x, w)``: kernel B1, ``ops/conv3x3.py``;
  * ``nodems::ode_block_rk2(y0, w1, w2, u, n_steps)``: kernel B2, the whole
    launch schedule of one solve, ``ops/ode_block.py``;
  * ``nodems::group_norm_act(x, scale, bias, groups, eps, act)``: kernel B3,
    ``ops/group_norm.py``;
  * ``nodems::gelu_poly(x)``: the GeLUpoly kernel, ``ops/gelu_poly.py``.

Each op's implementation is its wrapper's own no-grad path: the CUDA kernel
for CUDA tensors, counted in ``backend.py`` as the wrapper counts it, and the
plain version for CPU tensors.  Every launch plan (``conv3x3_f32_plan``,
B3's ``launch_plan``, B2's schedule) reads N, so it is chosen inside the
op, when the op runs, never in traced code: an exported graph with a
symbolic batch dimension picks each request's plan as the live path does.
The fake kernels give the output's shape and dtype only.  Member (5-D)
inputs go through the ops as through the wrappers.

The ops are defined on a ``torch.library.Library`` with one
``CompositeExplicitAutograd`` kernel each (the wrapper code, which takes the
device from its inputs): a loaded graph calls each op once a launch or a
solve, and this registration costs the host less a call than
``torch.library.custom_op``'s Python wrappers (PERF.md §6).  The wrappers
call an op only while ``torch.export`` traces (``backend.kernel_ops()``);
an eager call launches directly, because the dispatch still costs host
time that the host-bound steps would pay on each of their thousand
launches (PERF.md §6).  Both routes run the same launch code.  The training
paths (the ``autograd.Function``s and the backward kernels) are not ops: an
export is inference.

Importing ``neural_ode_metasolver_tpu_torch.ops`` registers the ops; an
exported program needs them registered before it is loaded
(``serving.load_model`` does so).
"""
from __future__ import annotations

import torch

from . import conv3x3, gelu_poly, group_norm, ode_block

__all__ = ["NAMESPACE"]

NAMESPACE = "nodems"

_LIB = torch.library.Library(NAMESPACE, "DEF")


def _define(schema: str, kernel, fake) -> None:
    name = schema.split("(")[0]
    _LIB.define(schema)
    _LIB.impl(name, kernel, "CompositeExplicitAutograd")
    torch.library.register_fake(f"{NAMESPACE}::{name}", fake, lib=_LIB)


# B1: x ([S,] N, H, W, Cin), w ([S,] 3, 3, Cin, Cout) -> ([S,] N, H, W,
# Cout) in x's dtype
_define("conv3x3_same(Tensor x, Tensor w) -> Tensor",
        lambda x, w: conv3x3._launch_conv(x, w, conv3x3.KERNEL_NAME),
        lambda x, w: x.new_empty(x.shape[:-1] + (w.shape[-1],)))
# B2: the RK2(u~) solve of n_steps steps from y0 (N, H, W, C)
_define("ode_block_rk2(Tensor y0, Tensor w1, Tensor w2, float u, "
        "int n_steps) -> Tensor",
        ode_block._solve,
        lambda y0, w1, w2, u, n_steps: y0.new_empty(y0.shape))
# B3: GroupNorm of ``groups`` groups, then ``act``; x's shape and dtype
_define("group_norm_act(Tensor x, Tensor scale, Tensor bias, int groups, "
        "float eps, str? act) -> Tensor",
        group_norm._forward,
        lambda x, scale, bias, groups, eps, act: x.new_empty(x.shape))
# GeLUpoly: x's shape and dtype
_define("gelu_poly(Tensor x) -> Tensor", gelu_poly._forward,
        lambda x: x.new_empty(x.shape))
