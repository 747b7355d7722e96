"""Kernel B3: GroupNorm (+ activation) over NHWC, with its backward.

Port of ``ops/pallas_kernels.py::fused_group_norm_act``: torch
``nn.GroupNorm(num_groups, C)`` parity (eps 1e-5, affine with f32 scale and
bias) followed by an activation, in one read of x.  Statistics are two-pass
in f32 (the Pallas kernel's one-pass E[x^2] - E[x]^2 is the same function,
less well conditioned); the activation is applied in f32 and the result
rounded once to x's dtype.

The CUDA kernel (``csrc/group_norm_act.cu``) runs the plan that
``launch_plan`` makes from a sample's shape alone, one block or one
thread-block cluster a sample:

- **register path**: the warps of one block own a whole sample.  Each thread
  reads its share once, with 16-byte loads along C, and keeps it in
  registers for the statistics and the normalize pass.  MNIST's 6x6 and
  13x13 GroupNorms take it.
- **cluster path**: a sample too large for one block's registers is cut into
  k <= 8 pixel slices, one per block of a thread-block cluster, each held in
  registers; the blocks' group sums meet in distributed shared memory.  x
  is still read once.  MNIST's 26x26 GroupNorm takes it.
- **re-reading path**: the same layouts, but each pass reads x again.  It
  takes samples too large even for 8 blocks, and every layout the two paths
  above cannot: x's pointer or C * itemsize not 16-byte aligned (one element
  at a time), or groups that warp shuffles cannot sum (a pixel's vectors do
  not divide a warp, or groups straddle vectors).

The register and cluster paths finish group sums by warp shuffles, the
re-reading path through shared memory; both add in a fixed order, so a
launch repeats its bits.  ``fused_group_norm_act`` launches the kernel for
CUDA tensors and takes the plain version, ``group_norm_reference``, only
for CPU tensors.

Where a gradient can flow, ``fused_group_norm_act`` is the apply of an
``autograd.Function`` whose backward is the JAX custom VJP (``_bwd``, jnp
there): ``group_norm_backward``, a hand-written kernel
(``csrc/group_norm_act_bwd.cu``, counted as ``group_norm_act_bwd``) on the
same kind of plan (``launch_plan(..., backward=True)``: at most 8 vectors
of x and 8 of dout a thread, since it holds both), and its plain version
``group_norm_backward_reference`` for CPU tensors.  It writes dx, and
dscale and dbias only where autograd asks for them: their per-block
partial sums are then added in a fixed order by a second kernel of the
same library (those launches are also counted as
``group_norm_act_bwd_params``), so two launches repeat their bits.
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from torch.autograd.function import once_differentiable

from .. import _build, backend

__all__ = ["fused_group_norm_act", "group_norm_reference",
           "group_norm_backward", "group_norm_backward_reference",
           "launch_plan", "GnPlan"]

KERNEL_NAME = "group_norm_act"
BWD_KERNEL_NAME = "group_norm_act_bwd"
BWD_PARAMS_NAME = "group_norm_act_bwd_params"

_ACTS = {
    None: lambda y: y,
    "relu": F.relu,
    "gelu": F.gelu,  # exact (erf)
    "tanh": torch.tanh,
    "softsign": F.softsign,
}
# codes of csrc/group_norm_act.cu
_ACT_CODES = {None: 0, "relu": 1, "gelu": 2, "tanh": 3, "softsign": 4}
_PATH_CODES = {"register": 0, "cluster": 1, "reread": 2}

MAX_THREADS = 256  # per block (kGnMaxThreads)
MAX_CLUSTER = 8  # the portable cluster size
SMEM_OPTIN = 232448  # the H100's opt-in shared memory per block
_ITEMSIZE = {torch.float32: 4, torch.bfloat16: 2}
# vectors a thread of the register and cluster paths holds: the kernel
# instances of csrc/group_norm_act.cu
_REGS = (4, 8, 16)
# the backward's (csrc/group_norm_act_bwd.cu): it holds x and dout
_BWD_REGS = (4, 8)
_ELEMS = 32  # elements a thread of the register path aims to hold


class GnPlan(NamedTuple):
    """How one launch covers the batch (see ``csrc/group_norm_act.cu``)."""
    path: str  # "register", "cluster" or "reread"
    vec: int  # elements a thread reads at once: 16 bytes' worth, or 1
    warps: int  # warps per block
    cluster: int  # blocks per sample
    regs: int  # vectors a thread holds in registers; 0 on "reread"
    smem_bytes: int  # dynamic shared memory per block


def _layout(c: int, vec: int, threads: int):
    """(vector columns of a pixel, columns side by side, rows at a time,
    columns a thread): ``gn_layout`` of the CUDA source."""
    vpp = c // vec
    if vpp <= threads:
        return vpp, vpp, threads // vpp, 1
    return vpp, threads, 1, -(-vpp // threads)


def _per_thread(hw: int, c: int, vec: int, threads: int, cluster: int) -> int:
    """The most vectors a thread of a block reads."""
    _, _, rows, ncols = _layout(c, vec, threads)
    return -(-(-(-hw // cluster)) // rows) * ncols


def access(c: int, groups: int, dtype: torch.dtype, aligned: bool = True):
    """(vec, shuffle): the elements a thread reads at once (16 bytes' worth
    where x's pointer and C allow, else 1), and whether warp shuffles can
    finish the group sums (16-byte access, a pixel's vector columns divide
    a warp, and groups align with vectors), which the register and cluster
    paths need."""
    size = _ITEMSIZE[dtype]
    vec = 16 // size if aligned and (c * size) % 16 == 0 else 1
    vpp, cg = c // vec, c // groups
    shuffle = (vec > 1 and vpp <= 32 and 32 % vpp == 0 and
               (vec % cg == 0 or (cg % vec == 0 and vpp % (cg // vec) == 0)))
    return vec, shuffle


def _smem_bytes(path: str, c: int, groups: int, vec: int, warps: int,
                cluster: int, backward: bool = False) -> int:
    """``gn_smem_bytes`` of the CUDA source (``gn_bwd_smem_bytes`` with
    ``backward``)."""
    if backward:
        rows = _layout(c, vec, 32 * warps)[2]
        stats = (rows * c + 4 * groups if path == "reread" else
                 2 * warps * groups + 2 * groups)
        return 4 * (stats + 2 * rows * c + 2 * c + 4 * groups)
    if path == "reread":
        rows = _layout(c, vec, 32 * warps)[2]
        return 4 * (rows * c + 4 * groups)
    if warps * cluster == 1:
        return 0
    return 4 * (2 * warps * groups + (2 * groups if cluster > 1 else 0))


def make_plan(path: str, vec: int, warps: int, cluster: int, regs: int,
              c: int, groups: int, backward: bool = False) -> GnPlan:
    """A plan with its shared-memory bytes for (c, groups)."""
    return GnPlan(path, vec, warps, cluster, regs,
                  _smem_bytes(path, c, groups, vec, warps, cluster,
                              backward))


@functools.lru_cache(maxsize=256)
def launch_plan(n: int, h: int, w: int, c: int, groups: int,
                dtype: torch.dtype, aligned: bool = True,
                backward: bool = False) -> GnPlan:
    """The launch that ``fused_group_norm_act`` makes for x (n, h, w, c) of
    ``dtype`` (f32 or bf16) in ``groups`` groups; ``aligned`` says whether
    x's data pointer is 16-byte aligned.  Every sample gets the same
    block or cluster, so n does not change the plan.  Raises ValueError for
    a shape the kernel cannot take (group statistics beyond a block's
    ``SMEM_OPTIN`` bytes of shared memory).  The rules below follow the
    timings of ``scripts/bench_group_norm_plans.py`` (PERF.md).

    ``backward=True`` plans ``group_norm_backward``'s launch by the same
    rules, with at most 8 vectors a thread (it holds x and dout) and its
    own shared memory."""
    menu = _BWD_REGS if backward else _REGS
    if c % groups:
        raise ValueError(f"channels ({c}) must be divisible by num_groups "
                         f"({groups})")
    vec, shuffle = access(c, groups, dtype, aligned)
    hw = h * w
    # a whole sample in one block: the fewest warps that leave a thread at
    # most 32 elements (a block's time is mostly its threads' serial work),
    # else 8 warps if they hold it in 16 vectors (the backward: 8)
    for warps in (1, 2, 4, 8):
        most = _per_thread(hw, c, vec, 32 * warps, 1)
        if most <= menu[-1] and (most * vec <= _ELEMS or warps == 8):
            regs = next(r for r in menu if r >= most)
            plan = (make_plan("register", vec, warps, 1, regs, c, groups,
                              backward)
                    if shuffle else
                    make_plan("reread", vec, warps, 1, 0, c, groups,
                              backward))
            break
    else:
        # slices of 8-warp blocks over a cluster: as few blocks as hold it
        # in 16 vectors a thread (the backward: 8; a cluster waits at each of its two
        # exchanges for its slowest block), else 8 blocks re-reading
        k = next((k for k in range(2, MAX_CLUSTER + 1)
                  if _per_thread(hw, c, vec, MAX_THREADS, k) <= menu[-1]),
                 None)
        plan = (make_plan("cluster", vec, 8, k, menu[-1], c, groups,
                          backward)
                if shuffle and k is not None else
                make_plan("reread", vec, 8, k or MAX_CLUSTER, 0, c, groups,
                          backward))
    if plan.smem_bytes > SMEM_OPTIN:
        raise ValueError(
            f"group norm: the statistics of {groups} groups of "
            f"{c // groups} channels need {plan.smem_bytes} bytes of shared "
            f"memory, more than the {SMEM_OPTIN} a block has")
    return plan


def _check_args(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                num_groups: int, act: Optional[str]) -> None:
    if x.dim() != 4:
        raise ValueError(f"group norm: x {tuple(x.shape)} is not (N,H,W,C)")
    c = x.shape[-1]
    if c % num_groups:
        raise ValueError(f"channels ({c}) must be divisible by num_groups "
                         f"({num_groups})")
    if tuple(scale.shape) != (c,) or tuple(bias.shape) != (c,):
        raise ValueError(f"group norm: scale {tuple(scale.shape)} and bias "
                         f"{tuple(bias.shape)} are not ({c},)")
    if act not in _ACTS:
        raise ValueError(f"unknown activation {act!r}")


def group_norm_reference(x: torch.Tensor, scale: torch.Tensor,
                         bias: torch.Tensor, num_groups: int,
                         eps: float = 1e-5, act: Optional[str] = None
                         ) -> torch.Tensor:
    """Plain version: two-pass f32 GroupNorm(+act) on NHWC, cast to x's
    dtype (the JAX ``group_norm_reference``)."""
    _check_args(x, scale, bias, num_groups, act)
    n, h, w, c = x.shape
    xf = x.float().reshape(n, h * w, num_groups, c // num_groups)
    mean = xf.mean(dim=(1, 3), keepdim=True)
    var = ((xf - mean) ** 2).mean(dim=(1, 3), keepdim=True)
    y = ((xf - mean) * torch.rsqrt(var + eps)).reshape(n, h, w, c)
    y = y * scale.float() + bias.float()
    return _ACTS[act](y).to(x.dtype)


def _act_vjp(act: Optional[str], y: torch.Tensor, g: torch.Tensor
             ) -> torch.Tensor:
    """g * act'(y) in f32 (the JAX ``_bwd``'s dpre; ReLU masks y > 0)."""
    if act is None:
        return g
    if act == "relu":
        return g * (y > 0)
    if act == "gelu":
        cdf = 0.5 * (1.0 + torch.erf(y * 0.7071067811865476))
        pdf = 0.3989422804014327 * torch.exp(-0.5 * y * y)
        return g * (cdf + y * pdf)
    if act == "tanh":
        return g * (1.0 - torch.tanh(y) ** 2)
    return g / (1.0 + y.abs()) ** 2  # softsign


def group_norm_backward_reference(x: torch.Tensor, scale: torch.Tensor,
                                  bias: torch.Tensor, dout: torch.Tensor,
                                  num_groups: int, eps: float = 1e-5,
                                  act: Optional[str] = None):
    """Plain version of the backward, the JAX custom VJP ``_bwd``
    (``ops/pallas_kernels.py``): recompute the two-pass f32 statistics,
    xhat and y; dpre = act'(y) * dout; dscale = sum(dpre * xhat), dbias =
    sum(dpre) over N, H, W in f32; dx = rstd * (dxhat - mean_g(dxhat) -
    xhat * mean_g(dxhat * xhat)), dxhat = dpre * scale, in x's dtype.
    Returns (dx, dscale, dbias)."""
    _check_args(x, scale, bias, num_groups, act)
    n, h, w, c = x.shape
    g, cg = num_groups, c // num_groups
    xf = x.float().reshape(n, h * w, g, cg)
    mean = xf.mean(dim=(1, 3), keepdim=True)
    var = ((xf - mean) ** 2).mean(dim=(1, 3), keepdim=True)
    rstd = torch.rsqrt(var + eps)
    xhat = ((xf - mean) * rstd).reshape(n, h, w, c)
    y = xhat * scale.float() + bias.float()
    dpre = _act_vjp(act, y, dout.float())
    dscale = (dpre * xhat).sum(dim=(0, 1, 2))
    dbias = dpre.sum(dim=(0, 1, 2))
    dxhat = (dpre * scale.float()).reshape(n, h * w, g, cg)
    xhat_g = xhat.reshape(n, h * w, g, cg)
    m1 = dxhat.mean(dim=(1, 3), keepdim=True)
    m2 = (dxhat * xhat_g).mean(dim=(1, 3), keepdim=True)
    dx = rstd * (dxhat - m1 - xhat_g * m2)
    return dx.reshape(n, h, w, c).to(x.dtype), dscale, dbias


def _launch(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
            num_groups: int, eps: float, act: Optional[str],
            plan: GnPlan) -> torch.Tensor:
    """Launch the kernel on checked CUDA tensors with ``plan``; the C entry
    point refuses a plan it cannot run."""
    n, h, w, c = x.shape
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    lib = _build.load("group_norm_act")
    err = lib.group_norm_act_launch(
        _build.DTYPE_CODES[x.dtype], _ACT_CODES[act], x.data_ptr(),
        scale.data_ptr(), bias.data_ptr(), out.data_ptr(), n, h * w, c,
        num_groups, float(eps), _PATH_CODES[plan.path], plan.vec,
        plan.warps, plan.cluster, plan.regs, x.device.index,
        _build.stream_handle(x),
    )
    _build.check(lib, err, f"group_norm_act launch ({plan})")
    backend.count_launch(KERNEL_NAME)
    return out


def _launch_bwd(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                dout: torch.Tensor, num_groups: int, eps: float,
                act: Optional[str], plan: GnPlan, params: bool):
    """The backward kernel on checked CUDA tensors with ``plan``: dx, and
    with ``params`` dscale and dbias (else None)."""
    n, h, w, c = x.shape
    dx = torch.empty_like(x)
    part = dscale = dbias = None
    if params:
        part = torch.empty((n * plan.cluster, 2, c), dtype=torch.float32,
                           device=x.device)
        dscale = torch.empty(c, dtype=torch.float32, device=x.device)
        dbias = torch.empty(c, dtype=torch.float32, device=x.device)
    ptr = lambda t: None if t is None else t.data_ptr()
    lib = _build.load("group_norm_act_bwd")
    err = lib.group_norm_act_bwd_launch(
        _build.DTYPE_CODES[x.dtype], _ACT_CODES[act], x.data_ptr(),
        dout.data_ptr(), scale.data_ptr(), bias.data_ptr(), dx.data_ptr(),
        ptr(part), ptr(dscale), ptr(dbias), n, h * w, c, num_groups,
        float(eps), _PATH_CODES[plan.path], plan.vec, plan.warps,
        plan.cluster, plan.regs, x.device.index, _build.stream_handle(x),
    )
    _build.check(lib, err, f"group_norm_act_bwd launch ({plan})")
    backend.count_launch(BWD_KERNEL_NAME)
    if params:
        backend.count_launch(BWD_PARAMS_NAME)
    return dx, dscale, dbias


def _check_cuda(what: str, x: torch.Tensor, scale: torch.Tensor,
                bias: torch.Tensor, **more: torch.Tensor) -> None:
    _build.check_cuda_tensors(what, x.dtype, x=x, **more)
    _build.check_cuda_tensors(what, torch.float32, scale=scale, bias=bias)
    if scale.device != x.device:
        raise ValueError(f"{what}: x on {x.device}, scale and bias on "
                         f"{scale.device}")


def _forward(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
             num_groups: int, eps: float, act: Optional[str]
             ) -> torch.Tensor:
    """The kernel for CUDA tensors, the plain version for CPU tensors."""
    if all(t.device.type == "cpu" for t in (x, scale, bias)):
        return group_norm_reference(x, scale, bias, num_groups, eps, act)
    _check_cuda("fused_group_norm_act", x, scale, bias)
    n, h, w, c = x.shape
    if x.numel() == 0:
        return torch.empty_like(x)
    plan = launch_plan(n, h, w, c, num_groups, x.dtype,
                       aligned=x.data_ptr() % 16 == 0)
    return _launch(x, scale, bias, num_groups, eps, act, plan)


def group_norm_backward(x: torch.Tensor, scale: torch.Tensor,
                        bias: torch.Tensor, dout: torch.Tensor,
                        num_groups: int, eps: float = 1e-5,
                        act: Optional[str] = None, params: bool = True):
    """The VJP of ``fused_group_norm_act`` at (x, scale, bias) for the
    output gradient ``dout`` (x's shape and dtype): (dx, dscale, dbias),
    the last two f32 (C,), or None without ``params``.  The backward kernel
    for CUDA tensors, ``group_norm_backward_reference`` for CPU tensors."""
    _check_args(x, scale, bias, num_groups, act)
    if tuple(dout.shape) != tuple(x.shape):
        raise ValueError(f"group norm backward: dout {tuple(dout.shape)} is "
                         f"not x's {tuple(x.shape)}")
    if all(t.device.type == "cpu" for t in (x, scale, bias, dout)):
        dx, dscale, dbias = group_norm_backward_reference(
            x, scale, bias, dout, num_groups, eps, act)
        return (dx, dscale, dbias) if params else (dx, None, None)
    _check_cuda("group_norm_backward", x, scale, bias, dout=dout)
    n, h, w, c = x.shape
    if x.numel() == 0:
        zeros = torch.zeros(c, dtype=torch.float32, device=x.device)
        return (torch.empty_like(x),) + ((zeros, zeros.clone()) if params
                                         else (None, None))
    plan = launch_plan(n, h, w, c, num_groups, x.dtype,
                       aligned=x.data_ptr() % 16 == 0
                       and dout.data_ptr() % 16 == 0, backward=True)
    return _launch_bwd(x, scale, bias, dout, num_groups, eps, act, plan,
                       params)


class _GroupNormAct(torch.autograd.Function):
    """Forward B3; backward ``group_norm_backward``, with dscale and dbias
    only when autograd asks for them."""

    @staticmethod
    def forward(ctx, x, scale, bias, num_groups, eps, act):
        ctx.save_for_backward(x, scale, bias)
        ctx.cfg = (num_groups, eps, act)
        return _forward(x, scale, bias, num_groups, eps, act)

    @staticmethod
    @once_differentiable
    def backward(ctx, dout):
        x, scale, bias = ctx.saved_tensors
        need_x, need_s, need_b = ctx.needs_input_grad[:3]
        dx, dscale, dbias = group_norm_backward(
            x, scale, bias, dout.contiguous(), *ctx.cfg,
            params=need_s or need_b)
        return (dx if need_x else None, dscale if need_s else None,
                dbias if need_b else None, None, None, None)


def fused_group_norm_act(x: torch.Tensor, scale: torch.Tensor,
                         bias: torch.Tensor, num_groups: int,
                         eps: float = 1e-5, act: Optional[str] = None
                         ) -> torch.Tensor:
    """GroupNorm + activation (None | 'relu' | 'gelu' | 'tanh' |
    'softsign').  x (N, H, W, C) f32 or bf16; scale, bias (C,) f32;
    ``C % num_groups`` must be 0.  Returns x's shape and dtype;
    differentiable in x, scale and bias."""
    _check_args(x, scale, bias, num_groups, act)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, scale, bias)):
        return _GroupNormAct.apply(x, scale, bias, num_groups, eps, act)
    return _forward(x, scale, bias, num_groups, eps, act)
