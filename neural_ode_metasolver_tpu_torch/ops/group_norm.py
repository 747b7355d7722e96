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
(``csrc/group_norm_act_bwd.cu``, counted as ``group_norm_act_bwd``) on its
own plan (``launch_plan(..., backward=True)``), and its plain version
``group_norm_backward_reference`` for CPU tensors.  The backward evaluates
the activation's derivative once an element and keeps dxhat in shared
memory for its last pass.  Its **staged path** copies a block's slice of x
and dout into shared memory with one bulk copy each (TMA), so its threads
hold nothing in registers across passes and two or more blocks run on an
SM; it takes every layout with 16-byte access whose slice fits in half an
SM's shared memory over at most 8 blocks of a cluster, and the re-reading
path the rest.  It writes dx, and dscale and dbias only where autograd
asks for them: their per-block partial sums are then added in a fixed
order by a second kernel of the same library (those launches are also
counted as ``group_norm_act_bwd_params``), so two launches repeat their
bits.

**Members** (a fleet of S runs, ``training/fleet.py``): x (S, N, H, W, C)
with scale and bias (S, C) is one launch of each kernel for all S·N
samples, sample i normalized with row i // N; the backward's dscale and
dbias come back (S, C), each member's partials added in a single run's
order.  Each sample's block or cluster is the one a single launch on its
member computes, so each member's output is bit-equal to that launch's.
The plan is a sample's, so it does not depend on S; the plain versions
loop over the members.
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
_PATH_CODES = {"register": 0, "cluster": 1, "reread": 2, "staged": 3}

MAX_THREADS = 256  # per block (kGnMaxThreads)
MAX_CLUSTER = 8  # the portable cluster size
SMEM_OPTIN = 232448  # the H100's opt-in shared memory per block
SM_SMEM = 233472  # shared memory of an H100 SM
BLOCK_RESERVED = 1024  # shared memory the card keeps for each resident block
# a block of at most this much dynamic shared memory runs two to an SM
TWO_A_SM = SM_SMEM // 2 - BLOCK_RESERVED
_ITEMSIZE = {torch.float32: 4, torch.bfloat16: 2}
# vectors a thread of the register and cluster paths holds: the kernel
# instances of csrc/group_norm_act.cu
_REGS = (4, 8, 16)
# the most vectors a thread of the backward's re-reading path takes
# before a sample goes to more blocks of a cluster
_BWD_REREAD_VECS = 8
_ELEMS = 32  # elements a thread of the register path aims to hold


class GnPlan(NamedTuple):
    """How one launch covers the batch (see ``csrc/group_norm_act.cu`` and
    ``csrc/group_norm_act_bwd.cu``)."""
    path: str  # "register", "cluster", "reread", or the backward's "staged"
    vec: int  # elements a thread reads at once: 16 bytes' worth, or 1
    warps: int  # warps per block
    cluster: int  # blocks per sample
    regs: int  # vectors a thread holds in registers; 0 on "reread", "staged"
    smem_bytes: int  # dynamic shared memory per block
    stash: bool = False  # the backward keeps dxhat in shared memory


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


def _shuffles(c: int, groups: int, vec: int) -> bool:
    """Whether warp shuffles can finish the group sums (``gn_shuffles``):
    16-byte access, a pixel's vector columns divide a warp, and groups
    align with vectors."""
    vpp, cg = c // vec, c // groups
    return (vec > 1 and vpp <= 32 and 32 % vpp == 0 and
            (vec % cg == 0 or (cg % vec == 0 and vpp % (cg // vec) == 0)))


def access(c: int, groups: int, dtype: torch.dtype, aligned: bool = True):
    """(vec, shuffle): the elements a thread reads at once (16 bytes' worth
    where x's pointer and C allow, else 1), and whether warp shuffles can
    finish the group sums, which the register and cluster paths need."""
    size = _ITEMSIZE[dtype]
    vec = 16 // size if aligned and (c * size) % 16 == 0 else 1
    return vec, _shuffles(c, groups, vec)


def _smem_bytes(path: str, c: int, groups: int, vec: int, warps: int,
                cluster: int) -> int:
    """The forward's ``gn_smem_bytes`` of the CUDA source."""
    if path == "reread":
        rows = _layout(c, vec, 32 * warps)[2]
        return 4 * (rows * c + 4 * groups)
    if warps * cluster == 1:
        return 0
    return 4 * (2 * warps * groups + 3 * groups)


def _bwd_smem_bytes(path: str, c: int, groups: int, vec: int, warps: int,
                    cluster: int, hw: int, itemsize: int,
                    stash: bool) -> int:
    """``gn_bwd_smem_bytes`` of the CUDA source: on the staged path two
    mbarriers and x's slice of a block, with ``stash`` dxhat's slice in f32
    (the staged path copies dout into it), then the statistics' and pass
    3's sums (by warp where shuffles add a warp's rows, else by row slot)."""
    rows = _layout(c, vec, 32 * warps)[2]
    shuffle = path == "staged" and _shuffles(c, groups, vec)
    stats = (2 * warps * groups + 3 * groups if shuffle else
             rows * c + 4 * groups)
    slots = warps if shuffle else rows
    slice_ = -(-hw // cluster) * c
    return ((16 + slice_ * itemsize if path == "staged" else 0)
            + (4 * slice_ if stash else 0)
            + 4 * (stats + 2 * slots * c + 2 * c + 4 * groups))


def make_plan(path: str, vec: int, warps: int, cluster: int, regs: int,
              c: int, groups: int) -> GnPlan:
    """A forward plan with its shared-memory bytes for (c, groups)."""
    return GnPlan(path, vec, warps, cluster, regs,
                  _smem_bytes(path, c, groups, vec, warps, cluster))


def make_bwd_plan(path: str, vec: int, warps: int, cluster: int, regs: int,
                  c: int, groups: int, hw: int, dtype: torch.dtype,
                  stash: bool = True) -> GnPlan:
    """A backward plan (path "staged" or "reread", regs 0) with its
    shared-memory bytes for a sample of hw pixels of (c, groups) in
    ``dtype``; re-reading keeps the stash where it fits."""
    return GnPlan(path, vec, warps, cluster, regs,
                  _bwd_smem_bytes(path, c, groups, vec, warps, cluster, hw,
                                  _ITEMSIZE[dtype], stash), stash)


def _sample_warps(hw: int, c: int, vec: int, cap: int) -> Optional[int]:
    """The fewest warps of one block that hold a whole sample in at most
    ``cap`` vectors a thread and at most ``_ELEMS`` elements (a block's
    time is mostly its threads' serial work), else 8 if they hold it in
    ``cap``; None if 8 do not."""
    for warps in (1, 2, 4, 8):
        most = _per_thread(hw, c, vec, 32 * warps, 1)
        if most <= cap and (most * vec <= _ELEMS or warps == 8):
            return warps
    return None


def _bwd_plan(h: int, w: int, c: int, groups: int, dtype: torch.dtype,
              aligned: bool) -> GnPlan:
    """``launch_plan(..., backward=True)``."""
    vec, _ = access(c, groups, dtype, aligned)
    hw = h * w
    if vec > 1:
        # staged: the fewest blocks a sample that leave two blocks an SM,
        # of 4 warps where one block holds a sample, else 8 (the timings of
        # scripts/bench_group_norm_plans.py --backward, PERF.md)
        for k in range(1, MAX_CLUSTER + 1):
            plan = make_bwd_plan("staged", vec, 4 if k == 1 else 8, k, 0,
                                 c, groups, hw, dtype)
            if plan.smem_bytes <= TWO_A_SM:
                return plan
    # re-reading: the forward's blocks with at most 8 vectors a thread,
    # dxhat in shared memory where it fits a block
    warps = _sample_warps(hw, c, vec, _BWD_REREAD_VECS)
    k = 1 if warps else next(
        (k for k in range(2, MAX_CLUSTER + 1)
         if _per_thread(hw, c, vec, MAX_THREADS, k) <= _BWD_REREAD_VECS),
        MAX_CLUSTER)
    plan = make_bwd_plan("reread", vec, warps or 8, k, 0, c, groups, hw,
                         dtype)
    if plan.smem_bytes > SMEM_OPTIN:
        plan = make_bwd_plan("reread", vec, warps or 8, k, 0, c, groups, hw,
                             dtype, stash=False)
    return plan


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

    ``backward=True`` plans ``group_norm_backward``'s launch: the staged
    path where a block's slice fits ``TWO_A_SM`` bytes over at most 8
    blocks, else re-reading."""
    if c % groups:
        raise ValueError(f"channels ({c}) must be divisible by num_groups "
                         f"({groups})")
    if backward:
        plan = _bwd_plan(h, w, c, groups, dtype, aligned)
    else:
        plan = _fwd_plan(h, w, c, groups, dtype, aligned)
    if plan.smem_bytes > SMEM_OPTIN:
        raise ValueError(
            f"group norm: the statistics of {groups} groups of "
            f"{c // groups} channels need {plan.smem_bytes} bytes of shared "
            f"memory, more than the {SMEM_OPTIN} a block has")
    return plan


def _fwd_plan(h: int, w: int, c: int, groups: int, dtype: torch.dtype,
              aligned: bool) -> GnPlan:
    """``launch_plan`` of the forward."""
    vec, shuffle = access(c, groups, dtype, aligned)
    hw = h * w
    # a whole sample in one block, else slices of 8-warp blocks over a
    # cluster: as few blocks as hold it in 16 vectors a thread (a cluster
    # waits at each of its two exchanges for its slowest block), else 8
    # blocks re-reading
    warps = _sample_warps(hw, c, vec, _REGS[-1])
    if warps:
        most = _per_thread(hw, c, vec, 32 * warps, 1)
        regs = next(r for r in _REGS if r >= most)
        return (make_plan("register", vec, warps, 1, regs, c, groups)
                if shuffle else
                make_plan("reread", vec, warps, 1, 0, c, groups))
    k = next((k for k in range(2, MAX_CLUSTER + 1)
              if _per_thread(hw, c, vec, MAX_THREADS, k) <= _REGS[-1]), None)
    return (make_plan("cluster", vec, 8, k, _REGS[-1], c, groups)
            if shuffle and k is not None else
            make_plan("reread", vec, 8, k or MAX_CLUSTER, 0, c, groups))


def _check_args(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                num_groups: int, act: Optional[str]) -> None:
    """x (N, H, W, C) with scale and bias (C,), or members: x (S, N, H,
    W, C) with (S, C)."""
    if x.dim() not in (4, 5):
        raise ValueError(f"group norm: x {tuple(x.shape)} is not (N,H,W,C)"
                         " or (S,N,H,W,C)")
    c = x.shape[-1]
    if c % num_groups:
        raise ValueError(f"channels ({c}) must be divisible by num_groups "
                         f"({num_groups})")
    want = (x.shape[0], c) if x.dim() == 5 else (c,)
    if tuple(scale.shape) != want or tuple(bias.shape) != want:
        raise ValueError(f"group norm: scale {tuple(scale.shape)} and bias "
                         f"{tuple(bias.shape)} are not {want}")
    if act not in _ACTS:
        raise ValueError(f"unknown activation {act!r}")


def group_norm_reference(x: torch.Tensor, scale: torch.Tensor,
                         bias: torch.Tensor, num_groups: int,
                         eps: float = 1e-5, act: Optional[str] = None
                         ) -> torch.Tensor:
    """Plain version: two-pass f32 GroupNorm(+act) on NHWC, cast to x's
    dtype (the JAX ``group_norm_reference``); with members a loop over
    them."""
    _check_args(x, scale, bias, num_groups, act)
    if x.dim() == 5:
        return torch.stack([
            group_norm_reference(xm, sm, bm, num_groups, eps, act)
            for xm, sm, bm in zip(x, scale, bias)])
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
    Returns (dx, dscale, dbias); with members a loop over them (dscale and
    dbias (S, C))."""
    _check_args(x, scale, bias, num_groups, act)
    if x.dim() == 5:
        parts = [group_norm_backward_reference(xm, sm, bm, dm, num_groups,
                                               eps, act)
                 for xm, sm, bm, dm in zip(x, scale, bias, dout)]
        return tuple(torch.stack(t) for t in zip(*parts))
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
    """Launch the kernel on checked CUDA tensors with ``plan``, one launch
    for all members; the C entry point refuses a plan it cannot run."""
    s = x.shape[0] if x.dim() == 5 else 1
    n, h, w, c = x.shape[-4:]
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    lib = _build.load("group_norm_act")
    err = lib.group_norm_act_launch(
        _build.DTYPE_CODES[x.dtype], _ACT_CODES[act], x.data_ptr(),
        scale.data_ptr(), bias.data_ptr(), out.data_ptr(), s, n, h * w, c,
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
    """The backward kernel on checked CUDA tensors with ``plan``, one
    launch for all members: dx, and with ``params`` dscale and dbias ((C,),
    or (S, C) for members; else None)."""
    s = x.shape[0] if x.dim() == 5 else 1
    n, h, w, c = x.shape[-4:]
    lead = x.shape[:1] if x.dim() == 5 else ()
    dx = torch.empty_like(x)
    part = dscale = dbias = None
    if params:
        part = torch.empty((s * n * plan.cluster, 2, c), dtype=torch.float32,
                           device=x.device)
        dscale = torch.empty(lead + (c,), dtype=torch.float32,
                             device=x.device)
        dbias = torch.empty(lead + (c,), dtype=torch.float32,
                            device=x.device)
    ptr = lambda t: None if t is None else t.data_ptr()
    lib = _build.load("group_norm_act_bwd")
    err = lib.group_norm_act_bwd_launch(
        _build.DTYPE_CODES[x.dtype], _ACT_CODES[act], x.data_ptr(),
        dout.data_ptr(), scale.data_ptr(), bias.data_ptr(), dx.data_ptr(),
        ptr(part), ptr(dscale), ptr(dbias), s, n, h * w, c, num_groups,
        float(eps), _PATH_CODES[plan.path], plan.vec, plan.warps,
        plan.cluster, plan.regs, int(plan.stash), x.device.index,
        _build.stream_handle(x),
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
    n, h, w, c = x.shape[-4:]
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
    the last two f32 of scale's shape ((C,), or (S, C) for members), or
    None without ``params``.  The backward kernel
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
    n, h, w, c = x.shape[-4:]
    if x.numel() == 0:
        zeros = torch.zeros(scale.shape, dtype=torch.float32,
                            device=x.device)
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
    'softsign').  x (N, H, W, C) f32 or bf16; scale, bias (C,) f32; or
    members, x (S, N, H, W, C) with scale, bias (S, C); ``C % num_groups``
    must be 0.  Returns x's shape and dtype;
    differentiable in x, scale and bias."""
    _check_args(x, scale, bias, num_groups, act)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, scale, bias)):
        return _GroupNormAct.apply(x, scale, bias, num_groups, eps, act)
    if backend.kernel_ops():
        return torch.ops.nodems.group_norm_act(  # ops/library.py
            x, scale, bias, num_groups, float(eps), act)
    return _forward(x, scale, bias, num_groups, eps, act)
