"""Kernel B1: stride-1 SAME 3x3 convolution, NHWC x HWIO -> NHWC, with its
backward.

Port of ``ops/pallas_im2col.py::conv3x3_im2col_gemm``.  The CUDA kernel
(``csrc/conv3x3.cu`` over ``csrc/conv3x3.cuh``) runs the TPU kernel's GEMM,
(N*H*W, 9*Cin) x (9*Cin, Cout), as an implicit GEMM: each K step's patch
rows are gathered straight into shared memory, so the 9x im2col matrix is
never formed.  bf16 products run on the tensor cores (``wgmma``), f32 ones
as full-f32 FMAs; sums are f32 and the output is rounded once.

``conv3x3_same`` is differentiable.  When a gradient can flow it is the
apply of an ``autograd.Function`` whose backward runs only what
``ctx.needs_input_grad`` asks for, on hand-written kernels too:
  * dgrad, dx = conv3x3_same(dy, w') with w'[a, b, co, ci] = w[2-a, 2-b, ci,
    co]: kernel B1 itself with Cin and Cout swapped, counted as
    ``conv3x3_dgrad``;
  * wgrad, dW[kh, kw, ci, co] = sum over (n, h, w) of x[n, h+kh-1, w+kw-1,
    ci] * dy[n, h, w, co], zero-padded: ``csrc/conv3x3_wgrad.cu``, counted
    as ``conv3x3_wgrad``, on the path ``wgrad_plan`` picks: TMA boxes and
    ``wgmma`` (bf16, channels and W multiples of 8) or split-K with
    ``mma.sync`` / f32 FMAs.
The Pallas kernel has no VJP (JAX differentiates XLA's conv); these are the
backward the port's training path needs.

Every wrapper launches its kernel for CUDA tensors and takes the plain
version (``reference_conv3x3``, ``reference_conv3x3_wgrad``) only for CPU
tensors; there is no fallback.

**Members** (a fleet of S runs, ``training/fleet.py``): with w (S, 3, 3,
Cin, Cout) and x (S, N, H, W, Cin), member m's images meet w[m].  The
forward, the dgrad (flipped w[m]) and the split-K wgrad (output (S, 3, 3,
Cin, Cout), each member reduced over its own images) are then one launch
for all S members, grid dimension z the member: each member's blocks are
a single launch's on its slice, so its output is bit-equal to that
launch's, and the count is one a launch.  The TMA wgrad takes one member a
launch (its tensor maps cover one member's images): S launches, counted.
The plain versions loop over the members.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from .. import _build, backend

__all__ = ["conv3x3_same", "conv3x3_dgrad", "conv3x3_wgrad",
           "reference_conv3x3", "reference_conv3x3_wgrad", "flip_weights",
           "WgradPlan", "wgrad_plan", "run_wgrad_plan", "conv3x3_path",
           "CONV_PATHS", "conv3x3_f32"]

KERNEL_NAME = "conv3x3_same"
DGRAD_NAME = "conv3x3_dgrad"
WGRAD_NAME = "conv3x3_wgrad"

# pixels per K step of the wgrad kernel's split-K path, by dtype
# (csrc/conv3x3_wgrad.cu)
WGRAD_BK = {torch.float32: 64, torch.bfloat16: 128}
# the wgrad paths, by their code in the C entry point
WGRAD_PATHS = ("split_k", "tma")
# the TMA path: pixels a K step aims at, its k16 slices (the kernel's
# instances), channels per block and operand, ring slots, the blocks of a
# cluster that sum their splits in shared memory, and an H100 block's
# opt-in shared memory (bytes)
TMA_STEP_PIXELS = 64
TMA_SLICES = range(4, 9)
TMA_CHANNELS = 64
TMA_MAX_STAGES = 4
TMA_CLUSTER = 2
SMEM_OPTIN = 232448
# B1's kernels, by the code of csrc/conv3x3.cuh's ConvPath
CONV_PATHS = ("gather", "gather_elements", "halo", "halo_narrow")
# members a launch holds: they run on grid dimension z (the split-K wgrad
# shares it with the splits), which CUDA caps at 65,535
MAX_GRID_Z = 65535


def _wide(t: torch.Tensor) -> torch.Tensor:
    """``t`` in its promotion with float32 (bf16 -> f32, f64 stays)."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


def conv3x3_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """3x3 SAME conv of inputs upcast to at least f32, NHWC x HWIO -> NHWC
    in that type."""
    y = F.conv2d(_wide(x).permute(0, 3, 1, 2), _wide(w).permute(3, 2, 0, 1),
                 padding=1)
    return y.permute(0, 2, 3, 1)


def reference_conv3x3(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain version: f32-accumulated conv cast to x's dtype (mirrors the
    JAX ``reference_conv3x3`` with ``preferred_element_type=f32``); with
    members (w (S, 3, 3, Cin, Cout), x (S, N, H, W, Cin)) a loop over
    them."""
    if w.dim() == 5:
        return torch.stack([reference_conv3x3(xm, wm)
                            for xm, wm in zip(x, w)])
    return conv3x3_f32(x, w).to(x.dtype).contiguous()


def flip_weights(w: torch.Tensor) -> torch.Tensor:
    """w' of the dgrad: ([S,] 3, 3, Cin, Cout) -> ([S,] 3, 3, Cout, Cin),
    taps reversed, contiguous."""
    return w.flip(-4, -3).transpose(-2, -1).contiguous()


def reference_conv3x3_wgrad(x: torch.Tensor, dy: torch.Tensor
                            ) -> torch.Tensor:
    """Plain wgrad: nine (Cin, P) x (P, Cout) products of the zero-padded,
    shifted x and dy, P = N*H*W, in at least f32, rounded once to x's
    dtype.  x (N, H, W, Cin), dy (N, H, W, Cout) -> (3, 3, Cin, Cout);
    with members (x (S, N, H, W, Cin), dy (S, N, H, W, Cout)) a loop over
    them -> (S, 3, 3, Cin, Cout)."""
    if x.dim() == 5:
        return torch.stack([reference_conv3x3_wgrad(xm, dm)
                            for xm, dm in zip(x, dy)])
    n, h, wd, cin = x.shape
    cout = dy.shape[3]
    xp = F.pad(_wide(x), (0, 0, 1, 1, 1, 1))
    d = _wide(dy).reshape(-1, cout)
    taps = [xp[:, a:a + h, b:b + wd].reshape(-1, cin).t() @ d
            for a in range(3) for b in range(3)]
    return torch.stack(taps).reshape(3, 3, cin, cout).to(x.dtype)


def _check_shapes(what: str, x: torch.Tensor, w: torch.Tensor) -> None:
    """x (N, H, W, C) with w (3, 3, C, Co), or members: x (S, N, H, W, C)
    with w (S, 3, 3, C, Co)."""
    members = w.dim() == 5
    if x.dim() != w.dim() or w.dim() not in (4, 5) \
            or w.shape[-4:-2] != (3, 3) or w.shape[-2] != x.shape[-1] \
            or (members and w.shape[0] != x.shape[0]):
        raise ValueError(f"{what}: x {tuple(x.shape)} and w "
                         f"{tuple(w.shape)} are not (N,H,W,C) and (3,3,C,Co)"
                         " or (S,N,H,W,C) and (S,3,3,C,Co)")


def _launch_conv(x: torch.Tensor, w: torch.Tensor, name: str
                 ) -> torch.Tensor:
    """Kernel B1 on CUDA tensors (counted under ``name``), the plain version
    on CPU tensors; one launch for all members."""
    if x.device.type == "cpu" and w.device.type == "cpu":
        return reference_conv3x3(x, w)
    _build.check_cuda_tensors(name, x.dtype, x=x, w=w)
    s = x.shape[0] if x.dim() == 5 else 1
    if s > MAX_GRID_Z:
        raise ValueError(f"{name}: {s} members exceed grid dimension z "
                         f"({MAX_GRID_Z})")
    n, h, wd, cin = x.shape[-4:]
    cout = w.shape[-1]
    out = torch.empty(x.shape[:-1] + (cout,), dtype=x.dtype,
                      device=x.device)
    if out.numel() == 0:
        return out
    lib = _build.load("conv3x3")
    err = lib.conv3x3_same_launch(
        _build.DTYPE_CODES[x.dtype], x.data_ptr(), w.data_ptr(),
        out.data_ptr(), s, n, h, wd, cin, cout, x.device.index,
        _build.stream_handle(x),
    )
    _build.check(lib, err, f"{name} launch")
    backend.count_launch(name)
    return out


def conv3x3_dgrad(dy: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """dx of y = conv3x3_same(x, w): kernel B1 on (dy, flip_weights(w)).
    dy (N, H, W, Cout), w (3, 3, Cin, Cout) -> (N, H, W, Cin); members:
    dy (S, N, H, W, Cout), w (S, 3, 3, Cin, Cout), one launch."""
    if w.dim() not in (4, 5) or dy.dim() != w.dim() \
            or w.shape[-1] != dy.shape[-1] \
            or (w.dim() == 5 and w.shape[0] != dy.shape[0]):
        raise ValueError(f"conv3x3_dgrad: dy {tuple(dy.shape)} and w "
                         f"{tuple(w.shape)} are not ([S,]N,H,W,Co), "
                         "([S,]3,3,C,Co)")
    return _launch_conv(dy, flip_weights(w), DGRAD_NAME)


class WgradPlan(NamedTuple):
    """How the wgrad kernel runs a shape: ``path`` "tma" (TMA boxes into a
    ring, ``wgmma``) or "split_k" (``cp.async`` halo, ``mma.sync`` or f32
    FMAs); ``splits`` K ranges summed apart, then in order; ``rows`` image
    rows per K step ("tma") or pixels per K step ("split_k"); ``stages``
    ring slots; ``cluster`` consecutive splits whose blocks add their sums
    in shared memory, in rank order, before one partial is written."""
    path: str
    splits: int
    rows: int
    stages: int
    cluster: int


def _tma_stage_bytes(rows: int, w: int) -> int:
    """Shared bytes of one TMA K step: three x boxes of rows + 2 image rows
    and one dy box of rows, 128 bytes a pixel (64 bf16 channels)."""
    return (3 * (rows + 2) + rows) * w * 128


def wgrad_plan(n: int, h: int, w: int, cin: int, cout: int,
               dtype: torch.dtype, sms: int, aligned: bool = True
               ) -> WgradPlan:
    """The wgrad kernel's launch plan, from shapes, dtype, SM count and
    whether x and dy start on 16 bytes; it fixes the sum order, so a launch
    repeats its bits.

    The TMA path takes bf16 with Cin and Cout multiples of 8 (TMA's 16-byte
    strides) and W a multiple of 8 (each tap on whole swizzle atoms): a K
    step is ``rows`` image rows, the fewest that make ``TMA_STEP_PIXELS``
    pixels in whole k16 slices (4 to 8 of them), with as many ring slots as
    fit (at least two), and clusters of ``TMA_CLUSTER`` splits.  Everything
    else (f32, the stem's Cin 3, MNIST's 65, other widths) takes the split-K
    path.  Either way K is cut into about one block per SM over the (Cin,
    Cout) tiles (the TMA path rounds down to whole clusters), at most one
    range per step.  A fleet's members (n images each) are each cut as a
    single run is, so their sums keep its order."""
    ch = 128 // (torch.finfo(dtype).bits // 8)  # channels per 128-byte row
    if (dtype == torch.bfloat16 and aligned and cin % 8 == 0
            and cout % 8 == 0 and w % 8 == 0 and 0 < w <= 256):
        rows = math.ceil(TMA_STEP_PIXELS / w)
        while rows * w % 16:
            rows += 1
        stages = min(TMA_MAX_STAGES,
                     (SMEM_OPTIN - 1024 - 64) // _tma_stage_bytes(rows, w))
        if stages >= 2 and rows * w // 16 in TMA_SLICES:
            tiles = math.ceil(cin / TMA_CHANNELS) * math.ceil(
                cout / TMA_CHANNELS)
            splits = max(1, min(n * math.ceil(h / rows),
                                math.ceil(sms / tiles)))
            cluster = TMA_CLUSTER if splits >= TMA_CLUSTER else 1
            return WgradPlan("tma", splits // cluster * cluster, rows, stages,
                             cluster)
    bk = WGRAD_BK[dtype]
    tiles = math.ceil(cin / ch) * math.ceil(cout / ch)
    steps = math.ceil(n * h * w / bk)
    return WgradPlan("split_k", max(1, min(steps, math.ceil(sms / tiles))),
                     bk, 3, 1)


def _window(img: torch.Tensor, row0: int, col0: int, rows: int
            ) -> torch.Tensor:
    """Rows row0 .. row0+rows-1 and columns col0 .. col0+W-1 of an (H, W, C)
    image, zero outside it: what a TMA box reads."""
    h, w, c = img.shape
    out = img.new_zeros(rows, w, c)
    r0, r1 = max(row0, 0), min(row0 + rows, h)
    c0, c1 = max(col0, 0), min(col0 + w, w)
    if r0 < r1 and c0 < c1:
        out[r0 - row0:r1 - row0, c0 - col0:c1 - col0] = img[r0:r1, c0:c1]
    return out


def run_wgrad_plan(x: torch.Tensor, dy: torch.Tensor, rows: int,
                   splits: int, cluster: int = 1) -> torch.Tensor:
    """The TMA path's decomposition in plain torch, at least f32: K in steps
    of ``rows`` whole image rows of one image; per step, three boxes of x
    (rows + 2 image rows from h0 - 1, columns shifted by kw - 1, zero
    outside the image) and one of dy; tap (kh, kw) is box kw from pixel
    row kh*W on; ``splits`` ranges of steps summed apart, each ``cluster``
    consecutive ones added in order, then those partials in order.  Rounds
    once to x's dtype."""
    n, h, w, cin = x.shape
    cout = dy.shape[3]
    xf, df = _wide(x), _wide(dy)
    spi = math.ceil(h / rows)
    steps = n * spi
    out, part = None, None
    for split in range(splits):
        acc = xf.new_zeros(9, cin, cout)
        for g in range(steps * split // splits,
                       steps * (split + 1) // splits):
            img, blk = divmod(g, spi)
            h0 = blk * rows
            d = _window(df[img], h0, 0, rows).reshape(-1, cout)
            for kw in range(3):
                box = _window(xf[img], h0 - 1, kw - 1, rows + 2).reshape(
                    -1, cin)
                for kh in range(3):
                    acc[3 * kh + kw] += box[kh * w:(kh + rows) * w].t() @ d
        part = acc if split % cluster == 0 else part + acc
        if split % cluster == cluster - 1:
            out = part if out is None else out + part
    return out.reshape(3, 3, cin, cout).to(x.dtype)


def conv3x3_path(n: int, h: int, w: int, cin: int, cout: int,
                 dtype: torch.dtype, device: torch.device) -> str:
    """The kernel B1 runs for these shapes on a CUDA device (a name of
    ``CONV_PATHS``), as the C launcher picks it."""
    lib = _build.load("conv3x3")
    code = lib.conv3x3_path(_build.DTYPE_CODES[dtype], n, h, w, cin, cout,
                            torch.device(device).index or 0)
    if code < 0:
        raise ValueError(f"conv3x3: no path for {(n, h, w, cin, cout)} "
                         f"{dtype}")
    return CONV_PATHS[code]


def conv3x3_wgrad(x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """dW of y = conv3x3_same(x, w), in x's dtype: f32 sums rounded once.
    x (N, H, W, Cin), dy (N, H, W, Cout) -> (3, 3, Cin, Cout); members, x
    (S, N, H, W, Cin) and dy (S, N, H, W, Cout) -> (S, 3, 3, Cin, Cout),
    each member on a single run's plan.

    The CUDA kernel runs ``wgrad_plan``: it splits K = N*H*W over its
    ranges, writes each range's (or each cluster's) f32 partial sums to a
    workspace and adds them in range order in a second launch: no float
    atomics, so two calls give the same bits.  One count per call.  On the split-K path a block
    holds three K steps' input halos (BK + 2 W + 2 pixel rows each), so
    images wider than about 170 pixels (bf16; 230 in f32) do not fit its
    shared memory and the launch raises."""
    if x.dim() not in (4, 5) or dy.dim() != x.dim() \
            or x.shape[:-1] != dy.shape[:-1]:
        raise ValueError(f"conv3x3_wgrad: x {tuple(x.shape)} and dy "
                         f"{tuple(dy.shape)} are not ([S,]N,H,W,C), "
                         "([S,]N,H,W,Co)")
    if x.device.type == "cpu" and dy.device.type == "cpu":
        return reference_conv3x3_wgrad(x, dy)
    _build.check_cuda_tensors(WGRAD_NAME, x.dtype, x=x, dy=dy)
    n, h, wd, cin = x.shape[-4:]
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    plan = wgrad_plan(n, h, wd, cin, dy.shape[-1], x.dtype, sms,
                      aligned=x.data_ptr() % 16 == 0
                      and dy.data_ptr() % 16 == 0)
    if x.dim() == 5 and plan.path == "tma":
        # one member a launch: the TMA path's maps cover one member
        return torch.stack([_launch_wgrad(xm, dm, plan)
                            for xm, dm in zip(x, dy)])
    return _launch_wgrad(x, dy, plan)


def _launch_wgrad(x: torch.Tensor, dy: torch.Tensor, plan: WgradPlan
                  ) -> torch.Tensor:
    """The wgrad kernel under ``plan`` (a member's) on checked CUDA
    tensors, one launch for all members (x (S, N, H, W, Cin)); counted.
    The split-K path runs S x splits blocks along grid dimension z, so a
    count above ``MAX_GRID_Z`` raises ValueError, as the C entry point
    refuses it (the TMA path launches once a member)."""
    s = x.shape[0] if x.dim() == 5 else 1
    if plan.path == "split_k" and s * plan.splits > MAX_GRID_Z:
        raise ValueError(f"wgrad: {s} members x {plan.splits} splits "
                         f"exceed grid dimension z ({MAX_GRID_Z})")
    n, h, wd, cin = x.shape[-4:]
    cout = dy.shape[-1]
    lead = x.shape[:1] if x.dim() == 5 else ()
    out = torch.empty(lead + (3, 3, cin, cout), dtype=x.dtype,
                      device=x.device)
    if out.numel() == 0:
        return out
    if n * h * wd == 0:
        return out.zero_()
    ws = torch.empty((s, plan.splits // plan.cluster, 9, cin, cout),
                     dtype=torch.float32, device=x.device)
    lib = _build.load("conv3x3_wgrad")
    err = lib.conv3x3_wgrad_launch(
        _build.DTYPE_CODES[x.dtype], x.data_ptr(), dy.data_ptr(),
        ws.data_ptr(), out.data_ptr(), s, n, h, wd, cin, cout,
        WGRAD_PATHS.index(plan.path), plan.splits, plan.rows, plan.stages,
        plan.cluster, x.device.index, _build.stream_handle(x),
    )
    _build.check(lib, err, "conv3x3_wgrad launch")
    backend.count_launch(WGRAD_NAME)
    return out


class _Conv3x3(torch.autograd.Function):
    """Forward B1; backward B1 dgrad and the wgrad kernel, each only when
    asked for."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return _launch_conv(x, w, KERNEL_NAME)

    @staticmethod
    @once_differentiable
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dy = dy.contiguous()
        dx = conv3x3_dgrad(dy, w) if ctx.needs_input_grad[0] else None
        dw = conv3x3_wgrad(x, dy) if ctx.needs_input_grad[1] else None
        return dx, dw


def conv3x3_same(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (N, H, W, Cin), w (3, 3, Cin, Cout) of x's dtype -> (N, H, W,
    Cout); or members, x (S, N, H, W, Cin) and w (S, 3, 3, Cin, Cout) ->
    (S, N, H, W, Cout); differentiable in x and w."""
    _check_shapes("conv3x3_same", x, w)
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return _Conv3x3.apply(x, w)
    return _launch_conv(x, w, KERNEL_NAME)
