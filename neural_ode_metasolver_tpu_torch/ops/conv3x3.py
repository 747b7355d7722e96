"""Kernel B1: stride-1 SAME 3x3 convolution, NHWC x HWIO -> NHWC, with its
backward.

Port of ``ops/pallas_im2col.py::conv3x3_im2col_gemm``.  The CUDA kernel
(``csrc/conv3x3.cu``) runs the TPU kernel's GEMM, (N*H*W, 9*Cin) x (9*Cin,
Cout), as an implicit GEMM: each block's source pixels are copied straight
into shared memory, so the 9x im2col matrix is never formed.  bf16 products
run on the tensor cores (``wgmma``, ``csrc/conv3x3.cuh``, which picks its
path itself); f32 ones as full-f32 FMAs (``csrc/conv3x3_f32.cuh``) on the
tile ``conv3x3_f32_plan`` picks, which the C entry point checks; sums are
f32 and the output is rounded once.

``conv3x3_same`` is differentiable.  When a gradient can flow it is the
apply of an ``autograd.Function`` whose backward runs only what
``ctx.needs_input_grad`` asks for, on hand-written kernels too:
  * dgrad, dx = conv3x3_same(dy, w') with w'[a, b, co, ci] = w[2-a, 2-b, ci,
    co]: kernel B1 itself with Cin and Cout swapped, counted as
    ``conv3x3_dgrad``;
  * wgrad, dW[kh, kw, ci, co] = sum over (n, h, w) of x[n, h+kh-1, w+kw-1,
    ci] * dy[n, h, w, co], zero-padded: ``csrc/conv3x3_wgrad.cu``, counted
    as ``conv3x3_wgrad``, on the path ``wgrad_plan`` picks: TMA boxes and
    ``wgmma`` (bf16, channels and W multiples of 8), split-K with
    ``mma.sync`` (other bf16), or the f32 path's FMAs.
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
a single launch's on its slice (every plan is a single run's: it never
reads S), so its output is bit-equal to that launch's, and the count is
one a launch.  The TMA wgrad takes one member a
launch (its tensor maps cover one member's images): S launches, counted.
The plain versions loop over the members.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from .. import _build, backend

__all__ = ["conv3x3_same", "conv3x3_dgrad", "conv3x3_wgrad",
           "reference_conv3x3", "reference_conv3x3_wgrad", "flip_weights",
           "ConvF32Plan", "conv3x3_f32_plan", "run_conv3x3_f32_plan",
           "WgradPlan", "wgrad_plan", "run_wgrad_plan",
           "run_wgrad_f32_plan", "conv3x3_path", "CONV_PATHS",
           "conv3x3_f32"]

KERNEL_NAME = "conv3x3_same"
DGRAD_NAME = "conv3x3_dgrad"
WGRAD_NAME = "conv3x3_wgrad"

# pixels per K step of the wgrad kernel's bf16 split-K path and of its f32
# path (csrc/conv3x3_wgrad.cu)
WGRAD_BK = 128
WGRAD_F32_BK = 64
# the f32 path: Cin and Cout channels of a block, channels past the last
# whole 32 that its block folds in, and the fewest K steps a range keeps
# (fewer ranges, fewer partials to add)
WGRAD_F32_CI = 32
WGRAD_F32_CO = 32
WGRAD_F32_MAX_FOLD = 4
WGRAD_F32_MIN_STEPS = 3
# the wgrad paths, by their code in the C entry point
WGRAD_PATHS = ("split_k", "tma", "f32")
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
# B1's kernels, by the code of csrc/conv3x3.cuh's ConvPath: bf16's four,
# then the f32 core's two halo layouts
CONV_PATHS = ("gather", "gather_elements", "halo", "halo_narrow",
              "f32_halo", "f32_bands")
# The f32 core (csrc/conv3x3_f32.cuh): threads a block, output rows a block
# (most first), channels a halo row, channels past the whole chunks that
# one step of nine taps takes, B rows a ring slot, bytes of a row of 32 f32
# channels and of a halo row
F32_THREADS = 128
F32_ROWS = (128, 64, 32)
F32_CHUNK = 32
F32_MAX_TAIL = 4
F32_SLOT_ROWS = 9 * F32_MAX_TAIL
ROW_BYTES = 128
F32_HALO_ROW = ROW_BYTES + 16  # a halo row of 32 f32 channels, padded
# an H100 SM's shared memory and what each block reserves of it: the f32
# core's tiles of 128 rows and of 72 columns run two blocks an SM, the
# other K-split ones three (csrc/conv3x3_f32.cuh::f32_blocks_per_sm)
SM_SMEM, BLOCK_RESERVED = 233472, 1024
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


class ConvF32Plan(NamedTuple):
    """How the f32 core runs a conv: ``path`` "f32_halo" (the block's
    contiguous source pixels, m0-W-1 .. m0+BM+W) or "f32_bands" (three bands
    of rows + 2 pixels, for W > rows + 2); ``rows`` output pixels a block
    (BM); ``cols`` output channels a block (64, or 72 for Cout 65 to 72:
    one tile, no second for the 65th); ``ksplit`` warps summing shares of K
    for the same rows (128 / rows), added in share order; ``stages`` ring
    slots of weight rows."""
    path: str
    rows: int
    cols: int
    ksplit: int
    stages: int


def _f32_chunks(cin: int):
    """(K chunks stepped tap by tap, channels after them taken in one step
    of nine taps): channels past the last whole 32 go to that one step when
    they are at most ``F32_MAX_TAIL`` (MNIST's 65th), else to a short
    chunk."""
    rem = cin % F32_CHUNK
    tail = rem if rem <= F32_MAX_TAIL else 0
    return -(-(cin - tail) // F32_CHUNK), tail


def _f32_smem(w: int, cin: int, rows: int, cols: int, ksplit: int,
              stages: int) -> int:
    """Dynamic shared memory of the f32 core (csrc/conv3x3_f32.cuh::
    f32_plan_geom): the weight ring, one or two halos of rows + 2 + 2S rows,
    the zero row and the halo rows' pixels, or the K shares' staged sums
    where larger."""
    band = min(w, rows + 2)
    halo = rows + 2 + 2 * band
    nmain, tail = _f32_chunks(cin)
    nbuf = 2 if nmain + (tail > 0) > 1 else 1
    ring = stages * F32_SLOT_ROWS * cols * 4 + nbuf * halo * F32_HALO_ROW \
        + ROW_BYTES + 4 * halo
    part = ksplit * rows * (cols + 4) * 4
    return 128 + max(ring, part)


def conv3x3_f32_plan(n: int, h: int, w: int, cin: int, cout: int,
                     sms: int) -> ConvF32Plan:
    """The f32 core's launch plan, from one run's shapes and the SM count
    (never the member count: a member-batched launch runs each member on a
    single run's blocks).  ``cols`` 72 where Cout is 65 to 72, else 64.
    ``rows``: 128 where those blocks fill the SMs twice over (two blocks an
    SM: at 64 sums a thread, fewer leave SM sub-partitions without a warp);
    else 32 with K in four shares where 64-column blocks still give every
    SM two (MNIST's 6x6 at batch 256: three fit an SM); else 64 with K in
    two shares (MNIST at batch 128, and every fleet member: half the weight
    copies and share sums of 32 rows, at no cost while the SMs are not
    full anyway).  The bands where W > rows + 2; the most ring slots, up
    to 4, with which the tile's blocks an SM still fit, at least 2."""
    cols = 72 if 64 < cout <= 72 else 64
    tiles_n = -(-cout // cols)
    m = n * h * w
    rows = (128 if -(-m // 128) * tiles_n >= 2 * sms else
            32 if cols == 64 and -(-m // 32) * tiles_n >= 2 * sms else 64)
    ksplit = F32_THREADS // rows
    fit = SM_SMEM // (3 if ksplit > 1 and cols == 64 else 2) \
        - BLOCK_RESERVED
    stages = next((s for s in (4, 3)
                   if _f32_smem(w, cin, rows, cols, ksplit, s) <= fit), 2)
    return ConvF32Plan("f32_halo" if w <= rows + 2 else "f32_bands", rows,
                       cols, ksplit, stages)


def run_conv3x3_f32_plan(x: torch.Tensor, w: torch.Tensor,
                         plan: ConvF32Plan) -> torch.Tensor:
    """The f32 core's decomposition in plain torch, at least f32: K in
    chunks of 32 channels (a short last one where more than
    ``F32_MAX_TAIL`` remain), a chunk tap by tap, each tap's slabs of 4
    channels dealt to the ``ksplit`` shares in turn; the channels past the
    whole chunks (at most ``F32_MAX_TAIL``, MNIST's 65th) in one step of
    nine taps, tap t to share t % ksplit; the shares added in order.  The
    tiling of M and N does not change a sum.  Rounds once to x's dtype."""
    n, h, wd, cin = x.shape
    cout = w.shape[-1]
    xp = F.pad(_wide(x), (0, 0, 1, 1, 1, 1))
    a = [xp[:, t // 3:t // 3 + h, t % 3:t % 3 + wd].reshape(-1, cin)
         for t in range(9)]  # each tap's source pixels, zero outside
    b = _wide(w).reshape(9, cin, cout)
    parts = [a[0].new_zeros(a[0].shape[0], cout)
             for _ in range(plan.ksplit)]
    nmain, tail = _f32_chunks(cin)
    for chunk in range(nmain):
        c0 = chunk * F32_CHUNK
        c1 = min(c0 + F32_CHUNK, cin - tail)
        for t in range(9):
            for sl, k in enumerate(range(c0, c1, 4)):
                parts[sl % plan.ksplit] += a[t][:, k:k + 4] @ b[t, k:k + 4]
    for t in range(9 if tail else 0):
        parts[t % plan.ksplit] += a[t][:, cin - tail:] @ b[t, cin - tail:]
    out = parts[0]
    for part in parts[1:]:
        out = out + part
    return out.reshape(n, h, wd, cout).to(x.dtype)


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


def _sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _plan_args(dtype: torch.dtype, n: int, h: int, w: int, cin: int,
               cout: int, device: torch.device,
               plan: Optional[ConvF32Plan] = None):
    """The five plan arguments of the C entry points: an f32 launch's plan
    (path code, rows, cols, ksplit, stages), ``conv3x3_f32_plan``'s unless
    given; zeros for bf16, which picks its path itself."""
    if dtype != torch.float32:
        return 0, 0, 0, 0, 0
    plan = plan or conv3x3_f32_plan(n, h, w, cin, cout, _sms(device))
    return (CONV_PATHS.index(plan.path), plan.rows, plan.cols, plan.ksplit,
            plan.stages)


def _launch_conv(x: torch.Tensor, w: torch.Tensor, name: str,
                 plan: Optional[ConvF32Plan] = None,
                 cout: Optional[int] = None) -> torch.Tensor:
    """Kernel B1 on CUDA tensors (counted under ``name``), the plain version
    on CPU tensors; one launch for all members.  ``plan``: an f32 plan other
    than ``conv3x3_f32_plan``'s (the bench scripts' sweeps).  ``cout``: the
    output channels, the first of w's columns (f32: w's rows may be padded
    to a 16-byte stride); all of them by default."""
    if x.device.type == "cpu" and w.device.type == "cpu":
        return reference_conv3x3(x, w)
    _build.check_cuda_tensors(name, x.dtype, x=x, w=w)
    s = x.shape[0] if x.dim() == 5 else 1
    if s > MAX_GRID_Z:
        raise ValueError(f"{name}: {s} members exceed grid dimension z "
                         f"({MAX_GRID_Z})")
    n, h, wd, cin = x.shape[-4:]
    ldw = w.shape[-1]
    cout = ldw if cout is None else cout
    out = torch.empty(x.shape[:-1] + (cout,), dtype=x.dtype,
                      device=x.device)
    if out.numel() == 0:
        return out
    lib = _build.load("conv3x3")
    err = lib.conv3x3_same_launch(
        _build.DTYPE_CODES[x.dtype], x.data_ptr(), w.data_ptr(),
        out.data_ptr(), s, n, h, wd, cin, cout, ldw,
        *_plan_args(x.dtype, n, h, wd, cin, cout, x.device, plan),
        x.device.index,
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
    cin = w.shape[-2]
    if dy.dtype == torch.float32 and dy.device.type == "cuda" and cin % 4:
        # the f32 core copies weight rows by 16 bytes: w' in rows padded to
        # a multiple of 4 columns (MNIST's 65 -> 68), as one copy like
        # flip_weights'; a padding column only feeds an output column past
        # cin, which is never written
        wf = w.new_empty(w.shape[:-2] + (w.shape[-1], cin + -cin % 4))
        wf[..., :cin].copy_(w.flip(-4, -3).transpose(-2, -1))
        return _launch_conv(dy, wf, DGRAD_NAME, cout=cin)
    return _launch_conv(dy, flip_weights(w), DGRAD_NAME)


class WgradPlan(NamedTuple):
    """How the wgrad kernel runs a shape: ``path`` "tma" (bf16, TMA boxes
    into a ring, ``wgmma``), "split_k" (bf16, ``cp.async`` halo,
    ``mma.sync``) or "f32" (``cp.async`` halo, 8 x 4 FMA sums a lane, the
    channels past the last whole 32 folded into its block); ``splits`` K
    ranges summed apart, then in order; ``rows`` image rows per K step
    ("tma") or pixels per K step; ``stages`` ring slots; ``cluster``
    consecutive splits whose blocks add their sums in shared memory, in
    rank order, before one partial is written."""
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
    fit (at least two), and clusters of ``TMA_CLUSTER`` splits.  Other bf16
    shapes (the stem's Cin 3, MNIST's 65, other widths) take the split-K
    path, f32 the f32 path: K steps of ``WGRAD_F32_BK`` pixels, two ring
    slots (a third bought nothing on the H100: ``scripts/
    bench_conv_kernels.py --f32-sweep``), blocks of 32 Cin x 32 Cout, the
    channels past the last whole 32 folded into its block when at most
    ``WGRAD_F32_MAX_FOLD``.  K is cut into about one block per SM over the
    (Cin, Cout) tiles (the TMA path rounds down to whole clusters; the f32
    path, whose blocks fit two an SM, at most two, so one wave holds them),
    at most one range per step (the f32 path: ``WGRAD_F32_MIN_STEPS``).  A
    fleet's members (n images each) are each cut as a single run is, so
    their sums keep its order."""
    if dtype == torch.float32:
        fold = _wgrad_f32_fold(cin)
        tiles = -(-(cin - fold) // WGRAD_F32_CI) * -(-cout // WGRAD_F32_CO)
        steps = -(-n * h * w // WGRAD_F32_BK)
        splits = max(1, min(steps, 2 * sms // tiles,
                            -(-steps // WGRAD_F32_MIN_STEPS)))
        return WgradPlan("f32", splits, WGRAD_F32_BK, 2, 1)
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
    tiles = math.ceil(cin / 64) * math.ceil(cout / 64)
    steps = math.ceil(n * h * w / WGRAD_BK)
    return WgradPlan("split_k", max(1, min(steps, math.ceil(sms / tiles))),
                     WGRAD_BK, 3, 1)


def _wgrad_f32_fold(cin: int) -> int:
    """Cin channels the f32 path's fold warp sums: those past the last
    whole 32, if at most ``WGRAD_F32_MAX_FOLD`` and a whole 32 exists."""
    rem = cin % WGRAD_F32_CI
    return rem if cin > WGRAD_F32_CI and rem <= WGRAD_F32_MAX_FOLD else 0


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


def run_wgrad_f32_plan(x: torch.Tensor, dy: torch.Tensor, splits: int,
                       bk: int = WGRAD_F32_BK) -> torch.Tensor:
    """The f32 path's decomposition in plain torch, at least f32: K in
    steps of ``bk`` pixels cut into ``splits`` ranges, each range's sums
    apart; in a step, each block's 32 Cin channels (the last whole one with
    the folded channels as their own product) under each tap, the source
    pixel zero outside its image; the ranges' partials added in order.
    Rounds once to x's dtype."""
    n, h, w, cin = x.shape
    cout = dy.shape[3]
    xp = F.pad(_wide(x), (0, 0, 1, 1, 1, 1))
    a = [xp[:, t // 3:t // 3 + h, t % 3:t % 3 + w].reshape(-1, cin)
         for t in range(9)]
    d = _wide(dy).reshape(-1, cout)
    fold = _wgrad_f32_fold(cin)
    chunks = [(c, min(c + WGRAD_F32_CI, cin - fold))
              for c in range(0, cin - fold, WGRAD_F32_CI)]
    if fold:
        chunks.append((cin - fold, cin))
    steps = -(-d.shape[0] // bk)
    out = None
    for split in range(splits):
        acc = d.new_zeros(9, cin, cout)
        for g in range(steps * split // splits,
                       steps * (split + 1) // splits):
            p0, p1 = g * bk, (g + 1) * bk
            for c0, c1 in chunks:
                for t in range(9):
                    acc[t, c0:c1] += a[t][p0:p1, c0:c1].t() @ d[p0:p1]
        out = acc if out is None else out + acc
    return out.reshape(3, 3, cin, cout).to(x.dtype)


def conv3x3_path(n: int, h: int, w: int, cin: int, cout: int,
                 dtype: torch.dtype, device: torch.device) -> str:
    """The kernel B1 runs for these shapes on a CUDA device (a name of
    ``CONV_PATHS``), as the C launcher takes it: bf16 the path it picks,
    f32 ``conv3x3_f32_plan``'s, which the launcher must accept."""
    device = torch.device(device)
    if device.index is None:
        device = torch.device(device.type, torch.cuda.current_device())
    lib = _build.load("conv3x3")
    code = lib.conv3x3_path(_build.DTYPE_CODES[dtype], n, h, w, cin, cout,
                            *_plan_args(dtype, n, h, w, cin, cout, device),
                            device.index)
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
    atomics, so two calls give the same bits.  One count per call.  On the
    split-K and f32 paths a block holds two or three K steps' input halos
    (BK + 2 W + 2 pixel rows each), so images wider than about 170 pixels
    (bf16) or 340 (f32) do not fit its shared memory and the launch
    raises."""
    if x.dim() not in (4, 5) or dy.dim() != x.dim() \
            or x.shape[:-1] != dy.shape[:-1]:
        raise ValueError(f"conv3x3_wgrad: x {tuple(x.shape)} and dy "
                         f"{tuple(dy.shape)} are not ([S,]N,H,W,C), "
                         "([S,]N,H,W,Co)")
    if x.device.type == "cpu" and dy.device.type == "cpu":
        return reference_conv3x3_wgrad(x, dy)
    _build.check_cuda_tensors(WGRAD_NAME, x.dtype, x=x, dy=dy)
    n, h, wd, cin = x.shape[-4:]
    plan = wgrad_plan(n, h, wd, cin, dy.shape[-1], x.dtype, _sms(x.device),
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
    refuses it (the TMA path launches once a member); so does the f32
    path."""
    s = x.shape[0] if x.dim() == 5 else 1
    if plan.path != "tma" and s * plan.splits > MAX_GRID_Z:
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
    if backend.kernel_ops():
        return torch.ops.nodems.conv3x3_same(x, w)  # ops/library.py
    return _launch_conv(x, w, KERNEL_NAME)
