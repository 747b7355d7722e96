"""The port's CUDA kernels against their plain versions, on the card.

These tests need an NVIDIA card with ``nvcc``; without one they skip.  This
file imports no JAX, so it runs where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from neural_ode_metasolver_tpu_torch.backend import full_f32

    with full_f32():  # the plain versions' cuDNN convs in full f32
        yield torch.device("cuda")


def _randn(shape, scale, seed, dev, dtype):
    rs = np.random.RandomState(seed)
    return torch.tensor(rs.randn(*shape).astype(np.float32) * scale,
                        device=dev).to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [
    (2, 8, 8, 3, 64),          # Cin 3: element copies, K padded
    (3, 13, 21, 40, 72),       # Cin 40, Cout 72: a ragged Cout tile
    (2, 16, 16, 128, 128),     # 16-byte copies, 128-wide tiles
    (4, 6, 6, 65, 64),         # Cin 65: element copies
    (3, 6, 6, 65, 64),         # M = 108: one tile across three images
    (1, 6, 6, 65, 64),         # M = 36: a mostly empty tile
    (2, 9, 11, 64, 64),        # 16-byte copies, M = 198 not a tile multiple
    (1, 2, 720, 64, 64),       # bf16: a halo too wide for shared memory
])
def test_conv3x3_kernel_matches_plain(dev, dtype, shape):
    from neural_ode_metasolver_tpu_torch import (
        launch_counts,
        reset_launch_counts,
    )
    from neural_ode_metasolver_tpu_torch.ops.conv3x3 import (
        conv3x3_same,
        reference_conv3x3,
    )

    n, h, w, cin, cout = shape
    x = _randn((n, h, w, cin), 1.0, 0, dev, dtype)
    k = _randn((3, 3, cin, cout), (9 * cin) ** -0.5, 1, dev, dtype)
    reset_launch_counts()
    got = conv3x3_same(x, k)
    torch.cuda.synchronize()
    assert launch_counts() == {"conv3x3_same": 1}
    ref = reference_conv3x3(x, k)
    # f32: sum order only; bf16: one rounding flip (2**-7 of the max)
    bar = 1e-4 if dtype == torch.float32 else 2.0 ** -7 * ref.float().abs().max()
    assert (got.float() - ref.float()).abs().max() <= bar


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("u,n_steps,shape", [
    (0.5, 2, (2, 12, 20, 64)), (2 / 3, 3, (2, 12, 20, 64)),
    (0.5, 1, (2, 12, 20, 64)),   # the first step's gelu meets the last step
    (0.5, 2, (2, 16, 16, 128)),  # 128-wide tiles
])
def test_ode_block_kernel_matches_plain(dev, dtype, u, n_steps, shape):
    from neural_ode_metasolver_tpu_torch import (
        launch_counts,
        reset_launch_counts,
    )
    from neural_ode_metasolver_tpu_torch.ops.ode_block import (
        ode_block_rk2_forward,
        reference_ode_block_rk2,
    )

    c = shape[-1]
    y0 = _randn(shape, 0.5, 0, dev, dtype)
    w1 = _randn((3, 3, c, c), (9 * c) ** -0.5, 1, dev, dtype)
    w2 = _randn((3, 3, c, c), (9 * c) ** -0.5, 2, dev, dtype)
    y0_copy = y0.clone()
    reset_launch_counts()
    got = ode_block_rk2_forward(y0, w1, w2, u, n_steps)
    torch.cuda.synchronize()
    # one elementwise gelu of y0, then four convs per step
    assert launch_counts() == {"ode_block_rk2": 4 * n_steps + 1}
    assert torch.equal(y0, y0_copy)  # the input is never written
    ref = reference_ode_block_rk2(y0, w1, w2, u, n_steps)
    bar = 1e-4 if dtype == torch.float32 else 2.0 ** -5 * ref.float().abs().max()
    assert (got.float() - ref.float()).abs().max() <= bar


def _gn_inputs(shape, dev, dtype):
    c = shape[-1]
    x = (_randn(shape, 2.0, 0, dev, torch.float32) + 0.5).to(dtype)
    scale = _randn((c,), 0.3, 1, dev, torch.float32) + 1.0
    bias = _randn((c,), 0.5, 2, dev, torch.float32)
    return x, scale, bias


def _gn_bar(ref, dtype):
    """f32: the JAX test's 2e-4; bf16: both round once at the same point,
    two bf16 ulps of the largest output."""
    refmax = ref.float().abs().max()
    return (2e-4 * max(1.0, refmax) if dtype == torch.float32
            else 2.0 ** -6 * refmax)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,groups,act", [
    ((2, 26, 26, 64), 32, "relu"),   # cluster path
    ((2, 13, 13, 64), 32, "relu"),   # register path, one sample a block
    ((3, 6, 6, 64), 32, "relu"),     # cg 2, 4 warps a sample
    ((3, 6, 6, 64), 32, None),
    ((2, 7, 5, 96), 32, "gelu"),     # cg 3: re-read, shared-memory sums
    ((2, 4, 4, 16), 16, "tanh"),     # cg 1
    ((2, 3, 3, 640), 32, "softsign"),  # cg 20, 160 columns a pixel
    ((2, 30, 30, 128), 32, "relu"),  # a cluster of 8 (f32)
    ((3, 6, 6, 32), 32, "relu"),     # cg 1, shuffles
    ((2, 7, 5, 96), 8, "relu"),      # cg 12
    ((2, 5, 5, 6), 3, "relu"),       # C * 4 bytes not a multiple of 16
    ((3, 5, 5, 4), 2, "gelu"),       # one vector a pixel; bf16 one element
    ((2, 1, 1, 64), 32, "relu"),     # HW = 1
    ((1, 6, 6, 64), 32, "relu"),     # N = 1
    ((1, 29, 31, 64), 32, "relu"),   # a ragged last slice of the cluster
    ((1, 48, 48, 128), 32, "relu"),  # too large for 8 blocks: re-read
    ((1, 2, 2, 1056), 32, "relu"),   # C > 1024
    ((1, 2, 2, 1040), 8, None),      # cg 130
    ((1, 1, 2, 4096), 4096, None),   # 80 KB of group statistics: opt-in
    # the CIFAR GN nets (metanode10, 32 groups): exact GELU fused, and the
    # basic block's bn2 and shortcut norm without one; LN (one group) and
    # IN (a group a channel)
    ((8, 32, 32, 64), 32, "gelu"),
    ((8, 32, 32, 64), 32, None),
    ((8, 16, 16, 128), 32, "gelu"),  # cg 4: four bf16 channels, 8 bytes
    ((8, 16, 16, 128), 32, None),
    ((8, 32, 32, 64), 1, "gelu"),
    ((8, 16, 16, 128), 128, None),
])
def test_group_norm_kernel_matches_plain(dev, dtype, shape, groups, act):
    from neural_ode_metasolver_tpu_torch import (
        launch_counts,
        reset_launch_counts,
    )
    from neural_ode_metasolver_tpu_torch.ops.group_norm import (
        fused_group_norm_act,
        group_norm_reference,
    )

    x, scale, bias = _gn_inputs(shape, dev, dtype)
    reset_launch_counts()
    got = fused_group_norm_act(x, scale, bias, groups, act=act)
    torch.cuda.synchronize()
    assert launch_counts() == {"group_norm_act": 1}
    assert got.dtype == dtype and got.shape == x.shape
    ref = group_norm_reference(x, scale, bias, groups, act=act)
    assert (got.float() - ref.float()).abs().max() <= _gn_bar(ref, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_group_norm_kernel_takes_an_unaligned_view(dev, dtype):
    from neural_ode_metasolver_tpu_torch.ops.group_norm import (
        fused_group_norm_act,
        group_norm_reference,
        launch_plan,
    )

    shape = (3, 6, 6, 64)
    x, scale, bias = _gn_inputs(shape, dev, dtype)
    buf = torch.empty(x.numel() + 1, device=dev, dtype=dtype)
    xv = buf[1:].view(shape)  # contiguous, data_ptr 2 or 4 bytes past 16
    xv.copy_(x)
    assert xv.is_contiguous() and xv.data_ptr() % 16
    assert launch_plan(*shape, 32, dtype, aligned=False).vec == 1
    got = fused_group_norm_act(xv, scale, bias, 32, act="relu")
    ref = group_norm_reference(x, scale, bias, 32, act="relu")
    assert (got.float() - ref.float()).abs().max() <= _gn_bar(ref, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [
    (4, 6, 6, 64), (2, 26, 26, 64), (1, 48, 48, 128), (2, 7, 5, 96),
])
def test_group_norm_kernel_repeats_its_bits(dev, dtype, shape):
    from neural_ode_metasolver_tpu_torch.ops.group_norm import (
        fused_group_norm_act,
    )

    x, scale, bias = _gn_inputs(shape, dev, dtype)
    a = fused_group_norm_act(x, scale, bias, 32, act="gelu")
    b = fused_group_norm_act(x, scale, bias, 32, act="gelu")
    assert torch.equal(a, b)


def test_served_mnist_matches_plain_path_with_its_launch_counts(dev):
    from neural_ode_metasolver_tpu_torch import (
        launch_counts,
        reset_launch_counts,
    )
    from neural_ode_metasolver_tpu_torch.models import build_model
    from neural_ode_metasolver_tpu_torch.ops import parse_solver_dsl
    from neural_ode_metasolver_tpu_torch.serving import ServedModel

    model = build_model("mnist", dim=64,
                        generator=torch.Generator().manual_seed(0))
    solvers = parse_solver_dsl("rk2,u,8,-1,0.5,-1")
    x = torch.tensor(np.random.RandomState(0).rand(4, 28, 28, 1)
                     .astype(np.float32), device=dev)
    # PyTorch's default lets cuDNN take TF32; the model pins full f32
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    reset_launch_counts()
    got = ServedModel(model, solvers)(x)
    torch.cuda.synchronize()
    assert launch_counts() == {"group_norm_act": 51, "conv3x3_same": 32}
    with torch.inference_mode():
        ref = model(x, solvers, use_kernels=False)
    assert got.shape == (4, 10)
    bar = 1e-4 * max(1.0, ref.abs().max().item())
    assert (got - ref).abs().max().item() <= bar


def test_wrappers_raise_on_inputs_the_kernels_do_not_take(dev):
    from neural_ode_metasolver_tpu_torch.ops.conv3x3 import conv3x3_same
    from neural_ode_metasolver_tpu_torch.ops.group_norm import (
        fused_group_norm_act,
    )
    from neural_ode_metasolver_tpu_torch.ops.ode_block import (
        ode_block_rk2_forward,
    )

    x = torch.zeros(1, 8, 8, 16, device=dev)
    k = torch.zeros(3, 3, 16, 16, device=dev)
    with pytest.raises(TypeError):
        conv3x3_same(x, k.to(torch.bfloat16))
    with pytest.raises(TypeError):
        conv3x3_same(x.half(), k.half())
    with pytest.raises(ValueError):
        conv3x3_same(x.transpose(1, 2), k)
    with pytest.raises(ValueError):
        conv3x3_same(x, k.cpu())
    with pytest.raises(ValueError):
        ode_block_rk2_forward(x, k.cpu(), k, 0.5, 2)
    s = torch.ones(16, device=dev)
    with pytest.raises(TypeError):
        fused_group_norm_act(x, s.to(torch.bfloat16), s, 8)
    with pytest.raises(ValueError):
        fused_group_norm_act(x, s.cpu(), s.cpu(), 8)
    with pytest.raises(ValueError):
        fused_group_norm_act(x.transpose(1, 2), s, s, 8)


# (N, H, W, Cin, Cout) of the forward conv whose backward runs
B1_BWD_SHAPES = [
    (256, 32, 32, 3, 64),      # the flagship stem (its dgrad: 64 -> 3)
    (256, 32, 32, 64, 64),     # layer 1
    (256, 16, 16, 128, 128),   # layer 2
    (3, 13, 21, 40, 72),       # ragged M, Cout 72
    (2, 8, 8, 64, 3),          # Cout 3
    (2, 9, 11, 5, 16),         # Cin 5: element copies in both dtypes
    (1, 6, 6, 65, 64),         # Cin 65, M = 36: a mostly empty K step
    (4, 32, 32, 64, 64),       # wgrad bf16 on TMA: 4 rows a step
    (2, 16, 16, 128, 128),     # wgrad bf16 on TMA: 2 x 2 channel tiles
    (3, 8, 24, 64, 128),       # wgrad TMA, W 24 (4 rows), one Cin tile
                               # and two Cout tiles
    (4, 8, 8, 64, 64),         # wgrad TMA, W 8: the cluster's staged tile
                               # is larger than the ring
    (2, 8, 8, 5, 64),          # dgrad 64 -> 5 on the narrow halo path (n8)
    (2, 8, 8, 12, 64),         # dgrad 64 -> 12 on the narrow halo path (n16)
    (2, 8, 8, 64, 5),          # Cout 5 and 12: wgrad split-K, the forward's
    (2, 8, 8, 64, 12),         # conv on the narrow halo path (autograd)
    (128, 6, 6, 65, 64),       # the MNIST train step's ConcatConv2d
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", B1_BWD_SHAPES)
def test_conv3x3_dgrad_kernel_matches_plain(dev, dtype, shape):
    from neural_ode_metasolver_tpu_torch import (
        launch_counts,
        reset_launch_counts,
    )
    from neural_ode_metasolver_tpu_torch.ops.conv3x3 import (
        conv3x3_dgrad,
        flip_weights,
        reference_conv3x3,
    )

    n, h, w, cin, cout = shape
    dy = _randn((n, h, w, cout), 1.0, 0, dev, dtype)
    k = _randn((3, 3, cin, cout), (9 * cout) ** -0.5, 1, dev, dtype)
    reset_launch_counts()
    got = conv3x3_dgrad(dy, k)
    torch.cuda.synchronize()
    assert launch_counts() == {"conv3x3_dgrad": 1}
    assert got.shape == (n, h, w, cin) and got.dtype == dtype
    ref = reference_conv3x3(dy, flip_weights(k))
    refmax = ref.float().abs().max()
    # B1's bars: f32 sum order only; bf16 one rounding flip
    bar = 1e-4 * max(1.0, refmax) if dtype == torch.float32 else 2.0 ** -7 * refmax
    assert (got.float() - ref.float()).abs().max() <= bar


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", B1_BWD_SHAPES)
def test_conv3x3_wgrad_kernel_matches_plain(dev, dtype, shape):
    from neural_ode_metasolver_tpu_torch import (
        launch_counts,
        reset_launch_counts,
    )
    from neural_ode_metasolver_tpu_torch.ops.conv3x3 import (
        conv3x3_wgrad,
        reference_conv3x3_wgrad,
    )

    n, h, w, cin, cout = shape
    x = _randn((n, h, w, cin), 1.0, 0, dev, dtype)
    dy = _randn((n, h, w, cout), 1.0, 1, dev, dtype)
    reset_launch_counts()
    got = conv3x3_wgrad(x, dy)
    torch.cuda.synchronize()
    assert launch_counts() == {"conv3x3_wgrad": 1}
    assert got.shape == (3, 3, cin, cout) and got.dtype == dtype
    ref = reference_conv3x3_wgrad(x, dy)
    refmax = ref.float().abs().max()
    # f32: sums over N*H*W pixels in another order, 1e-5 of the largest;
    # bf16: products exact, sums f32, one rounding flip
    bar = 1e-5 * max(1.0, refmax) if dtype == torch.float32 else 2.0 ** -7 * refmax
    assert (got.float() - ref.float()).abs().max() <= bar


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(8, 32, 32, 64, 64), (256, 16, 16, 128, 128),
                                   (5, 7, 9, 3, 72), (256, 32, 32, 64, 64),
                                   (3, 8, 24, 64, 128), (128, 6, 6, 65, 64)])
def test_conv3x3_wgrad_kernel_repeats_its_bits(dev, dtype, shape):
    """Fixed-order sums of the K ranges: two launches, the same bits."""
    from neural_ode_metasolver_tpu_torch.ops.conv3x3 import conv3x3_wgrad

    n, h, w, cin, cout = shape
    x = _randn((n, h, w, cin), 1.0, 2, dev, dtype)
    dy = _randn((n, h, w, cout), 1.0, 3, dev, dtype)
    assert torch.equal(conv3x3_wgrad(x, dy), conv3x3_wgrad(x, dy))


@pytest.mark.parametrize("n,h,w,kind", [
    (2, 8, 16, "tma"),     # 4 rows a step, two clusters of two splits
    (3, 7, 24, "tma"),     # 4 rows a step: a tail step past the image
    (2, 8, 7, "split_k"),  # W 7
])
def test_conv3x3_wgrad_kernel_pins_each_tap(dev, n, h, w, kind):
    """One-hot x in bf16: each (ci) row of dW is a single dy pixel per tap,
    or zero where the source pixel lies outside the image, so the kernel
    must give those bits exactly: at the corners, on the edges, inside."""
    from neural_ode_metasolver_tpu_torch.ops.conv3x3 import (
        conv3x3_wgrad,
        wgrad_plan,
    )

    cin, cout = 64, 64
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    assert wgrad_plan(n, h, w, cin, cout, torch.bfloat16, sms).path == kind
    x = torch.zeros(n, h, w, cin, device=dev, dtype=torch.bfloat16)
    hot = [(0, 0, 0), (0, 0, w - 1), (n - 1, h - 1, 0), (n - 1, h - 1, w - 1),
           (0, 3, 5), (n - 1, 4, w - 1), (1, 0, 4), (0, h - 1, 2)]
    for ci, (img, r, c) in enumerate(hot):
        x[img, r, c, ci] = 1.0
    dy = _randn((n, h, w, cout), 1.0, 10, dev, torch.bfloat16)
    got = conv3x3_wgrad(x, dy)
    want = torch.zeros(3, 3, cin, cout, device=dev, dtype=torch.bfloat16)
    for ci, (img, r, c) in enumerate(hot):
        for kh in range(3):
            for kw in range(3):
                hh, ww = r - kh + 1, c - kw + 1
                if 0 <= hh < h and 0 <= ww < w:
                    want[kh, kw, ci] = dy[img, hh, ww]
    assert torch.equal(got, want)


def test_conv3x3_paths_on_the_card(dev):
    """The path B1's launcher takes: the stem's 64 -> 3 dgrad and any Cout
    under 16 with Cin a multiple of 64 on the narrow halo kernel, the
    train step's other convs on the wide one; f32 on the f32 core's
    halo."""
    from neural_ode_metasolver_tpu_torch.ops.conv3x3 import conv3x3_path

    bf = torch.bfloat16
    assert conv3x3_path(256, 32, 32, 64, 3, bf, dev) == "halo_narrow"
    assert conv3x3_path(2, 8, 8, 64, 12, bf, dev) == "halo_narrow"
    assert conv3x3_path(2, 8, 8, 128, 8, bf, dev) == "halo_narrow"
    assert conv3x3_path(256, 32, 32, 64, 64, bf, dev) == "halo"
    assert conv3x3_path(256, 16, 16, 128, 128, bf, dev) == "halo"
    assert conv3x3_path(2, 8, 8, 64, 16, bf, dev) == "halo"
    assert conv3x3_path(256, 32, 32, 3, 64, bf, dev) == "gather_elements"
    assert conv3x3_path(256, 32, 32, 64, 3, torch.float32, dev) \
        == "f32_halo"
    assert conv3x3_path(1, 2, 720, 64, 64, bf, dev) == "gather"


# ------------------------------------------- the f32 core and f32 wgrad
# Forward shapes (N, H, W, Cin, Cout); each runs B1, its dgrad (Cout ->
# Cin) and the wgrad.  f32 bars: B1 and the dgrad 1e-4 of the largest
# output, the wgrad 1e-5 (sums in another order only).
F32_SHAPES = [
    (2, 6, 6, 65, 64),     # MNIST's ConcatConv2d: the 65th channel's step;
                           # its dgrad 64 -> 65 on one 72-wide tile
    (4, 1, 1, 65, 64),     # 1x1: only the centre tap inside the image
    (3, 13, 13, 1, 64),    # Cin 1 and 3: the nine-tap step alone
    (3, 13, 13, 3, 64),
    (2, 26, 26, 33, 64),   # Cin 33: a whole chunk and one channel folded
    (1, 6, 6, 129, 64),    # Cin 129: four chunks and one channel
    (2, 13, 13, 64, 1),    # Cout 1 and 3 (the dgrad's Cin 1 and 3)
    (2, 13, 13, 64, 3),
    (2, 26, 26, 40, 65),   # a short chunk of 8 channels; Cout 65
    (2, 32, 32, 64, 64),
    (1, 3, 150, 36, 8),    # W > rows + 2: the bands; Cin 36 folds 4
]


@pytest.mark.parametrize("shape", F32_SHAPES)
def test_f32_core_and_wgrad_match_plain(dev, shape):
    """B1's f32 core forward and dgrad, each on the path its plan names,
    and the f32 wgrad on its plan, against their plain versions."""
    from neural_ode_metasolver_tpu_torch import (
        launch_counts,
        reset_launch_counts,
    )
    from neural_ode_metasolver_tpu_torch.ops.conv3x3 import (
        conv3x3_dgrad,
        conv3x3_f32_plan,
        conv3x3_path,
        conv3x3_same,
        conv3x3_wgrad,
        flip_weights,
        reference_conv3x3,
        reference_conv3x3_wgrad,
        wgrad_plan,
    )

    f32 = torch.float32
    n, h, w, cin, cout = shape
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for ci, co in ((cin, cout), (cout, cin)):
        assert conv3x3_path(n, h, w, ci, co, f32, dev) == \
            conv3x3_f32_plan(n, h, w, ci, co, sms).path
    assert wgrad_plan(n, h, w, cin, cout, f32, sms).path == "f32"
    x = _randn((n, h, w, cin), 1.0, 0, dev, f32)
    k = _randn((3, 3, cin, cout), (9 * cin) ** -0.5, 1, dev, f32)
    dy = _randn((n, h, w, cout), 1.0, 2, dev, f32)
    reset_launch_counts()
    y, dx, dw = (conv3x3_same(x, k), conv3x3_dgrad(dy, k),
                 conv3x3_wgrad(x, dy))
    torch.cuda.synchronize()
    assert launch_counts() == {"conv3x3_same": 1, "conv3x3_dgrad": 1,
                               "conv3x3_wgrad": 1}
    for got, ref, rel in ((y, reference_conv3x3(x, k), 1e-4),
                          (dx, reference_conv3x3(dy, flip_weights(k)), 1e-4),
                          (dw, reference_conv3x3_wgrad(x, dy), 1e-5)):
        assert got.shape == ref.shape
        bar = rel * max(1.0, ref.abs().max().item())
        assert (got - ref).abs().max().item() <= bar


def test_f32_kernels_replace_the_old_instances(dev):
    """The f32 convs of B1 and B2 run the f32 core, the f32 wgrad its f32
    path: no float instance of the bf16 gather kernel or of the split-K
    wgrad kernel is left in the libraries."""
    from neural_ode_metasolver_tpu_torch import _build

    _build.build_all()
    for lib in ("conv3x3", "ode_block_rk2"):
        names = _build.kernel_names(lib)
        assert any("conv3x3_f32_kernel" in k for k in names)
        assert not any("conv3x3_igemm_kernelIf" in k for k in names)
    names = _build.kernel_names("conv3x3_wgrad")
    assert any("wgrad_f32_kernel" in k for k in names)
    assert not any("wgrad_partial_kernelIf" in k for k in names)


def test_f32_launches_refuse_plans_they_cannot_run(dev):
    """The C entry points check the plan they are given: a tile, a path,
    a ring or a wgrad path the kernel cannot run is refused (the launch
    returns an error, the path query -1), never run another way."""
    from neural_ode_metasolver_tpu_torch import _build
    from neural_ode_metasolver_tpu_torch.ops.conv3x3 import (
        CONV_PATHS,
        WGRAD_PATHS,
    )

    lib = _build.load("conv3x3")
    n, h, w, cin, cout = 2, 6, 6, 65, 64
    halo = CONV_PATHS.index("f32_halo")
    bands = CONV_PATHS.index("f32_bands")
    good = (halo, 32, 64, 4, 4)
    assert lib.conv3x3_path(0, n, h, w, cin, cout, *good, dev.index or 0) \
        == halo
    bad = [(halo, 48, 64, 4, 4), (halo, 32, 64, 2, 4), (halo, 32, 80, 4, 4),
           (halo, 32, 64, 4, 5), (halo, 32, 64, 4, 1), (bands, 32, 64, 4, 4),
           (CONV_PATHS.index("gather"), 32, 64, 4, 4)]
    for plan in bad:
        assert lib.conv3x3_path(0, n, h, w, cin, cout, *plan,
                                dev.index or 0) == -1
    x = _randn((n, h, w, cin), 1.0, 0, dev, torch.float32)
    k = _randn((3, 3, cin, cout), 0.1, 1, dev, torch.float32)
    out = torch.empty(n, h, w, cout, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    for plan in bad:
        assert lib.conv3x3_same_launch(0, x.data_ptr(), k.data_ptr(),
                                       out.data_ptr(), 1, n, h, w, cin, cout,
                                       cout, *plan, dev.index or 0,
                                       stream) != 0
    # a row stride below Cout, and bf16 with a padded one
    assert lib.conv3x3_same_launch(0, x.data_ptr(), k.data_ptr(),
                                   out.data_ptr(), 1, n, h, w, cin, cout,
                                   cout - 1, *good, dev.index or 0,
                                   stream) != 0
    xb, kb, ob = (t.to(torch.bfloat16) for t in (x, k, out))
    assert lib.conv3x3_same_launch(1, xb.data_ptr(), kb.data_ptr(),
                                   ob.data_ptr(), 1, n, h, w, cin, cout - 4,
                                   cout, *good, dev.index or 0, stream) != 0
    wlib = _build.load("conv3x3_wgrad")
    dy = _randn((n, h, w, cout), 1.0, 2, dev, torch.float32)
    ws = torch.empty(9 * cin * cout, device=dev)
    dw = torch.empty(3, 3, cin, cout, device=dev)
    f32p, splitk = WGRAD_PATHS.index("f32"), WGRAD_PATHS.index("split_k")
    xb, dyb, dwb = (t.to(torch.bfloat16) for t in (x, dy, dw))
    for dtype, (xx, dd, oo), plan in (
            (0, (x, dy, dw), (splitk, 1, 64, 3, 1)),  # f32 on split-K
            (0, (x, dy, dw), (f32p, 1, 32, 3, 1)),    # another K step
            (0, (x, dy, dw), (f32p, 1, 64, 4, 1)),    # four ring slots
            (0, (x, dy, dw), (f32p, 1, 64, 3, 2)),    # a cluster
            (0, (x, dy, dw), (f32p, 3, 64, 3, 1)),    # ranges past K steps
            (1, (xb, dyb, dwb), (f32p, 1, 64, 3, 1))):  # bf16 on the f32 path
        assert wlib.conv3x3_wgrad_launch(
            dtype, xx.data_ptr(), dd.data_ptr(), ws.data_ptr(),
            oo.data_ptr(), 1, n, h, w, cin, cout, *plan, dev.index or 0,
            stream) != 0


@pytest.mark.parametrize("c,hw", [(64, 32), (128, 16)])
def test_ode_block_f32_runs_the_f32_core_plan(dev, c, hw):
    """B2's f32 launches run the f32 core on the plan its C entry point
    accepts (the flagship ODE blocks' shapes at batch 2), and the solve
    matches its plain version at B2's f32 bar."""
    from neural_ode_metasolver_tpu_torch import (
        launch_counts,
        reset_launch_counts,
    )
    from neural_ode_metasolver_tpu_torch.ops.conv3x3 import (
        conv3x3_f32_plan,
        conv3x3_path,
    )
    from neural_ode_metasolver_tpu_torch.ops.ode_block import (
        ode_block_rk2_forward,
        reference_ode_block_rk2,
    )

    f32 = torch.float32
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    assert conv3x3_path(2, hw, hw, c, c, f32, dev) == \
        conv3x3_f32_plan(2, hw, hw, c, c, sms).path
    y0 = _randn((2, hw, hw, c), 0.5, 0, dev, f32)
    w1 = _randn((3, 3, c, c), (9 * c) ** -0.5, 1, dev, f32)
    w2 = _randn((3, 3, c, c), (9 * c) ** -0.5, 2, dev, f32)
    reset_launch_counts()
    got = ode_block_rk2_forward(y0, w1, w2, 0.5, 2)
    torch.cuda.synchronize()
    assert launch_counts() == {"ode_block_rk2": 9}
    ref = reference_ode_block_rk2(y0, w1, w2, 0.5, 2)
    assert (got - ref).abs().max() <= 1e-4


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(4, 16, 16, 3, 64), (2, 8, 8, 64, 64),
                                   (2, 8, 8, 128, 3)])
def test_conv3x3_autograd_matches_conv2d(dev, dtype, shape):
    """B1's autograd grads (dgrad and wgrad kernels) against F.conv2d's."""
    import torch.nn.functional as F

    from neural_ode_metasolver_tpu_torch import (
        launch_counts,
        reset_launch_counts,
    )
    from neural_ode_metasolver_tpu_torch.ops.conv3x3 import conv3x3_same

    n, h, w, cin, cout = shape
    x = _randn((n, h, w, cin), 1.0, 4, dev, dtype).requires_grad_(True)
    k = _randn((3, 3, cin, cout), (9 * cin) ** -0.5, 5, dev,
               dtype).requires_grad_(True)
    dy = _randn((n, h, w, cout), 1.0, 6, dev, dtype)
    reset_launch_counts()
    gx, gk = torch.autograd.grad(conv3x3_same(x, k), [x, k], dy)
    torch.cuda.synchronize()
    assert launch_counts() == {"conv3x3_same": 1, "conv3x3_dgrad": 1,
                               "conv3x3_wgrad": 1}
    x2, k2 = x.detach().float().requires_grad_(), k.detach().float().requires_grad_()
    y2 = F.conv2d(x2.permute(0, 3, 1, 2), k2.permute(3, 2, 0, 1), padding=1)
    rx, rk = torch.autograd.grad(y2.permute(0, 2, 3, 1), [x2, k2], dy.float())
    for got, ref in ((gx, rx), (gk, rk)):
        assert got.dtype == dtype
        refmax = ref.abs().max()
        bar = 1e-5 * max(1.0, refmax) if dtype == torch.float32 else 2.0 ** -7 * refmax
        assert (got.float() - ref).abs().max() <= bar


def test_forward_only_kernels_refuse_a_gradient(dev):
    """B2 has no backward: on CUDA tensors that require grad it raises
    instead of returning an output cut off from autograd.  B3 has one now:
    its output carries a grad_fn, and the gradient runs its backward
    kernel."""
    from neural_ode_metasolver_tpu_torch import (
        launch_counts,
        reset_launch_counts,
    )
    from neural_ode_metasolver_tpu_torch.ops.group_norm import (
        fused_group_norm_act,
        group_norm_backward_reference,
    )
    from neural_ode_metasolver_tpu_torch.ops.ode_block import (
        ode_block_rk2_forward,
    )

    y0 = _randn((1, 8, 8, 64), 0.5, 7, dev, torch.float32)
    w = _randn((3, 3, 64, 64), 0.05, 8, dev, torch.float32)
    s = torch.ones(64, device=dev)
    reset_launch_counts()
    with pytest.raises(RuntimeError, match="forward-only"):
        ode_block_rk2_forward(y0.requires_grad_(True), w, w, 0.5, 1)
    with pytest.raises(RuntimeError, match="forward-only"):
        ode_block_rk2_forward(y0.detach(), w.requires_grad_(True), w, 0.5, 1)
    assert launch_counts() == {}
    out = fused_group_norm_act(y0, s, s, 32, act="relu")
    assert out.grad_fn is not None
    g = _randn(tuple(y0.shape), 1.0, 9, dev, torch.float32)
    (dx,) = torch.autograd.grad(out, y0, g)
    ref = group_norm_backward_reference(y0.detach(), s, s, g, 32,
                                        act="relu")[0]
    assert (dx - ref).abs().max() <= 1e-4 * max(1.0, ref.abs().max())
    with torch.no_grad():
        ode_block_rk2_forward(y0, w, w, 0.5, 1)
    assert launch_counts() == {"ode_block_rk2": 5, "group_norm_act": 1,
                               "group_norm_act_bwd": 1}


# (shape, groups, act) of B3's backward: the MNIST train step's shapes at
# batch 128, the off-path (256, 32, 32, 64), ragged C, every activation
GN_BWD_CASES = [
    ((128, 26, 26, 64), 32, "relu"),   # staged, cluster of 4 (f32), 3 (bf16)
    ((128, 13, 13, 64), 32, "relu"),   # staged, one 4-warp block
    ((128, 6, 6, 64), 32, "relu"),
    ((128, 6, 6, 64), 32, None),
    ((256, 32, 32, 64), 32, "relu"),   # staged, cluster of 5 (f32), 4 (bf16)
    ((2, 6, 6, 48), 16, "relu"),       # cg 3: re-read
    ((1, 2, 2, 1056), 32, "relu"),     # C > 1024: re-read, 4 columns a thread
    ((3, 6, 6, 64), 32, "gelu"),
    ((2, 13, 13, 64), 32, "tanh"),
    ((2, 7, 5, 96), 8, "softsign"),    # cg 12
    ((2, 5, 5, 6), 3, "gelu"),         # one-element access
    ((1, 29, 31, 64), 32, "relu"),     # a ragged last slice of the cluster
    ((1, 48, 48, 128), 32, "relu"),    # too large for 8 blocks: re-read
    ((1, 112, 112, 64), 32, "gelu"),   # re-read, dxhat beyond shared memory:
                                       # pass 4 evaluates act' again
    # the CIFAR GN nets' shapes (see the forward's cases)
    ((8, 32, 32, 64), 32, "gelu"),
    ((8, 32, 32, 64), 32, None),
    ((8, 16, 16, 128), 32, "gelu"),
    ((8, 16, 16, 128), 32, None),
    ((8, 32, 32, 64), 1, "gelu"),
    ((8, 16, 16, 128), 128, None),
]


def _gn_bwd_bars(ref, dtype, terms):
    """dx: f32 the sum order (1e-4 of the largest), bf16 one rounding at the
    same point, two bf16 ulps of the largest; dscale, dbias: f32 sums of
    N*H*W terms in another order, 1e-5 of the sum of their magnitudes."""
    dx_bar = (1e-4 * max(1.0, ref.float().abs().max())
              if dtype == torch.float32 else 2.0 ** -6 * ref.float().abs().max())
    return dx_bar, [1e-5 * max(1.0, t) for t in terms]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,groups,act", GN_BWD_CASES)
def test_group_norm_backward_kernel_matches_plain(dev, dtype, shape, groups,
                                                  act):
    """dx, dscale and dbias of the full launch against
    group_norm_backward_reference; the dx-only launch gives the same dx
    bits; two full launches repeat their bits."""
    from neural_ode_metasolver_tpu_torch import (
        launch_counts,
        reset_launch_counts,
    )
    from neural_ode_metasolver_tpu_torch.ops.group_norm import (
        group_norm_backward,
        group_norm_backward_reference,
    )

    x, scale, bias = _gn_inputs(shape, dev, dtype)
    g = _randn(shape, 1.0, 3, dev, torch.float32).to(dtype)
    reset_launch_counts()
    dx, dscale, dbias = group_norm_backward(x, scale, bias, g, groups,
                                            act=act)
    dx_only, none_s, none_b = group_norm_backward(x, scale, bias, g, groups,
                                                  act=act, params=False)
    again = group_norm_backward(x, scale, bias, g, groups, act=act)
    torch.cuda.synchronize()
    assert launch_counts() == {"group_norm_act_bwd": 3,
                               "group_norm_act_bwd_params": 2}
    assert none_s is None and none_b is None
    assert dx.dtype == dtype and dscale.dtype == torch.float32
    assert torch.equal(dx, dx_only)
    for a, b in zip((dx, dscale, dbias), again):
        assert torch.equal(a, b)
    rdx, rds, rdb = group_norm_backward_reference(x, scale, bias, g, groups,
                                                  act=act)
    # the sums' terms, for the bars
    xf = x.float().reshape(shape[0], -1, groups, shape[-1] // groups)
    xhat = ((xf - xf.mean((1, 3), keepdim=True))
            * torch.rsqrt(xf.var((1, 3), unbiased=False, keepdim=True)
                          + 1e-5)).reshape(shape)
    dpre_abs = (g.float() * (1 if act is None else 2)).abs()
    terms = [(dpre_abs * xhat.abs()).sum().item(), dpre_abs.sum().item()]
    dx_bar, (ds_bar, db_bar) = _gn_bwd_bars(rdx, dtype, terms)
    assert (dx.float() - rdx.float()).abs().max() <= dx_bar
    assert (dscale - rds).abs().max() <= ds_bar
    assert (dbias - rdb).abs().max() <= db_bar


# metanode18/34's wide CIFAR shapes: 256 channels at 8x8 and 512 at 4x4
# (B1's wgrad: bf16 TMA at W 8, split-K at W 4 and in f32), 32 groups
WIDE_CONVS = [(8, 8, 8, 256, 256), (8, 4, 4, 512, 512)]
WIDE_GN = [((8, 8, 8, 256), 32, "gelu"), ((8, 8, 8, 256), 32, None),
           ((8, 4, 4, 512), 32, "gelu"), ((8, 4, 4, 512), 32, None)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", WIDE_CONVS)
def test_wide_conv3x3_kernels_match_plain(dev, dtype, shape):
    """B1's forward, dgrad and wgrad at the wide shapes, under the bars of
    the cases above; the bf16 wgrad at W 4 plans split-K, f32 its f32
    path."""
    from neural_ode_metasolver_tpu_torch.ops.conv3x3 import wgrad_plan

    n, h, w, cin, cout = shape
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    plan = wgrad_plan(n, h, w, cin, cout, dtype, sms)
    assert plan.path == ("f32" if dtype == torch.float32 else
                         "tma" if w == 8 else "split_k")
    test_conv3x3_kernel_matches_plain(dev, dtype, shape)
    test_conv3x3_dgrad_kernel_matches_plain(dev, dtype, shape)
    test_conv3x3_wgrad_kernel_matches_plain(dev, dtype, shape)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,groups,act", WIDE_GN)
def test_wide_group_norm_kernels_match_plain(dev, dtype, shape, groups, act):
    """B3's forward and backward at the wide shapes, under the bars of the
    cases above (the backward's on the staged path, its bits repeating and
    the dx-only launch's dx equal to the full launch's)."""
    from neural_ode_metasolver_tpu_torch.ops.group_norm import launch_plan

    assert launch_plan(*shape, groups, dtype, backward=True).path == "staged"
    test_group_norm_kernel_matches_plain(dev, dtype, shape, groups, act)
    test_group_norm_backward_kernel_matches_plain(dev, dtype, shape, groups,
                                                  act)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_group_norm_autograd_matches_plain(dev, dtype):
    """Gradients through fused_group_norm_act (the autograd Function) equal
    torch autograd through group_norm_reference, at the bars above; only
    what autograd asks for is computed."""
    from neural_ode_metasolver_tpu_torch import (
        launch_counts,
        reset_launch_counts,
    )
    from neural_ode_metasolver_tpu_torch.ops.group_norm import (
        fused_group_norm_act,
        group_norm_reference,
    )

    shape = (4, 13, 13, 64)
    x, scale, bias = _gn_inputs(shape, dev, dtype)
    g = _randn(shape, 1.0, 3, dev, torch.float32).to(dtype)
    x, scale, bias = (t.requires_grad_(True) for t in (x, scale, bias))
    reset_launch_counts()
    got = torch.autograd.grad(
        fused_group_norm_act(x, scale, bias, 32, act="gelu"),
        (x, scale, bias), g)
    (dx_only,) = torch.autograd.grad(
        fused_group_norm_act(x, scale.detach(), bias.detach(), 32,
                             act="gelu"), x, g)
    assert launch_counts() == {"group_norm_act": 2, "group_norm_act_bwd": 2,
                               "group_norm_act_bwd_params": 1}
    assert torch.equal(got[0], dx_only)
    ref = torch.autograd.grad(
        group_norm_reference(x, scale, bias, 32, act="gelu"),
        (x, scale, bias), g)
    terms = [g.float().abs().sum().item() * 3] * 2
    dx_bar, (ds_bar, db_bar) = _gn_bwd_bars(ref[0], dtype, terms)
    assert (got[0].float() - ref[0].float()).abs().max() <= 2 * dx_bar
    assert (got[1] - ref[1]).abs().max() <= ds_bar
    assert (got[2] - ref[2]).abs().max() <= db_bar


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_train_step_kernel_path_matches_plain_path(dev, dtype):
    """One flagship train step (premetanode10 at in_planes 16, batch 8),
    kernel path against plain path from one state, draws pinned by the
    seeds: f32 the bars of chip_smoke.py phase 10 (x_adv equal but at
    pixels with an input gradient under 1e-6 of the max, at most 0.1% of
    them; param grads at the same x_adv within 1e-4 of max|g|); bf16 one
    step's loss within 2e-2 and grad norm within 5e-2 relative."""
    from neural_ode_metasolver_tpu_torch import (
        launch_counts,
        reset_launch_counts,
    )
    from neural_ode_metasolver_tpu_torch.attacks import (
        cross_entropy,
        fgsm_random,
    )
    from neural_ode_metasolver_tpu_torch.models import build_model
    from neural_ode_metasolver_tpu_torch.ops import (
        SolverOptions,
        parse_solver_dsl,
    )
    from neural_ode_metasolver_tpu_torch.training import (
        AttackConfig,
        NoiseConfig,
        create_train_state,
        cyclic_lr,
        make_optimizer,
        make_train_step,
    )

    mean, std = (0.4914, 0.4822, 0.4465), (0.2023, 0.1994, 0.2010)
    model = build_model("premetanode10", in_planes=16, acts=("GeLUpoly",) * 3,
                        generator=torch.Generator().manual_seed(0))
    solvers = parse_solver_dsl("rk2,u,8,-1,0.5,-1")
    opt = make_optimizer("sgd", cyclic_lr(1e-7, 0.1, 3186), momentum=0.9,
                         weight_decay=5e-4)
    attack = AttackConfig(mode="fgsm_random", eps=8 / 255, alpha=10 / 255,
                          mean=mean, std=std)
    noise = NoiseConfig(noise_type="normal", sigma=0.0125, prob=1.0)
    x = _randn((8, 32, 32, 3), 1.0, 9, dev, torch.float32)
    y = torch.arange(8, device=dev) % 10
    snapshot = {k: p.detach().clone() for k, p in model.named_parameters()}
    out = {}
    for use_kernels in (True, False):
        with torch.no_grad():
            for k, p in model.named_parameters():
                p.copy_(snapshot[k])
        state = create_train_state(model, opt)
        step = make_train_step(model, opt, solvers, SolverOptions(), attack,
                               noise, compute_dtype=dtype,
                               use_kernels=use_kernels)
        reset_launch_counts()
        _, m = step(state, x, y, torch.Generator().manual_seed(1))
        torch.cuda.synchronize()
        out[use_kernels] = (m["loss"].item(), m["grad_norm"].item(),
                            launch_counts())
    (lk, nk, counts_k), (lp, np_, counts_p) = out[True], out[False]
    # 68 forward convs a pass, two passes; the training pass's input and
    # the attack's weights are detached; GeLUpoly 69 calls a pass, each
    # differentiated
    assert counts_k == {"conv3x3_same": 136, "conv3x3_dgrad": 135,
                        "conv3x3_wgrad": 68, "gelu_poly": 138,
                        "gelu_poly_bwd": 138}
    assert counts_p == {}
    assert abs(lk - lp) <= 2e-2 * max(1.0, abs(lp))
    assert abs(nk - np_) <= 5e-2 * np_
    if dtype == torch.bfloat16:
        return
    with torch.no_grad():
        for k, p in model.named_parameters():
            p.copy_(snapshot[k])
    frozen = model.detached_params()
    fwd = lambda uk, train, tree=None: (
        lambda xi: model(xi, solvers, use_kernels=uk, train=train, params=tree))
    xa = [fgsm_random(fwd(uk, False, frozen),
                      torch.Generator(device=dev).manual_seed(2), x, y,
                      8 / 255, 10 / 255, mean, std)[0] for uk in (True, False)]
    differ = xa[0] != xa[1]
    assert differ.float().mean() <= 1e-3
    params = [p for _, p in model.named_parameters()]
    grads = [torch.autograd.grad(cross_entropy(fwd(uk, True)(xa[1]), y), params)
             for uk in (True, False)]
    gmax = max(g.abs().max() for g in grads[1])
    assert max((a - b).abs().max() for a, b in zip(*grads)) <= 1e-4 * gmax


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cifar_gn_train_step_kernel_path_matches_plain_path(dev, dtype):
    """One metanode10-GN step (in_planes 64, 32 groups, exact GELU fused
    into B3; FGSM-random; batch 4) and one BN+SN step, kernel path against
    plain path from one state and model state: loss within 2e-2 and grad
    norm within 5e-2 relative (f32: 1e-4 and 1e-3), the exact launches (a
    pass: B1 68, B3 70; the attack's backward dx only), and the model
    state the two paths commit within the same bars."""
    from neural_ode_metasolver_tpu_torch import (
        launch_counts,
        reset_launch_counts,
    )
    from neural_ode_metasolver_tpu_torch.models import build_model
    from neural_ode_metasolver_tpu_torch.ops import parse_solver_dsl
    from neural_ode_metasolver_tpu_torch.training import (
        AttackConfig,
        create_train_state,
        make_optimizer,
        make_train_step,
    )

    solvers = parse_solver_dsl("rk2,u,8,-1,0.5,-1")
    attack = AttackConfig(mode="fgsm_random", eps=8 / 255, alpha=10 / 255)
    x = _randn((4, 32, 32, 3), 1.0, 9, dev, torch.float32)
    y = torch.arange(4, device=dev)
    loss_bar, norm_bar = ((1e-4, 1e-3) if dtype == torch.float32
                          else (2e-2, 5e-2))
    for kw, gn in ((dict(norms=("GN",) * 3), True),
                   (dict(norms=("BN", "NF", "BN"),
                         param_norms=("SN", "SN", "PNF")), False)):
        model = build_model("metanode10", in_planes=64,
                            generator=torch.Generator().manual_seed(0), **kw)
        sd = {k: v.clone() for k, v in model.state_dict().items()}
        out = {}
        for use_kernels in (True, False):
            model.load_state_dict(sd)
            opt = make_optimizer("sgd", 0.05, momentum=0.9)
            state = create_train_state(model, opt)
            step = make_train_step(model, opt, solvers, attack_cfg=attack,
                                   compute_dtype=dtype,
                                   use_kernels=use_kernels)
            reset_launch_counts()
            _, m = step(state, x, y, torch.Generator().manual_seed(1))
            torch.cuda.synchronize()
            out[use_kernels] = (m["loss"].item(), m["grad_norm"].item(),
                                launch_counts(),
                                {k: v.clone() for k, v in
                                 state.model_state.items()})
        (lk, nk, ck, sk), (lp, np_, cp, sp) = out[True], out[False]
        b3 = ({"group_norm_act": 140, "group_norm_act_bwd": 140,
               "group_norm_act_bwd_params": 70} if gn else {})
        assert ck == {"conv3x3_same": 136, "conv3x3_dgrad": 135,
                      "conv3x3_wgrad": 68, **b3}
        assert cp == {}
        assert abs(lk - lp) <= loss_bar * max(1.0, abs(lp))
        assert abs(nk - np_) <= norm_bar * np_
        assert set(sk) == set(sp) and (gn or sk)
        for k in sk:
            assert (sk[k] - sp[k]).abs().max() <= norm_bar * max(
                1.0, sp[k].abs().max()), k


def test_mnist_train_step_kernel_path_matches_plain_path(dev):
    """The digits recipe's train step (MNIST MetaNODE at dim 64, RK2 u=0.5
    8 steps, Normal(0.0125) smoothing, PGD-7 at eps 0.3, RMSprop) at batch
    8 in f32, kernel path against plain path from one state, draws pinned
    by the seeds: the launches of one step; one step's loss and grad norm
    within 2e-2 and 5e-2 relative (PGD's seven sign steps carry rounding
    differences on, as phase 10 of chip_smoke.py allows for the flagship);
    then through Model.forward one PGD step's x_adv equal at all but 0.1%
    of the pixels, and the param grads at the same x_adv within 1e-3 of
    max|g| (ReLU masks flip where a pre-activation is within rounding of
    0, and B3's forward kernel and its plain version round apart; as
    phase 11 of chip_smoke.py)."""
    from neural_ode_metasolver_tpu_torch import (
        launch_counts,
        reset_launch_counts,
    )
    from neural_ode_metasolver_tpu_torch.attacks import cross_entropy, pgd
    from neural_ode_metasolver_tpu_torch.models import build_model
    from neural_ode_metasolver_tpu_torch.ops import (
        SolverOptions,
        parse_solver_dsl,
    )
    from neural_ode_metasolver_tpu_torch.training import (
        AttackConfig,
        NoiseConfig,
        create_train_state,
        make_optimizer,
        make_train_step,
    )

    model = build_model("mnist", dim=64,
                        generator=torch.Generator().manual_seed(0))
    solvers = parse_solver_dsl("rk2,u,8,-1,0.5,-1")
    opt = make_optimizer("rmsprop", 1e-3, weight_decay=5e-4)
    attack = AttackConfig(mode="at", eps=0.3, pgd_lr=2 / 255, pgd_niter=7)
    noise = NoiseConfig(noise_type="normal", sigma=0.0125, prob=1.0)
    x = torch.tensor(np.random.RandomState(9).rand(8, 28, 28, 1)
                     .astype(np.float32), device=dev)
    y = torch.arange(8, device=dev) % 10
    snapshot = {k: p.detach().clone() for k, p in model.named_parameters()}
    out = {}
    for use_kernels in (True, False):
        with torch.no_grad():
            for k, p in model.named_parameters():
                p.copy_(snapshot[k])
        state = create_train_state(model, opt)
        step = make_train_step(model, opt, solvers, SolverOptions(), attack,
                               noise, use_kernels=use_kernels)
        reset_launch_counts()
        _, m = step(state, x, y, torch.Generator().manual_seed(1))
        torch.cuda.synchronize()
        out[use_kernels] = (m["loss"].item(), m["grad_norm"].item(),
                            launch_counts())
    (lk, nk, counts_k), (lp, np_, counts_p) = out[True], out[False]
    # 8 forwards (7 PGD iterations, the training pass) of 51 GroupNorms and
    # 32 ConcatConv2ds; 8 backwards: 7 for the input only, 1 for the params
    assert counts_k == {"group_norm_act": 408, "conv3x3_same": 256,
                        "group_norm_act_bwd": 408,
                        "group_norm_act_bwd_params": 51,
                        "conv3x3_dgrad": 256, "conv3x3_wgrad": 32}
    assert counts_p == {}
    assert abs(lk - lp) <= 2e-2 * max(1.0, abs(lp))
    assert abs(nk - np_) <= 5e-2 * np_
    with torch.no_grad():
        for k, p in model.named_parameters():
            p.copy_(snapshot[k])
    frozen = model.detached_params()
    fwd = lambda uk, train, tree=None: (
        lambda xi: model(xi, solvers, use_kernels=uk, train=train,
                         params=tree))
    xa = [pgd(fwd(uk, False, frozen),
              torch.Generator(device=dev).manual_seed(2), x, y, 0.3, 2 / 255,
              1)[0] for uk in (True, False)]
    assert (xa[0] != xa[1]).float().mean() <= 1e-3
    params = [p for _, p in model.named_parameters()]
    grads = [torch.autograd.grad(cross_entropy(fwd(uk, True)(xa[1]), y),
                                 params) for uk in (True, False)]
    assert all(g.grad_fn is None for g in grads[0])
    gmax = max(g.abs().max() for g in grads[1])
    assert max((a - b).abs().max() for a, b in zip(*grads)) <= 1e-3 * gmax


REGIMES = ["standalone", "switch[0.6,0.4]", "solver_ens[0.6,0.4]",
           "model_ensembling"]


@pytest.mark.parametrize("family", ["mnist", "premetanode10"])
@pytest.mark.parametrize("regime", REGIMES)
def test_regime_table_kernel_path_matches_plain_path(dev, family, regime):
    """One row of the Evaluate-notebook table (``notebook_regime_grid`` on
    RK2 u=0.5 in 8 steps) on one batch: the MNIST MetaNODE at dim 64 in f32
    (batch 8, FGSM eps 0.3), premetanode10 at in_planes 64 in bf16 (batch 4,
    FGSM eps 8/255 with the CIFAR mean and std).  The kernel path against
    the plain path from the same seeds: the launches of a clean batch and
    an FGSM batch (the attack forward under grad takes B1, never B2),
    clean scores within the serving bars (1e-4 of max(1, max|logit|), or
    2^-5 of max|logit|; the ensemble's mean softmax within the bar of its
    members' logits), clean predictions equal but at near-ties; FGSM in
    f32: x_adv equal but at most 0.1% of the pixels; for MNIST (ReLU masks
    flip on rounding) at most ``MNIST_GRAD_FAR_BAR`` of the input gradients
    more than 1e-3 of their max apart; for premetanode10 the input
    gradients within 1e-4 of their max and each pixel apart with an input
    gradient under 1e-6 of it.  The counts, helpers and bars are
    chip_smoke.py's (phases 13 and 14)."""
    from collections import Counter

    from chip_smoke import (
        MNIST_GRAD_FAR_BAR,
        argmax_apart,
        cifar_forward_counts,
        fgsm_apart,
        member_forwards,
        member_logits_apart,
        mnist_forward_counts,
    )
    from neural_ode_metasolver_tpu_torch import (
        launch_counts,
        reset_launch_counts,
    )
    from neural_ode_metasolver_tpu_torch.attacks import normalize
    from neural_ode_metasolver_tpu_torch.models import build_model
    from neural_ode_metasolver_tpu_torch.ops import (
        SolverOptions,
        create_solver,
    )
    from neural_ode_metasolver_tpu_torch.training import (
        AttackConfig,
        make_adversarial_predict,
        make_ensemble_attacked_probs,
        make_ensemble_probs,
        make_eval_step,
        notebook_regime_grid,
    )

    mnist = family == "mnist"
    kind = regime.split("[")[0]
    mean, std = (None, None) if mnist else (
        (0.4914, 0.4822, 0.4465), (0.2023, 0.1994, 0.2010))
    if mnist:
        model = build_model("mnist", dim=64,
                            generator=torch.Generator().manual_seed(0))
        x = torch.tensor(np.random.RandomState(3).rand(8, 28, 28, 1)
                         .astype(np.float32), device=dev)
        dtype, eps = None, 0.3
        fwd_counts = mnist_forward_counts(kind, 8)
        atk_counts = fwd_counts
        bar = lambda ref: 1e-4 * max(1.0, ref.abs().max().item())
    else:
        model = build_model("premetanode10", in_planes=64,
                            generator=torch.Generator().manual_seed(0))
        x = normalize(torch.tensor(np.random.RandomState(3).rand(
            4, 32, 32, 3).astype(np.float32), device=dev), mean, std)
        dtype, eps = torch.bfloat16, 8 / 255
        fwd_counts = cifar_forward_counts(kind, 8)
        atk_counts = cifar_forward_counts(kind, 8, b2=False)
        bar = lambda ref: 2.0 ** -5 * ref.abs().max().item()
    y = torch.arange(x.shape[0], device=dev) % 10
    attack = AttackConfig(mode="fgsm", eps=eps, mean=mean, std=std)
    spec = {r.name: r for r in notebook_regime_grid(
        create_solver("rk2", "u", n_steps=8, u0=0.5),
        torch.Generator().manual_seed(15))}[regime]
    want_f = Counter(fwd_counts) + Counter(atk_counts) + Counter({
        "conv3x3_dgrad": atk_counts["conv3x3_same"],
        "group_norm_act_bwd": atk_counts.get("group_norm_act", 0)})
    members = [(model, [s], SolverOptions()) for s in spec.solvers]
    out = {}
    for uk in (True, False):
        if spec.is_model_ensemble:
            clean = lambda: make_ensemble_probs(
                members, compute_dtype=dtype, use_kernels=uk)(x)
            attacked = lambda: make_ensemble_attacked_probs(
                members, attack, compute_dtype=dtype, use_kernels=uk)(
                x, y, [5, 6])
        else:
            clean = lambda: make_eval_step(
                model, spec.solvers, spec.options, compute_dtype=dtype,
                use_kernels=uk)(x, torch.Generator().manual_seed(5))
            attacked = lambda: make_adversarial_predict(
                model, spec.solvers, spec.options, attack,
                compute_dtype=dtype, use_kernels=uk)(x, y, None, 6)
        reset_launch_counts()
        scores = clean()
        torch.cuda.synchronize()
        counts = launch_counts()
        reset_launch_counts()
        attacked()
        torch.cuda.synchronize()
        out[uk] = (scores.float(), counts, launch_counts())
    (sk, ck, fk), (sp, cp, fp) = out[True], out[False]
    assert ck == fwd_counts and fk == {k: v for k, v in want_f.items() if v}
    assert cp == {} and fp == {}
    if spec.is_model_ensemble:
        xin = x if dtype is None else x.to(dtype)
        assert all(e <= b for e, b in member_logits_apart(
            model, spec.solvers, xin, bar))
    else:
        assert (sk - sp).abs().max().item() <= bar(sp)
    assert argmax_apart(sk, sp)[0] == 0
    (fa,) = fgsm_apart([member_forwards(model, spec, False, 7),
                        member_forwards(model, spec, True, 7)],
                       x, y, eps, mean, std)
    assert fa["share"] <= 1e-3
    if mnist:
        assert fa["grad_far"] <= MNIST_GRAD_FAR_BAR
    else:  # GELU has no masks to flip on rounding: phase 10's bars
        assert fa["grad_err"] <= 1e-4 and fa["worst"] <= 1e-6


@pytest.mark.parametrize("thread", [False, True])
def test_prefetch_copies_batches_on_a_side_stream(dev, thread):
    """Pinned host memory copied on a side stream gives the numpy batches
    bit for bit, on the card, and the consumer's work on them is ordered
    after the copies."""
    from neural_ode_metasolver_tpu_torch.data import (
        batch_iterator,
        prefetch_to_device,
        synthetic_dataset,
    )

    ds = synthetic_dataset(96, (32, 32, 3), seed=1)
    kw = dict(seed=5, crop_padding=4, hflip=True, mean=(0.5, 0.5, 0.5),
              std=(0.25, 0.25, 0.25))
    want = list(batch_iterator(ds, 16, **kw))
    got, sums = [], []
    for x, y in prefetch_to_device(batch_iterator(ds, 16, **kw), size=2,
                                   device=dev, thread=thread):
        assert x.device.type == "cuda" and y.device.type == "cuda"
        sums.append(x.double().sum())  # queued on the consumer's stream
        got.append((x, y))
    torch.cuda.synchronize()
    assert len(got) == len(want) == 6
    for (wx, wy), (gx, gy), s in zip(want, got, sums):
        np.testing.assert_array_equal(gx.cpu().numpy(), wx)
        np.testing.assert_array_equal(gy.cpu().numpy(), wy)
        assert float(s) == float(wx.astype(np.float64).sum())


def test_mnist_runner_two_steps_on_the_card(tmp_path):
    """The MNIST CLI on the card: two steps of the digits recipe (PGD-1 to
    keep it short), validation and a PGD test through the kernels, its
    checkpoints and a resume."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import json

    from neural_ode_metasolver_tpu_torch import (
        launch_counts,
        reset_launch_counts,
    )
    from neural_ode_metasolver_tpu_torch.runners import mnist_runner

    argv = ["--solvers", "rk2,u,2,-1,0.5,-1", "--nepochs", "1",
            "--batch_size", "16", "--test_batch_size", "32",
            "--synthetic_train_size", "32", "--synthetic_test_size", "32",
            "--adv_training_mode", "at", "--pgd_niter_training", "1",
            "--adv_testing_mode", "at", "--pgd_niter_testing", "1",
            "--noise_type", "normal", "--noise_sigma", "0.0125",
            "--noise_prob", "1.0", "--lr", "1e-3",
            "--save_dir", str(tmp_path)]
    reset_launch_counts()
    ts = mnist_runner.main(argv)
    counts = launch_counts()
    assert ts.step == 2 and all(p.is_cuda for p in ts.params.values())
    for name in ("group_norm_act", "group_norm_act_bwd", "conv3x3_same",
                 "conv3x3_dgrad", "conv3x3_wgrad"):
        assert counts.get(name, 0) > 0, (name, counts)
    with open(tmp_path / "metrics.jsonl") as f:
        recs = [json.loads(line) for line in f]
    assert np.isfinite([r["train_loss"] for r in recs
                        if "train_loss" in r]).all()
    assert [r for r in recs if "adv_test_acc" in r]
    with open(tmp_path / "logs") as f:
        assert "data backend: native" in f.read()
    ts2 = mnist_runner.main(argv + ["--resume"])
    assert ts2.step == 4


def test_mnist_adjoint_kernel_path_matches_plain_path(dev):
    """The MNIST MetaNODE (dim 64, RK2 u=0.5 8 steps) at batch 128 in f32
    under the continuous adjoint: the training pass's parameter gradients,
    kernel path against plain path, within 1e-3 of max|g| (the MNIST bar:
    ReLU masks flip on rounding), with B3's backward inside the adjoint's
    VJP.  Launches: the forward's 51 GroupNorms and 32 ConcatConv2ds; the
    backward recomputes each of the 16 RHS calls (48 GroupNorms, 32 convs)
    and differentiates it (48 + 3 B3 backwards with dscale and dbias, 32
    dgrads, 32 wgrads)."""
    from neural_ode_metasolver_tpu_torch import (
        launch_counts,
        reset_launch_counts,
    )
    from neural_ode_metasolver_tpu_torch.attacks import cross_entropy
    from neural_ode_metasolver_tpu_torch.models import build_model
    from neural_ode_metasolver_tpu_torch.ops import parse_solver_dsl

    model = build_model("mnist", dim=64,
                        generator=torch.Generator().manual_seed(0))
    solvers = parse_solver_dsl("rk2,u,8,-1,0.5,-1")
    x = torch.tensor(np.random.RandomState(9).rand(128, 28, 28, 1)
                     .astype(np.float32), device=dev)
    y = torch.arange(128, device=dev) % 10
    params = list(model.parameters())
    grads, counts = [], []
    for use_kernels in (True, False):
        reset_launch_counts()
        loss = cross_entropy(model(x, solvers, use_kernels=use_kernels,
                                   train=True, integration_method="adjoint"),
                             y)
        grads.append(torch.autograd.grad(loss, params))
        torch.cuda.synchronize()
        counts.append(launch_counts())
    assert counts[0] == {"group_norm_act": 99, "conv3x3_same": 64,
                         "group_norm_act_bwd": 51,
                         "group_norm_act_bwd_params": 51,
                         "conv3x3_dgrad": 32, "conv3x3_wgrad": 32}
    assert counts[1] == {}
    gmax = max(g.abs().max() for g in grads[1])
    assert max((a - b).abs().max() for a, b in zip(*grads)) <= 1e-3 * gmax


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_adjoint_train_step_kernel_path_matches_plain_path(dev, dtype):
    """The flagship step (premetanode10 at in_planes 16, batch 8) under
    ``integration_method="adjoint"``, kernel path against plain path from
    one state: the launches of a step (B1 264: each pass's 68 forward
    convs and the backward's 64 recomputed ones; dgrad 135, wgrad 68;
    GeLUpoly 266 forward, 138 backward; no B2), one step's loss within 2e-2 and grad norm within 5e-2 relative;
    in f32 also the param grads at one input within 1e-4 of max|g|."""
    from neural_ode_metasolver_tpu_torch import (
        launch_counts,
        reset_launch_counts,
    )
    from neural_ode_metasolver_tpu_torch.attacks import cross_entropy
    from neural_ode_metasolver_tpu_torch.models import build_model
    from neural_ode_metasolver_tpu_torch.ops import (
        SolverOptions,
        parse_solver_dsl,
    )
    from neural_ode_metasolver_tpu_torch.training import (
        AttackConfig,
        NoiseConfig,
        create_train_state,
        make_optimizer,
        make_train_step,
    )

    mean, std = (0.4914, 0.4822, 0.4465), (0.2023, 0.1994, 0.2010)
    model = build_model("premetanode10", in_planes=16, acts=("GeLUpoly",) * 3,
                        generator=torch.Generator().manual_seed(0))
    solvers = parse_solver_dsl("rk2,u,8,-1,0.5,-1")
    attack = AttackConfig(mode="fgsm_random", eps=8 / 255, alpha=10 / 255,
                          mean=mean, std=std)
    noise = NoiseConfig(noise_type="normal", sigma=0.0125, prob=1.0)
    x = _randn((8, 32, 32, 3), 1.0, 9, dev, torch.float32)
    y = torch.arange(8, device=dev) % 10
    snapshot = {k: p.detach().clone() for k, p in model.named_parameters()}
    out = {}
    for use_kernels in (True, False):
        with torch.no_grad():
            for k, p in model.named_parameters():
                p.copy_(snapshot[k])
        opt = make_optimizer("sgd", 0.05, momentum=0.9, weight_decay=5e-4)
        step = make_train_step(model, opt, solvers, SolverOptions(), attack,
                               noise, compute_dtype=dtype,
                               use_kernels=use_kernels,
                               integration_method="adjoint")
        reset_launch_counts()
        _, m = step(create_train_state(model, opt), x, y,
                    torch.Generator().manual_seed(1))
        torch.cuda.synchronize()
        out[use_kernels] = (m["loss"].item(), m["grad_norm"].item(),
                            launch_counts())
    (lk, nk, counts_k), (lp, np_, counts_p) = out[True], out[False]
    # GeLUpoly: each pass's 69 forward calls and the 64 of the recomputed
    # RHS calls; every call differentiated once
    assert counts_k == {"conv3x3_same": 264, "conv3x3_dgrad": 135,
                        "conv3x3_wgrad": 68, "gelu_poly": 266,
                        "gelu_poly_bwd": 138}
    assert counts_p == {}
    assert abs(lk - lp) <= 2e-2 * max(1.0, abs(lp))
    assert abs(nk - np_) <= 5e-2 * np_
    if dtype == torch.bfloat16:
        return
    with torch.no_grad():
        for k, p in model.named_parameters():
            p.copy_(snapshot[k])
    params = list(model.parameters())
    grads = [torch.autograd.grad(cross_entropy(model(
        x, solvers, use_kernels=uk, train=True,
        integration_method="adjoint"), y), params) for uk in (True, False)]
    gmax = max(g.abs().max() for g in grads[1])
    assert max((a - b).abs().max() for a, b in zip(*grads)) <= 1e-4 * gmax


def test_solver_train_step_kernel_path_matches_plain_path(dev):
    """One ``make_solver_train_step`` step of the digits recipe's net and
    attack (MNIST dim 64, RK2 u=0.5 8 steps, PGD-7 at eps 0.3, RMSprop; u
    at lr_uv 0.01) at batch 8 in f32, kernel path against plain path from
    one state: the launches (the digits step's), loss within 2e-2 and
    solver_grad_norm within 5e-2 (PGD's sign steps carry rounding on);
    then at one input the gradients of u within 1e-3 relative and of the
    params within 1e-3 of max|g|.  u and its tableau live on the card."""
    from neural_ode_metasolver_tpu_torch import (
        launch_counts,
        reset_launch_counts,
    )
    from neural_ode_metasolver_tpu_torch.attacks import cross_entropy
    from neural_ode_metasolver_tpu_torch.models import build_model
    from neural_ode_metasolver_tpu_torch.ops import (
        SolverOptions,
        parse_solver_dsl,
    )
    from neural_ode_metasolver_tpu_torch.training import (
        AttackConfig,
        create_solver_train_state,
        make_optimizer,
        make_solver_train_step,
        solvers_from_state,
    )

    model = build_model("mnist", dim=64,
                        generator=torch.Generator().manual_seed(0))
    solvers = parse_solver_dsl("rk2,u,8,-1,0.5,-1")
    attack = AttackConfig(mode="at", eps=0.3, pgd_lr=2 / 255, pgd_niter=7)
    x = torch.tensor(np.random.RandomState(9).rand(8, 28, 28, 1)
                     .astype(np.float32), device=dev)
    y = torch.arange(8, device=dev) % 10
    snapshot = {k: p.detach().clone() for k, p in model.named_parameters()}
    out = {}
    for use_kernels in (True, False):
        with torch.no_grad():
            for k, p in model.named_parameters():
                p.copy_(snapshot[k])
        opt = make_optimizer("rmsprop", 1e-3, weight_decay=5e-4)
        sopt = make_optimizer("sgd", 0.01)
        state = create_solver_train_state(model, opt, sopt, solvers)
        assert state.solver_params[0]["u"].is_cuda
        step = make_solver_train_step(model, opt, sopt, solvers,
                                      SolverOptions(), attack,
                                      use_kernels=use_kernels)
        reset_launch_counts()
        _, m = step(state, x, y, torch.Generator().manual_seed(1))
        torch.cuda.synchronize()
        out[use_kernels] = (m["loss"].item(), m["solver_grad_norm"].item(),
                            launch_counts())
    (lk, sk, counts_k), (lp, sp, counts_p) = out[True], out[False]
    assert counts_k == {"group_norm_act": 408, "conv3x3_same": 256,
                        "group_norm_act_bwd": 408,
                        "group_norm_act_bwd_params": 51,
                        "conv3x3_dgrad": 256, "conv3x3_wgrad": 32}
    assert counts_p == {}
    assert abs(lk - lp) <= 2e-2 * max(1.0, abs(lp))
    assert abs(sk - sp) <= 5e-2 * sp
    with torch.no_grad():
        for k, p in model.named_parameters():
            p.copy_(snapshot[k])
    params = list(model.parameters())
    grads = []
    for use_kernels in (True, False):
        u = torch.tensor(0.5, device=dev, requires_grad=True)
        s = solvers_from_state(solvers, [{"u": u, "v": None}])
        loss = cross_entropy(model(x, s, use_kernels=use_kernels,
                                   train=True), y)
        grads.append(torch.autograd.grad(loss, params + [u]))
    gu = [g[-1] for g in grads]
    assert (gu[0] - gu[1]).abs() <= 1e-3 * gu[1].abs()
    gmax = max(g.abs().max() for g in grads[1][:-1])
    assert max((a - b).abs().max() for a, b in zip(grads[0][:-1],
                                                   grads[1][:-1])) \
        <= 1e-3 * gmax


# ------------------------------------------------------------ the fleet
MEMBER_CONV = [(3, 4, 6, 6, 65, 64, torch.float32),    # MNIST's ConcatConv2d
               (2, 9, 32, 32, 64, 64, torch.float32),  # f32 rows 64, K in 2
               (2, 17, 32, 32, 64, 64, torch.float32),  # f32 rows 128
               (2, 3, 8, 8, 3, 64, torch.bfloat16),    # element copies
               (2, 2, 8, 8, 64, 64, torch.bfloat16),   # the halo kernel
               (2, 2, 8, 8, 64, 8, torch.bfloat16)]    # the narrow halo


@pytest.mark.parametrize("s,n,h,w,cin,cout,dtype", MEMBER_CONV)
def test_member_conv3x3_launches_equal_single_launches(dev, s, n, h, w, cin,
                                                       cout, dtype):
    """One member-batched launch of B1, its dgrad and the wgrad (split-K,
    or TMA once a member) gives each member a single launch's bits, and
    counts one launch (the TMA wgrad: one a member)."""
    from neural_ode_metasolver_tpu_torch import (
        launch_counts,
        reset_launch_counts,
    )
    from neural_ode_metasolver_tpu_torch.ops.conv3x3 import (
        conv3x3_dgrad,
        conv3x3_same,
        conv3x3_wgrad,
        reference_conv3x3,
        wgrad_plan,
    )

    x = _randn((s, n, h, w, cin), 1.0, 0, dev, dtype)
    k = _randn((s, 3, 3, cin, cout), (9 * cin) ** -0.5, 1, dev, dtype)
    dy = _randn((s, n, h, w, cout), 1.0, 2, dev, dtype)
    reset_launch_counts()
    y, dx, dw = (conv3x3_same(x, k), conv3x3_dgrad(dy, k),
                 conv3x3_wgrad(x, dy))
    torch.cuda.synchronize()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    tma = wgrad_plan(n, h, w, cin, cout, dtype, sms).path == "tma"
    assert launch_counts() == {"conv3x3_same": 1, "conv3x3_dgrad": 1,
                               "conv3x3_wgrad": s if tma else 1}
    for m in range(s):
        assert torch.equal(y[m], conv3x3_same(x[m], k[m]))
        assert torch.equal(dx[m], conv3x3_dgrad(dy[m], k[m]))
        assert torch.equal(dw[m], conv3x3_wgrad(x[m], dy[m]))
    ref = reference_conv3x3(x, k)
    bar = (1e-4 * max(1.0, ref.float().abs().max().item())
           if dtype == torch.float32 else 2.0 ** -7 * ref.float().abs().max())
    assert (y.float() - ref.float()).abs().max() <= bar


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hw", [26, 13, 6])
@pytest.mark.parametrize("act", ["relu", None])
def test_member_group_norm_launches_equal_single_launches(dev, dtype, hw,
                                                         act):
    """B3 forward and backward (dx only and full) at the MNIST GroupNorms
    with 3 members of 4 samples: one launch each (the backward's dscale
    and dbias: (3, C)), each member a single launch's bits."""
    from neural_ode_metasolver_tpu_torch import (
        launch_counts,
        reset_launch_counts,
    )
    from neural_ode_metasolver_tpu_torch.ops.group_norm import (
        fused_group_norm_act,
        group_norm_backward,
    )

    s, n, c = 3, 4, 64
    x = _randn((s, n, hw, hw, c), 2.0, 3, dev, dtype)
    g = _randn((s, n, hw, hw, c), 1.0, 4, dev, dtype)
    sc = _randn((s, c), 0.3, 5, dev, torch.float32) + 1.0
    bi = _randn((s, c), 0.5, 6, dev, torch.float32)
    reset_launch_counts()
    y = fused_group_norm_act(x, sc, bi, 32, act=act)
    full = group_norm_backward(x, sc, bi, g, 32, act=act)
    dx_only = group_norm_backward(x, sc, bi, g, 32, act=act, params=False)
    torch.cuda.synchronize()
    assert launch_counts() == {"group_norm_act": 1, "group_norm_act_bwd": 2,
                               "group_norm_act_bwd_params": 1}
    assert full[1].shape == (s, c) and torch.equal(dx_only[0], full[0])
    for m in range(s):
        assert torch.equal(y[m], fused_group_norm_act(x[m], sc[m], bi[m], 32,
                                                      act=act))
        single = group_norm_backward(x[m], sc[m], bi[m], g[m], 32, act=act)
        for got, want in zip(full, single):
            assert torch.equal(got[m], want)


def test_fleet_step_kernel_path_matches_plain_path(dev):
    """A fleet of 3 (the u-sweep step at dim 16, batch 8 a member, u 0.3 /
    0.5 / 0.9, RMSprop, clean) on the kernel path against the plain path
    from one state: losses within 1e-4, grad norms within 1e-3 relative
    (one step; the phase 11 recipe's bars are for PGD-7), and one fleet
    step launches what one single-run step launches."""
    from neural_ode_metasolver_tpu_torch import (
        launch_counts,
        reset_launch_counts,
    )
    from neural_ode_metasolver_tpu_torch.models import build_model
    from neural_ode_metasolver_tpu_torch.ops import (
        SolverOptions,
        create_solver,
    )
    from neural_ode_metasolver_tpu_torch.training import (
        create_fleet_state,
        create_train_state,
        fleet_generators,
        make_fleet_train_step,
        make_optimizer,
        make_train_step,
        stack_fleet_solvers,
    )

    ref_solver = create_solver("rk2", "u", n_steps=2, u0=0.5)
    us = [0.3, 0.5, 0.9]
    dyn = stack_fleet_solvers([[ref_solver.replace(u=torch.tensor(u))]
                               for u in us])
    opt = make_optimizer("rmsprop", 1e-3, weight_decay=5e-4)
    model = build_model("mnist", dim=16)
    x = _randn((3, 8, 28, 28, 1), 1.0, 7, dev, torch.float32).abs()
    y = torch.tensor(np.random.RandomState(8).randint(0, 10, (3, 8)),
                     device=dev)
    out = {}
    for use_kernels in (True, False):
        fts = create_fleet_state(model, opt, [1, 2, 3])
        step = make_fleet_train_step(model, opt, [ref_solver],
                                     SolverOptions(),
                                     use_kernels=use_kernels)
        reset_launch_counts()
        _, m = step(fts, x, y, fleet_generators([4, 5, 6]), dyn)
        torch.cuda.synchronize()
        out[use_kernels] = (m, launch_counts())
    (mk, counts), (mp, plain_counts) = out[True], out[False]
    assert plain_counts == {}
    torch.testing.assert_close(mk["loss"], mp["loss"], rtol=0, atol=1e-4)
    torch.testing.assert_close(mk["grad_norm"], mp["grad_norm"], rtol=1e-3,
                               atol=0)
    single = build_model("mnist", dim=16)
    sstep = make_train_step(single, opt, [ref_solver], SolverOptions())
    reset_launch_counts()
    sstep(create_train_state(single, opt), x[0], y[0],
          torch.Generator().manual_seed(4), [dyn[0].replace(u=dyn[0].u[0])])
    torch.cuda.synchronize()
    assert counts == launch_counts()


def test_cifar_fleet_no_grad_forward_launches_b2_per_member(dev):
    """A CIFAR fleet's no-grad forward runs B2 once per member (4 n + 1
    launches a solve each), B1's stem once for all members, and matches
    the fleet's plain path."""
    from neural_ode_metasolver_tpu_torch import (
        launch_counts,
        reset_launch_counts,
    )
    from neural_ode_metasolver_tpu_torch.models import build_model
    from neural_ode_metasolver_tpu_torch.ops import (
        SolverOptions,
        create_solver,
    )
    from neural_ode_metasolver_tpu_torch.training import (
        create_fleet_state,
        make_optimizer,
        stack_fleet_solvers,
    )

    model = build_model("premetanode4", in_planes=16)
    fts = create_fleet_state(model, make_optimizer("sgd", 0.05), [1, 2])
    dyn = stack_fleet_solvers([[create_solver("rk2", "u", n_steps=2, u0=u)]
                               for u in (0.3, 0.9)])
    x = _randn((2, 4, 32, 32, 3), 1.0, 9, dev, torch.float32)
    trees = dict(params=model.param_tree(fts.params),
                 model_state=model.state_tree(fts.model_state))
    with torch.no_grad():
        reset_launch_counts()
        got = model(x, dyn, SolverOptions(), **trees)
        torch.cuda.synchronize()
        counts = launch_counts()
        want = model(x, dyn, SolverOptions(), use_kernels=False, **trees)
    assert counts == {"conv3x3_same": 1, "ode_block_rk2": 2 * 9}
    torch.testing.assert_close(got, want, rtol=0,
                               atol=1e-4 * max(1.0, want.abs().max().item()))


def test_custom_ops_launch_what_the_wrappers_launch(dev):
    """Each nodems:: op (ops/library.py) on CUDA tensors runs its kernel:
    bit-equal to the wrapper's direct launch, counted the same, members
    included; its fake kernel agrees (torch.library.opcheck)."""
    from neural_ode_metasolver_tpu_torch import (
        launch_counts,
        reset_launch_counts,
    )
    from neural_ode_metasolver_tpu_torch.ops.conv3x3 import conv3x3_same
    from neural_ode_metasolver_tpu_torch.ops.group_norm import (
        fused_group_norm_act,
    )
    from neural_ode_metasolver_tpu_torch.ops.ode_block import (
        ode_block_rk2_forward,
    )

    bf = torch.bfloat16
    x = _randn((4, 6, 6, 65), 1.0, 0, dev, torch.float32)
    w = _randn((3, 3, 65, 64), 0.05, 1, dev, torch.float32)
    xm = _randn((2, 4, 6, 6, 65), 1.0, 2, dev, torch.float32)
    wm = _randn((2, 3, 3, 65, 64), 0.05, 3, dev, torch.float32)
    g = _randn((4, 13, 13, 64), 1.0, 4, dev, torch.float32)
    sc = _randn((64,), 1.0, 5, dev, torch.float32)
    bi = _randn((64,), 1.0, 6, dev, torch.float32)
    y0 = _randn((2, 16, 16, 128), 1.0, 7, dev, bf)
    w1 = _randn((3, 3, 128, 128), 0.02, 8, dev, bf)
    w2 = _randn((3, 3, 128, 128), 0.02, 9, dev, bf)
    cases = [
        (torch.ops.nodems.conv3x3_same, conv3x3_same, (x, w),
         {"conv3x3_same": 1}),
        (torch.ops.nodems.conv3x3_same, conv3x3_same, (xm, wm),
         {"conv3x3_same": 1}),
        (torch.ops.nodems.group_norm_act, fused_group_norm_act,
         (g, sc, bi, 32, 1e-5, "relu"), {"group_norm_act": 1}),
        (torch.ops.nodems.ode_block_rk2, ode_block_rk2_forward,
         (y0, w1, w2, 0.5, 8), {"ode_block_rk2": 33}),
    ]
    with torch.no_grad():
        for op, wrapper, args, launches in cases:
            reset_launch_counts()
            got = op(*args)
            torch.cuda.synchronize()
            assert launch_counts() == launches
            assert torch.equal(got, wrapper(*args))
            torch.library.opcheck(op, args)


def test_exported_models_serve_on_the_card(dev, tmp_path):
    """export_model on the card and on the CPU, load_model onto the card:
    the live path's launches a request, and its logits bit for bit from
    the card's artifact (the CPU's traced its strided convs in another
    layout: within the serving bars)."""
    from neural_ode_metasolver_tpu_torch import (
        launch_counts,
        reset_launch_counts,
    )
    from neural_ode_metasolver_tpu_torch.models import build_model
    from neural_ode_metasolver_tpu_torch.ops import parse_solver_dsl
    from neural_ode_metasolver_tpu_torch.serving import (
        ServedModel,
        export_model,
        load_model,
    )

    solvers = parse_solver_dsl("rk2,u,8,-1,0.5,-1")
    for name, kw, shape, cdt, want in (
            ("mnist", {"dim": 16}, (28, 28, 1), None,
             {"group_norm_act": 51, "conv3x3_same": 32}),
            ("premetanode10", {"in_planes": 16}, (32, 32, 3),
             torch.bfloat16, {"conv3x3_same": 4, "ode_block_rk2": 66})):
        for where in ("cuda", "cpu"):
            model = build_model(name, device=where, **kw,
                                generator=torch.Generator().manual_seed(0))
            path = str(tmp_path / f"{name}_{where}")
            export_model(path, model, solvers, input_shape=(1,) + shape,
                         compute_dtype=cdt)
            served = load_model(path)
            live = ServedModel(model.to(dev), solvers, compute_dtype=cdt)
            for b in (1, 5):
                x = _randn((b,) + shape, 1.0, b, dev, torch.float32)
                reset_launch_counts()
                got = served(x)
                torch.cuda.synchronize()
                assert launch_counts() == want
                ref = live(x)
                if where == "cuda":
                    assert torch.equal(got, ref)
                top = ref.abs().max().item()
                bar = 1e-4 * max(1.0, top) if cdt is None else 2 ** -5 * top
                assert (got - ref).abs().max().item() <= bar


# GeLUpoly (ops/gelu_poly.py, csrc/gelu_poly.cu): the flagship's two
# activation shapes, a size that is not a multiple of 8 (the vector loop's
# ragged end) and a view whose pointer is 2 bytes off 16-byte alignment
# (the one-value-at-a-time path)
GELU_POLY_SHAPES = [(256, 32, 32, 64), (256, 16, 16, 128), (3, 7, 11, 5)]


def _gelu_poly_inputs(shape, dtype, dev, offset=0):
    """x spread over the clamp's edges (scale 4, a few beyond +-8, exact
    +-8 and 0) and an output gradient, both ``offset`` values into their
    buffers."""
    n = int(np.prod(shape))
    x = _randn((n + offset,), 4.0, 11, dev, torch.float32)
    x[offset:offset + 4] = torch.tensor([8.0, -8.0, 0.0, -0.0])
    g = _randn((n + offset,), 1.0, 12, dev, torch.float32)
    return (x.to(dtype)[offset:].view(shape),
            g.to(dtype)[offset:].view(shape))


def _gelu_poly_bars(x, g, ref32, dtype):
    """Elementwise bars against the plain version computed in f32 on the
    same inputs, whose arithmetic the kernels repeat op for op (only tanhf
    may differ): f32 four ulps of |x| forward (y is x times phi in [0, 1],
    and phi one ulp apart moves y by an ulp of x), four of (1 + |x|) |g|
    backward (the slope's terms reach |x|); bf16 one bf16 ulp of the f32
    result, which both round once.  ``g`` None: the forward."""
    if dtype == torch.bfloat16:
        _, e = torch.frexp(ref32)
        return torch.ldexp(torch.ones_like(ref32), e - 8)
    xf = x.float().abs()
    return 4 * 2.0 ** -23 * (xf if g is None else (1 + xf) * g.abs())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,offset", [(s, 0) for s in GELU_POLY_SHAPES]
                         + [((4, 9, 9, 64), 1)])
def test_gelu_poly_kernels_match_plain(dev, dtype, shape, offset):
    """Both kernels against the plain versions computed in f32 on the same
    (rounded) inputs: the composition forward, the analytic derivative
    backward (itself held to autograd of the composition on the CPU), at
    ``_gelu_poly_bars``; each launch counted once and repeating its bits."""
    from neural_ode_metasolver_tpu_torch import (
        launch_counts,
        reset_launch_counts,
    )
    from neural_ode_metasolver_tpu_torch.ops.gelu_poly import (
        fused_gelu_poly,
        gelu_poly_backward,
        gelu_poly_backward_reference,
        gelu_poly_reference,
    )

    x, g = _gelu_poly_inputs(shape, dtype, dev, offset)
    assert (x.data_ptr() % 16 != 0) == bool(offset)
    xg = x.detach().clone().requires_grad_(True)  # aligned: autograd's copy
    reset_launch_counts()
    y = fused_gelu_poly(x)
    torch.cuda.synchronize()
    assert launch_counts() == {"gelu_poly": 1}
    assert y.dtype == dtype and y.shape == x.shape
    ref = gelu_poly_reference(x.float())
    assert ((y.float() - (ref if dtype == torch.float32 else ref.to(dtype)
                           .float())).abs()
            <= _gelu_poly_bars(x, None, ref, dtype)).all()
    assert torch.equal(y, fused_gelu_poly(x))
    yg = fused_gelu_poly(xg)
    assert torch.equal(yg, y)
    reset_launch_counts()
    yg.backward(g)
    dx = xg.grad
    torch.cuda.synchronize()
    assert launch_counts() == {"gelu_poly_bwd": 1}
    assert dx.dtype == dtype
    dref = gelu_poly_backward_reference(x.float(), g.float())
    assert ((dx.float() - (dref if dtype == torch.float32
                           else dref.to(dtype).float())).abs()
            <= _gelu_poly_bars(x, g, dref, dtype)).all()
    # an unaligned gradient and x take the one-value path, bit for bit
    assert torch.equal(gelu_poly_backward(x, g), dx)
    assert torch.equal(gelu_poly_backward(x, g), gelu_poly_backward(x, g))


def test_gelu_poly_kernel_raises_and_serves_as_an_op(dev):
    """A CUDA tensor the kernels do not take raises; ``nodems::gelu_poly``
    launches what the wrapper launches; ``models/nn.py`` sends f16 and
    ``use_kernels=False`` to the composition and a strided view to the
    kernel on a contiguous copy."""
    from neural_ode_metasolver_tpu_torch import (
        launch_counts,
        reset_launch_counts,
    )
    from neural_ode_metasolver_tpu_torch.models import nn as fnn
    from neural_ode_metasolver_tpu_torch.ops.gelu_poly import (
        fused_gelu_poly,
        gelu_poly_reference,
    )

    x = _randn((4, 8, 8, 16), 3.0, 0, dev, torch.bfloat16)
    with pytest.raises(ValueError):
        fused_gelu_poly(x.half())
    with pytest.raises(ValueError):
        fused_gelu_poly(x.transpose(1, 2))
    reset_launch_counts()
    with torch.no_grad():
        got = torch.ops.nodems.gelu_poly(x)
    assert launch_counts() == {"gelu_poly": 1}
    assert torch.equal(got, fused_gelu_poly(x))
    torch.library.opcheck(torch.ops.nodems.gelu_poly, (x,))
    reset_launch_counts()
    assert torch.equal(fnn.gelu_poly(x.half()), gelu_poly_reference(
        x.half()))
    assert torch.equal(fnn.get_activation("GeLUpoly", False)(x),
                       gelu_poly_reference(x))
    assert launch_counts() == {}
    xt = x.transpose(1, 2)
    assert torch.equal(fnn.gelu_poly(xt),
                       fused_gelu_poly(xt.contiguous()))


def test_gelu_poly_under_vmap_in_the_ensemble(dev):
    """``parallel/ensemble.py::ensemble_integrate`` runs its RHS under
    ``torch.func.vmap``: a GeLUpoly RHS there launches the kernels (the
    Function's vmap rule on the unbatched tensor), forward and backward,
    and matches the same ensemble on the composition."""
    from neural_ode_metasolver_tpu_torch import (
        launch_counts,
        reset_launch_counts,
    )
    from neural_ode_metasolver_tpu_torch.models import nn as fnn
    from neural_ode_metasolver_tpu_torch.ops import create_solver
    from neural_ode_metasolver_tpu_torch.ops.gelu_poly import (
        gelu_poly_reference,
    )
    from neural_ode_metasolver_tpu_torch.parallel import ensemble_integrate

    solvers = [create_solver("rk2", "u", n_steps=4, u0=u)
               for u in (0.5, 0.7, 1.0)]
    y0 = _randn((8, 6, 6, 16), 2.0, 3, dev, torch.float32)
    out = {}
    for uk in (True, False):
        y = y0.clone().requires_grad_(True)
        act = fnn.gelu_poly if uk else gelu_poly_reference
        rhs = lambda t, v: act(v) - 0.5 * v  # noqa
        reset_launch_counts()
        z = ensemble_integrate(solvers, rhs, y, [0.5, 0.3, 0.2])
        z.square().sum().backward()
        torch.cuda.synchronize()
        out[uk] = (z.detach(), y.grad, launch_counts())
    (zk, gk, ck), (zp, gp_, cp) = out[True], out[False]
    # one call a stage for all members: 4 steps x 2 stages
    assert ck == {"gelu_poly": 8, "gelu_poly_bwd": 8} and cp == {}
    assert (zk - zp).abs().max() <= 1e-5 * zp.abs().max()
    assert (gk - gp_).abs().max() <= 1e-5 * gp_.abs().max()


def test_flagship_gelu_poly_step_within_the_cell_limits(dev):
    """The flagship cell's step (premetanode10 at in_planes 64, batch 256,
    FGSM-random, Normal(0.0125) smoothing, SGD on the cyclic lr) in bf16
    with the kernels, against ``use_kernels=False`` in f32 (the cell's
    plain reference precision) from the same weights, batches and step
    seed, over three steps, within the limits of
    ``benchmark/cells/premetanode10.advtrain.b256.json`` (``loss_gap``
    1e-4, ``grad_gap`` 8e-3, ``change_gap`` 0.03, measured as
    ``benchmark/harness/compare.py`` does); the kernel step launches 138
    GeLUpoly kernels each way."""
    import statistics

    from neural_ode_metasolver_tpu_torch import (
        launch_counts,
        reset_launch_counts,
    )
    from neural_ode_metasolver_tpu_torch.models import build_model
    from neural_ode_metasolver_tpu_torch.ops import (
        SolverOptions,
        parse_solver_dsl,
    )
    from neural_ode_metasolver_tpu_torch.training import (
        AttackConfig,
        NoiseConfig,
        create_train_state,
        cyclic_lr,
        make_optimizer,
        make_train_step,
    )

    mean, std = (0.4914, 0.4822, 0.4465), (0.2023, 0.1994, 0.2010)
    model = build_model("premetanode10", in_planes=64, acts=("GeLUpoly",) * 3,
                        generator=torch.Generator().manual_seed(0))
    solvers = parse_solver_dsl("rk2,u,8,-1,0.5,-1")
    attack = AttackConfig(mode="fgsm_random", eps=8 / 255, alpha=10 / 255,
                          mean=mean, std=std)
    noise = NoiseConfig(noise_type="normal", sigma=0.0125, prob=1.0)
    xs = _randn((3, 256, 32, 32, 3), 1.0, 21, dev, torch.float32)
    ys = torch.tensor(np.random.RandomState(22).randint(0, 10, (3, 256)),
                      device=dev)
    weights = {k: p.detach().clone() for k, p in model.named_parameters()}
    runs = {}
    for uk, dtype in ((True, torch.bfloat16), (False, None)):
        with torch.no_grad():
            for k, p in model.named_parameters():
                p.copy_(weights[k])
        opt = make_optimizer("sgd", cyclic_lr(1e-7, 0.1, 3186), momentum=0.9,
                             weight_decay=5e-4)
        state = create_train_state(model, opt)
        step = make_train_step(model, opt, solvers, SolverOptions(), attack,
                               noise, compute_dtype=dtype, use_kernels=uk)
        gen = torch.Generator().manual_seed(23)
        losses, grads = [], None
        reset_launch_counts()
        for i in range(3):
            state, m = step(state, xs[i], ys[i], gen)
            losses.append(m["loss"].item())
            if grads is None:
                grads = {k: v.detach().clone().double()
                         for k, v in state.opt_state["momentum"].items()}
                counts = launch_counts()
        change = {k: (p.detach() - weights[k]).double()
                  for k, p in state.params.items()}
        runs[uk] = (losses, grads, change, counts)
        del state, step
        torch.cuda.empty_cache()
    (lk, gk, ck, nk), (lp, gp_, cp, np_) = runs[True], runs[False]
    assert nk["gelu_poly"] == 138 and nk["gelu_poly_bwd"] == 138
    assert np_ == {}

    def gaps(prog, ref, keep):
        norm = {k: torch.linalg.vector_norm(v).item() for k, v in ref.items()}
        med = statistics.median(norm[k] for k in keep)
        return [abs(torch.linalg.vector_norm(prog[k]).item() - norm[k])
                / max(norm[k], med, 1e-30) for k in keep]

    gnorm = {k: torch.linalg.vector_norm(v).item() for k, v in gp_.items()}
    gmed = statistics.median(gnorm.values())
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(lk, lp))
    grad_gap = max(gaps(gk, gp_, list(gp_)))
    change_gap = max(gaps(ck, cp, [k for k in cp if gnorm[k] >= 1e-3 * gmed]))
    print(f"loss_gap {loss_gap:.3g} grad_gap {grad_gap:.3g} change_gap "
          f"{change_gap:.3g}")
    assert loss_gap <= 1e-4 and grad_gap <= 8e-3 and change_gap <= 0.03
