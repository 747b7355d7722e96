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
