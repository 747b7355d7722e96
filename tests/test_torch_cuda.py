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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,act", [
    ((2, 26, 26, 64), "relu"), ((2, 13, 13, 64), "relu"),
    ((3, 6, 6, 64), "relu"), ((3, 6, 6, 64), None),
    ((2, 7, 5, 96), "gelu"), ((2, 4, 4, 16), "tanh"),
    ((2, 3, 3, 640), "softsign"),   # one row of threads per pass
    ((2, 30, 30, 128), "relu"),     # f32 sample too large to stage
])
def test_group_norm_kernel_matches_plain(dev, dtype, shape, act):
    from neural_ode_metasolver_tpu_torch import (
        launch_counts,
        reset_launch_counts,
    )
    from neural_ode_metasolver_tpu_torch.ops.group_norm import (
        fused_group_norm_act,
        group_norm_reference,
    )

    c = shape[-1]
    x = (_randn(shape, 2.0, 0, dev, torch.float32) + 0.5).to(dtype)
    scale = _randn((c,), 0.3, 1, dev, torch.float32) + 1.0
    bias = _randn((c,), 0.5, 2, dev, torch.float32)
    groups = min(32, c)
    reset_launch_counts()
    got = fused_group_norm_act(x, scale, bias, groups, act=act)
    torch.cuda.synchronize()
    assert launch_counts() == {"group_norm_act": 1}
    assert got.dtype == dtype and got.shape == x.shape
    ref = group_norm_reference(x, scale, bias, groups, act=act)
    refmax = ref.float().abs().max()
    # f32: the JAX test's 2e-4; bf16: both round once at the same point,
    # two bf16 ulps of the largest output
    bar = (2e-4 * max(1.0, refmax) if dtype == torch.float32
           else 2.0 ** -6 * refmax)
    assert (got.float() - ref.float()).abs().max() <= bar


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
    with pytest.raises(ValueError):
        fused_group_norm_act(torch.zeros(1, 2, 2, 1040, device=dev),
                             torch.ones(1040, device=dev),
                             torch.ones(1040, device=dev), 8)
