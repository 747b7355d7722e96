"""Kernel B3 (``ops/group_norm.py``) against the JAX package.

On CPU tensors ``fused_group_norm_act`` runs its plain version, which must
match the Pallas kernel run in interpret mode and the JAX two-pass
reference at the bars of ``tests/test_pallas.py`` (atol 2e-4 in f32, 3e-2
with bf16 I/O), also above 1024 channels; ``nn.group_norm`` must match the
JAX ``nn.group_norm``.  ``launch_plan`` (pure Python) must pick the paths
the MNIST shapes are designed for, stay within a block's shared memory and
a portable cluster, and lay threads out so that each element is read
once.  The gradient (the autograd Function, whose backward on CPU tensors is
``group_norm_backward_reference``) must match ``jax.vjp`` of the Pallas
kernel at the bars of ``tests/test_pallas.py:41-57`` (atol/rtol 5e-4), and
the backward's plans must cover every element once within a block's
resources.  The CUDA kernels themselves are checked against the plain
versions on the card (``test_torch_cuda.py``).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from neural_ode_metasolver_tpu.models import nn as j_nn
from neural_ode_metasolver_tpu.ops.pallas_kernels import (
    fused_group_norm_act as j_fused_group_norm_act,
    group_norm_reference as j_group_norm_reference,
)
from neural_ode_metasolver_tpu_torch import launch_counts, reset_launch_counts
from neural_ode_metasolver_tpu_torch.models import nn as fnn
from neural_ode_metasolver_tpu_torch.ops.group_norm import (
    TWO_A_SM,
    _bwd_smem_bytes,
    _layout,
    _per_thread,
    access,
    fused_group_norm_act,
    group_norm_backward,
    group_norm_backward_reference,
    group_norm_reference,
    launch_plan,
)


def _inputs(shape, seed=0):
    """x with a mean offset and spread per channel, as a GN input has;
    scale and bias away from the identity so the affine is exercised."""
    rs = np.random.RandomState(seed)
    c = shape[-1]
    x = (rs.randn(*shape) * 2 + 0.5).astype(np.float32)
    scale = (rs.rand(c) + 0.5).astype(np.float32)
    bias = rs.randn(c).astype(np.float32)
    return x, scale, bias


@pytest.mark.parametrize("shape", [(2, 6, 6, 64), (2, 13, 13, 64)])
@pytest.mark.parametrize("groups", [8, 32])
@pytest.mark.parametrize("act", [None, "relu", "gelu", "tanh", "softsign"])
def test_b3_plain_matches_pallas_and_jax_reference(shape, groups, act):
    x, scale, bias = _inputs(shape)
    jx, js, jb = (jnp.asarray(a) for a in (x, scale, bias))
    pallas = np.asarray(j_fused_group_norm_act(jx, js, jb, groups, 1e-5, act,
                                               True))  # interpret
    ref_j = np.asarray(j_group_norm_reference(jx, js, jb, groups, 1e-5, act))
    got = fused_group_norm_act(torch.tensor(x), torch.tensor(scale),
                               torch.tensor(bias), groups, 1e-5, act)
    assert got.dtype == torch.float32 and got.shape == x.shape
    np.testing.assert_allclose(got.numpy(), pallas, atol=2e-4)
    np.testing.assert_allclose(got.numpy(), ref_j, atol=2e-4)


def test_b3_plain_bf16_io():
    x, scale, bias = _inputs((2, 6, 6, 64), seed=1)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    pallas = np.asarray(j_fused_group_norm_act(
        xb, jnp.asarray(scale), jnp.asarray(bias), 8, 1e-5, "relu", True
    ).astype(jnp.float32))
    got = fused_group_norm_act(torch.tensor(x).to(torch.bfloat16),
                               torch.tensor(scale), torch.tensor(bias), 8,
                               1e-5, "relu")
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), pallas, atol=3e-2)


def test_b3_refuses_channels_not_divisible_by_groups():
    x, scale, bias = (torch.tensor(a) for a in _inputs((1, 4, 4, 12)))
    with pytest.raises(ValueError, match="divisible"):
        fused_group_norm_act(x, scale, bias, 8)
    with pytest.raises(ValueError, match="divisible"):
        group_norm_reference(x, scale, bias, 8)
    with pytest.raises(ValueError, match="activation"):
        fused_group_norm_act(x, scale, bias, 4, act="swish")
    with pytest.raises(ValueError, match="scale"):
        fused_group_norm_act(x, scale[:6], bias, 4)


def test_b3_wrapper_on_cpu_is_the_plain_version_and_counts_nothing():
    x, scale, bias = (torch.tensor(a) for a in _inputs((1, 5, 7, 16), 2))
    reset_launch_counts()
    a = fused_group_norm_act(x, scale, bias, 4, act="relu")
    torch.testing.assert_close(
        a, group_norm_reference(x, scale, bias, 4, act="relu"), rtol=0,
        atol=0)
    assert launch_counts() == {}


@pytest.mark.parametrize("use_kernels", [True, False])
def test_nn_group_norm_matches_jax(use_kernels):
    x, scale, bias = _inputs((2, 6, 6, 32), seed=3)
    ref = np.asarray(j_nn.group_norm(
        {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)},
        jnp.asarray(x), 8))
    got = fnn.group_norm({"scale": torch.tensor(scale),
                          "bias": torch.tensor(bias)}, torch.tensor(x), 8,
                         use_kernels=use_kernels)
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-4)
    init = fnn.group_norm_init(32)
    assert torch.equal(init["scale"], torch.ones(32))
    assert torch.equal(init["bias"], torch.zeros(32))


def test_b3_plain_matches_pallas_above_1024_channels():
    """The CUDA wrapper takes any C with C % G == 0, as the JAX kernel does;
    its plain version holds the Pallas kernel there too."""
    x, scale, bias = _inputs((1, 2, 2, 1056), seed=4)
    jx, js, jb = (jnp.asarray(a) for a in (x, scale, bias))
    pallas = np.asarray(j_fused_group_norm_act(jx, js, jb, 32, 1e-5, "relu",
                                               True))  # interpret
    got = fused_group_norm_act(torch.tensor(x), torch.tensor(scale),
                               torch.tensor(bias), 32, 1e-5, "relu")
    np.testing.assert_allclose(got.numpy(), pallas, atol=2e-4)


_MNIST_BATCHES = (1, 128, 256)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", _MNIST_BATCHES)
@pytest.mark.parametrize("hw", [6, 13])
def test_b3_plan_keeps_small_mnist_samples_in_one_block(dtype, n, hw):
    plan = launch_plan(n, hw, hw, 64, 32, dtype)
    assert plan.path == "register" and plan.cluster == 1 and plan.regs > 0
    assert plan.vec == 16 // (torch.finfo(dtype).bits // 8)


@pytest.mark.parametrize("shape", [
    (256, 26, 26, 64), (256, 32, 32, 64), (2, 30, 30, 128),
    (1, 29, 31, 64),  # its last slice is ragged
])
def test_b3_plan_splits_large_f32_samples_over_a_cluster(shape):
    plan = launch_plan(*shape, 32, torch.float32)
    assert plan.path == "cluster" and 2 <= plan.cluster <= 8
    assert plan.regs > 0  # held in registers: x is read once
    if shape == (1, 29, 31, 64):
        assert (29 * 31) % plan.cluster


def test_b3_plan_rereads_only_samples_too_large_for_8_blocks():
    """Where shuffles can sum the groups, only samples too large for 8
    blocks re-read x; layouts they cannot sum re-read at any size."""
    for dtype in (torch.float32, torch.bfloat16):
        assert launch_plan(1, 48, 48, 128, 32, dtype).path == "reread"
        assert launch_plan(2, 30, 30, 128, 32, dtype).path == "cluster"
    # 16-byte access needs C * itemsize % 16 == 0 and an aligned pointer
    plan = launch_plan(2, 5, 5, 6, 3, torch.float32)
    assert plan.vec == 1 and plan.path == "reread" and plan.cluster == 1
    plan = launch_plan(3, 6, 6, 64, 32, torch.float32, aligned=False)
    assert plan.vec == 1 and plan.path == "reread"
    # cg 3: groups straddle 16-byte vectors
    assert access(96, 32, torch.float32) == (4, False)
    assert launch_plan(2, 7, 5, 96, 32, torch.float32).path == "reread"


def _covered(plan, n, hw, c):
    """How often the plan's threads touch each element of x (n, hw, c),
    following the thread layout of csrc/group_norm_act.cu."""
    hits = np.zeros((n, hw, c), np.int64)
    threads = 32 * plan.warps
    vpp, cols, rows, ncols = _layout(c, plan.vec, threads)
    k = plan.cluster
    per = -(-hw // k)
    for blk in range(n * k):
        sample, rank = divmod(blk, k)
        p0 = min(hw, rank * per)
        npx = min(hw, p0 + per) - p0
        for t in range(threads):
            col0, row0 = t % cols, t // cols
            if row0 >= rows:
                continue
            for j in range(ncols):
                cv = col0 + j * cols
                if cv >= vpp:
                    continue
                for p in range(p0 + row0, p0 + npx, rows):
                    chans = slice(cv * plan.vec, (cv + 1) * plan.vec)
                    hits[sample, p, chans] += 1
    return hits


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,groups,aligned", [
    ((3, 6, 6, 64), 32, True), ((2, 13, 13, 64), 32, True),
    ((2, 26, 26, 64), 32, True), ((1, 29, 31, 64), 32, True),
    ((2, 7, 5, 96), 8, True), ((2, 3, 3, 640), 32, True),
    ((2, 5, 5, 6), 3, True), ((1, 2, 2, 1056), 32, True),
    ((2, 1, 1, 64), 32, True), ((3, 6, 6, 64), 32, False),
    ((1, 48, 48, 128), 32, True),
])
def test_b3_plan_touches_every_element_once(dtype, shape, groups, aligned):
    n, h, w, c = shape
    plan = launch_plan(n, h, w, c, groups, dtype, aligned=aligned)
    assert (_covered(plan, n, h * w, c) == 1).all()
    if plan.regs:  # every thread's share fits its registers
        assert _per_thread(h * w, c, plan.vec, 32 * plan.warps,
                           plan.cluster) <= plan.regs


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_b3_plans_stay_within_a_block_and_a_cluster(dtype):
    rs = np.random.RandomState(5)
    shapes = [(256, 26, 26, 64), (256, 32, 32, 64), (8, 64, 64, 256),
              (1, 1, 1, 4096), (4, 3, 3, 8192), (2, 112, 112, 64)]
    for _ in range(200):
        c = int(rs.choice([3, 6, 8, 16, 24, 32, 64, 96, 128, 320, 1056]))
        shapes.append((int(rs.randint(1, 300)), int(rs.randint(1, 70)),
                       int(rs.randint(1, 70)), c))
    for n, h, w, c in shapes:
        for groups in {g for g in (1, 2, 3, 8, 32, c) if c % g == 0}:
            for aligned in (True, False):
                plan = launch_plan(n, h, w, c, groups, dtype,
                                   aligned=aligned)
                assert plan.smem_bytes <= 232448
                assert 1 <= plan.cluster <= 8
                assert 32 * plan.warps <= 256
                # x stays in registers only where shuffles sum the groups
                assert (plan.regs > 0) == (plan.path != "reread")
                if plan.regs:
                    assert access(c, groups, dtype, aligned)[1]


@pytest.mark.parametrize("act", [None, "relu", "gelu", "tanh", "softsign"])
@pytest.mark.parametrize("shape,groups", [((2, 6, 6, 64), 32),
                                          ((2, 5, 5, 48), 16)])
def test_b3_gradient_matches_pallas_vjp(act, shape, groups):
    """dx, dscale and dbias through fused_group_norm_act on CPU tensors
    (the autograd Function, backward group_norm_backward_reference) against
    jax.vjp of the Pallas kernel in interpret mode: atol/rtol 5e-4."""
    x, scale, bias = _inputs(shape, seed=6)
    g = np.random.RandomState(7).randn(*shape).astype(np.float32)
    _, vjp = jax.vjp(lambda a, s, b: j_fused_group_norm_act(
        a, s, b, groups, 1e-5, act, True), *(jnp.asarray(v) for v in (
            x, scale, bias)))
    want = vjp(jnp.asarray(g))
    ts = [torch.tensor(v, requires_grad=True) for v in (x, scale, bias)]
    out = fused_group_norm_act(*ts, groups, 1e-5, act)
    assert out.grad_fn is not None
    got = torch.autograd.grad(out, ts, torch.tensor(g))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b, np.float32),
                                   atol=5e-4, rtol=5e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("act", [None, "relu", "gelu", "tanh", "softsign"])
def test_b3_backward_reference_matches_autograd(dtype, act):
    """group_norm_backward_reference against torch autograd through
    group_norm_reference: f32 within 1e-5 (dx relative to its largest);
    bf16 x and dout, dx within two bf16 ulps of its largest; dscale and
    dbias in f32 within 1e-5 relative; params=False returns dx only."""
    x, scale, bias = _inputs((2, 5, 7, 16), seed=8)
    g = np.random.RandomState(9).randn(*x.shape).astype(np.float32)
    xt = torch.tensor(x).to(dtype).requires_grad_(True)
    st, bt = (torch.tensor(v, requires_grad=True) for v in (scale, bias))
    gt = torch.tensor(g).to(dtype)
    want = torch.autograd.grad(group_norm_reference(xt, st, bt, 4, act=act),
                               (xt, st, bt), gt)
    got = group_norm_backward_reference(xt.detach(), st.detach(),
                                        bt.detach(), gt, 4, act=act)
    assert got[0].dtype == dtype and got[1].dtype == torch.float32
    dx_bar = (1e-5 if dtype == torch.float32 else 2.0 ** -6) * float(
        want[0].float().abs().max())
    assert (got[0].float() - want[0].float()).abs().max() <= dx_bar
    for a, b in zip(got[1:], want[1:]):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    dx, ds, db = group_norm_backward(xt.detach(), st.detach(), bt.detach(),
                                     gt, 4, act=act, params=False)
    assert ds is None and db is None and torch.equal(dx, got[0])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,groups", [
    ((2, 26, 26, 64), 32), ((2, 13, 13, 64), 32), ((3, 6, 6, 64), 32),
    ((1, 32, 32, 64), 32), ((1, 29, 31, 64), 32), ((2, 6, 6, 48), 16),
    ((1, 2, 2, 1056), 32), ((2, 5, 5, 6), 3), ((1, 48, 48, 128), 32),
])
def test_b3_backward_plan_touches_every_element_once(dtype, shape, groups):
    """The backward's plan: the staged path (x and dout in shared memory)
    with 16-byte access, as few blocks a sample as leave two blocks an SM,
    so MNIST's 26x26 goes to more blocks of a cluster than the forward's;
    re-reading otherwise; every element is read by one thread."""
    n, h, w, c = shape
    fwd = launch_plan(n, h, w, c, groups, dtype)
    plan = launch_plan(n, h, w, c, groups, dtype, backward=True)
    assert plan.regs == 0 and plan.path in ("staged", "reread")
    # 48x48x128 is too large for 8 staged blocks
    assert (plan.path == "staged") == (plan.vec > 1 and h < 48)
    assert plan.stash and plan.cluster >= fwd.cluster
    assert (_covered(plan, n, h * w, c) == 1).all()
    assert plan.smem_bytes == _bwd_smem_bytes(
        plan.path, c, groups, plan.vec, plan.warps, plan.cluster, h * w,
        dtype.itemsize, True)
    if plan.path == "staged":  # the fewest blocks that fit two an SM
        assert plan.smem_bytes <= TWO_A_SM
        assert plan.warps == (4 if plan.cluster == 1 else 8)
        assert plan.cluster == 1 or _bwd_smem_bytes(
            "staged", c, groups, plan.vec, 4 if plan.cluster == 2 else 8,
            plan.cluster - 1, h * w, dtype.itemsize, True) > TWO_A_SM
    if (h, w, c) == (26, 26, 64):
        assert plan.path == "staged" and plan.cluster == (
            4 if dtype == torch.float32 else 3)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_b3_backward_plans_stay_within_a_block_and_a_cluster(dtype):
    rs = np.random.RandomState(6)
    shapes = [(256, 26, 26, 64), (256, 32, 32, 64), (8, 64, 64, 256),
              (2, 112, 112, 64)]
    for _ in range(200):
        c = int(rs.choice([3, 6, 8, 16, 24, 32, 64, 96, 128, 320, 1056]))
        shapes.append((int(rs.randint(1, 300)), int(rs.randint(1, 70)),
                       int(rs.randint(1, 70)), c))
    for n, h, w, c in shapes:
        for groups in {g for g in (1, 2, 3, 8, 32, c) if c % g == 0}:
            for aligned in (True, False):
                plan = launch_plan(n, h, w, c, groups, dtype,
                                   aligned=aligned, backward=True)
                assert plan.smem_bytes <= 232448
                assert 1 <= plan.cluster <= 8 and plan.regs == 0
                assert 32 * plan.warps <= 256
                # staged needs 16-byte access (bulk copies) and two blocks
                # an SM; re-reading keeps the stash where it fits
                assert plan.path in ("staged", "reread")
                if plan.path == "staged":
                    assert plan.vec > 1 and plan.stash
                    assert plan.smem_bytes <= TWO_A_SM
