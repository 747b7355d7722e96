"""The port's kernel modules against the JAX package's Pallas kernels.

B1 (``ops/conv3x3.py``) and B2 (``ops/ode_block.py``): on CPU tensors each
wrapper runs its plain version, which must match the JAX reference and the
Pallas kernel run in interpret mode, at the bars of ``tests/test_pallas.py``
and ``tests/test_pallas_ode_block.py``.  B1's backward (dgrad on B1, the
wgrad's plain version) is held to ``jax.vjp`` of the JAX reference, and so
is a plain replay of the wgrad kernel's TMA decomposition (whole-row K
steps, zero-filled boxes, taps as row offsets, split ranges in order).  B2's
launch schedule (which buffer each launch reads and writes) runs here
through a plain executor of each launch.  The CUDA kernels themselves are checked against these plain
versions on the card (``test_torch_cuda.py``).
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from neural_ode_metasolver_tpu.ops.pallas_im2col import (
    conv3x3_im2col_gemm,
    reference_conv3x3 as j_reference_conv3x3,
)
from neural_ode_metasolver_tpu.ops.pallas_ode_block import (
    ode_block_rk2_forward as j_ode_block_rk2_forward,
)
from neural_ode_metasolver_tpu_torch import launch_counts, reset_launch_counts
from neural_ode_metasolver_tpu_torch.ops.conv3x3 import (
    conv3x3_dgrad,
    conv3x3_same,
    conv3x3_wgrad,
    reference_conv3x3,
    reference_conv3x3_wgrad,
    run_wgrad_plan,
    wgrad_plan,
)
from neural_ode_metasolver_tpu_torch.ops.ode_block import (
    GELU,
    STAGE1,
    STAGE2,
    launch_schedule,
    ode_block_rk2_forward,
    plain_launch,
    reference_ode_block_rk2,
    run_schedule,
)


def _conv_inputs(n, h, w, cin, cout, seed=0):
    rs = np.random.RandomState(seed)
    x = rs.randn(n, h, w, cin).astype(np.float32)
    k = (rs.randn(3, 3, cin, cout) * 0.1).astype(np.float32)
    return x, k


CONV_SHAPES = [(2, 8, 8, 24, 40), (2, 8, 8, 3, 16), (1, 5, 7, 16, 8)]


@pytest.mark.parametrize("shape", CONV_SHAPES)
def test_b1_plain_matches_jax_reference_and_pallas(shape):
    """atol 2e-5 in f32: the bar of tests/test_pallas.py's im2col test."""
    x, k = _conv_inputs(*shape)
    n, h, w, _, _ = shape
    ref_j = np.asarray(j_reference_conv3x3(jnp.asarray(x), jnp.asarray(k)))
    got = conv3x3_same(torch.tensor(x), torch.tensor(k))
    assert got.dtype == torch.float32 and got.is_contiguous()
    np.testing.assert_allclose(got.numpy(), ref_j, atol=2e-5)
    m = n * h * w
    m_tile = next(t for t in (32, 35, 16, 8, 1) if m % t == 0)
    pallas = np.asarray(conv3x3_im2col_gemm(
        jnp.asarray(x), jnp.asarray(k), m_tile=m_tile, interpret=True))
    np.testing.assert_allclose(got.numpy(), pallas, atol=2e-5)


def test_b1_plain_bf16_matches_jax_reference():
    """bf16 in, f32 sums, one rounding at the output in both: equal up to a
    rounding flip, one bf16 ulp of the largest output (2**-7 * max)."""
    x, k = _conv_inputs(2, 8, 8, 16, 32, seed=1)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    kb = jnp.asarray(k).astype(jnp.bfloat16)
    ref_j = np.asarray(j_reference_conv3x3(xb, kb).astype(jnp.float32))
    got = conv3x3_same(torch.tensor(x).to(torch.bfloat16),
                       torch.tensor(k).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16
    bar = 2.0 ** -7 * np.abs(ref_j).max()
    np.testing.assert_allclose(got.float().numpy(), ref_j, atol=bar)


def test_b1_wrapper_on_cpu_is_the_plain_version_and_counts_nothing():
    x, k = _conv_inputs(1, 4, 4, 8, 8, seed=2)
    reset_launch_counts()
    a = conv3x3_same(torch.tensor(x), torch.tensor(k))
    torch.testing.assert_close(a, reference_conv3x3(torch.tensor(x),
                                                    torch.tensor(k)),
                               rtol=0, atol=0)
    assert launch_counts() == {}
    with pytest.raises(ValueError):
        conv3x3_same(torch.tensor(x), torch.tensor(k)[:, :, :4])


def _ode_inputs(n=2, h=8, w=8, c=16, seed=0):
    rs = np.random.RandomState(seed)
    y0 = (rs.randn(n, h, w, c) * 0.5).astype(np.float32)
    w1 = (rs.randn(3, 3, c, c) * 0.1).astype(np.float32)
    w2 = (rs.randn(3, 3, c, c) * 0.1).astype(np.float32)
    return y0, w1, w2


@pytest.mark.parametrize("u,n_steps", [(0.5, 2), (0.5, 8), (1.0, 4),
                                       (2 / 3, 3)])
def test_b2_plain_matches_pallas(u, n_steps):
    """atol 2e-5 in f32: the bar of tests/test_pallas_ode_block.py."""
    y0, w1, w2 = _ode_inputs()
    pallas = np.asarray(j_ode_block_rk2_forward(
        jnp.asarray(y0), jnp.asarray(w1), jnp.asarray(w2), u, n_steps,
        interpret=True))
    got = ode_block_rk2_forward(torch.tensor(y0), torch.tensor(w1),
                                torch.tensor(w2), u, n_steps)
    assert got.dtype == torch.float32 and got.shape == y0.shape
    np.testing.assert_allclose(got.numpy(), pallas, atol=2e-5)


def test_b2_plain_bf16_tracks_pallas():
    """Same rounding points as the Pallas kernel; what differs is the erf
    (A-S approximation there, exact here) and the order of f32 sums, each
    of which can flip one bf16 rounding of h or of the stage state.  Bar:
    four bf16 ulps of the largest state (2**-5 * max|y|)."""
    y0, w1, w2 = _ode_inputs(seed=3)
    yb = jnp.asarray(y0).astype(jnp.bfloat16)
    pallas = np.asarray(j_ode_block_rk2_forward(
        yb, jnp.asarray(w1).astype(jnp.bfloat16),
        jnp.asarray(w2).astype(jnp.bfloat16), 0.5, 4,
        interpret=True).astype(jnp.float32))
    got = ode_block_rk2_forward(torch.tensor(y0).to(torch.bfloat16),
                                torch.tensor(w1).to(torch.bfloat16),
                                torch.tensor(w2).to(torch.bfloat16), 0.5, 4)
    assert got.dtype == torch.bfloat16
    bar = 2.0 ** -5 * np.abs(pallas).max()
    np.testing.assert_allclose(got.float().numpy(), pallas, atol=bar)


def test_b2_plain_matches_jax_model_ode_block():
    """The plain version equals the flagship ODE block of the JAX model:
    meta_integrate over the premetanode10 RHS (NF norms, exact GeLU)."""
    from neural_ode_metasolver_tpu.models.odenet_cifar10 import (
        _odefunc_apply,
        premetanode10,
    )
    from neural_ode_metasolver_tpu.ops import (
        SolverOptions,
        create_solver,
        meta_integrate,
    )

    cfg = premetanode10(in_planes=16)
    y0, w1, w2 = _ode_inputs(seed=4)
    p_eff = {"conv1": {"kernel": jnp.asarray(w1)},
             "conv2": {"kernel": jnp.asarray(w2)}, "bn1": None, "bn2": None}
    solver = create_solver("rk2", "u", n_steps=4, u0=0.5)
    y_model, _ = meta_integrate(
        [solver], lambda t, y: _odefunc_apply(cfg, p_eff, t, y),
        jnp.asarray(y0), SolverOptions())
    got = ode_block_rk2_forward(torch.tensor(y0), torch.tensor(w1),
                                torch.tensor(w2), 0.5, 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(y_model), atol=2e-5)


def test_b2_wrapper_on_cpu_is_the_plain_version_and_counts_nothing():
    y0, w1, w2 = (torch.tensor(a) for a in _ode_inputs(n=1, h=4, w=4, c=8))
    reset_launch_counts()
    a = ode_block_rk2_forward(y0, w1, w2, 2 / 3, 3)
    torch.testing.assert_close(
        a, reference_ode_block_rk2(y0, w1, w2, 2 / 3, 3), rtol=0, atol=0)
    assert launch_counts() == {}
    with pytest.raises(ValueError):
        ode_block_rk2_forward(y0, w1[:, :, :4], w2, 0.5, 2)
    with pytest.raises(ValueError):
        ode_block_rk2_forward(y0, w1, w2, 0.5, 0)
    with pytest.raises(ValueError):
        ode_block_rk2_forward(y0, w1, w2, 0.0, 2)


def test_b2_launch_schedule_buffers():
    """gelu(y0) once, then per step conv1 -> gh, conv2 -> k1 and gelu of the
    stage input, conv1 -> gh, conv2 -> y (from y0 on the first step, in
    place after) and gelu(y), skipped on the last step."""
    sched = launch_schedule(0.5, 2)
    rows = [(l.op, l.x, l.w, l.out, l.epilogue, l.y, l.aux) for l in sched]
    step = lambda y, aux: [
        ("conv", "g", "w1", "h", GELU, "", ""),
        ("conv", "h", "w2", "g", STAGE1, y, ""),
        ("conv", "g", "w1", "h", GELU, "", ""),
        ("conv", "h", "w2", "y", STAGE2, y, aux),
    ]
    assert rows == ([("gelu", "y0", "", "g", 0, "", "")]
                    + step("y0", "g") + step("y", ""))
    dt = 0.5
    assert [l.a for l in sched if l.epilogue == STAGE1] == [0.5 * dt] * 2
    assert [l.a for l in sched if l.epilogue == STAGE2] == [dt] * 2
    for n_steps in (1, 3, 8):
        for l in launch_schedule(2 / 3, n_steps):
            assert "y0" not in (l.out, l.aux)
            assert l.op == "gelu" or l.x not in (l.out, l.aux)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("u,n_steps", [(0.5, 1), (0.5, 2), (2 / 3, 3)])
def test_b2_launch_schedule_through_plain_launches_equals_plain_version(
        dtype, u, n_steps):
    """The kernel's schedule, each launch run by its plain version (an f32
    conv and the epilogue arithmetic in torch), gives the plain version's
    bits, and never writes y0; 4 n + 1 launches."""
    y0, w1, w2 = (torch.tensor(a).to(dtype) for a in _ode_inputs(seed=5))
    y0_copy = y0.clone()
    assert len(launch_schedule(u, n_steps)) == 4 * n_steps + 1
    got = run_schedule(y0, w1, w2, u, n_steps, plain_launch)
    assert torch.equal(y0, y0_copy)
    assert got.dtype == dtype
    assert torch.equal(got, reference_ode_block_rk2(y0, w1, w2, u, n_steps))


@pytest.mark.parametrize("u,n_steps", [(0.5, 1), (2 / 3, 3)])
def test_b2_launch_schedule_through_plain_launches_matches_pallas(u,
                                                                  n_steps):
    """atol 2e-5 in f32: the bar of test_b2_plain_matches_pallas."""
    y0, w1, w2 = _ode_inputs()
    pallas = np.asarray(j_ode_block_rk2_forward(
        jnp.asarray(y0), jnp.asarray(w1), jnp.asarray(w2), u, n_steps,
        interpret=True))
    got = run_schedule(torch.tensor(y0), torch.tensor(w1), torch.tensor(w2),
                       u, n_steps, plain_launch)
    np.testing.assert_allclose(got.numpy(), pallas, atol=2e-5)


# ------------------------------------------------------- B1's backward --

BWD_SHAPES = [(2, 8, 8, 24, 40), (2, 8, 8, 3, 16), (2, 6, 7, 16, 3),
              (1, 5, 7, 16, 8)]


@pytest.mark.parametrize("shape", BWD_SHAPES)
def test_b1_backward_matches_jax_vjp(shape):
    """conv3x3_same's autograd backward on the plain path (dgrad as B1 on
    flipped weights, wgrad's plain version) against jax.vjp of the JAX
    reference_conv3x3, f32, atol 1e-5; Cin 3 (the stem) and Cout 3 (the
    stem's dgrad) included.  The plain path counts no launch."""
    import jax

    x, k = _conv_inputs(*shape, seed=6)
    # a cotangent at a loss gradient's scale: the wgrad sums stay near 1
    dy = (0.1 * np.random.RandomState(7).randn(*shape[:3], shape[4])).astype(
        np.float32)
    _, vjp = jax.vjp(j_reference_conv3x3, jnp.asarray(x), jnp.asarray(k))
    jx, jk = (np.asarray(a) for a in vjp(jnp.asarray(dy)))
    xt = torch.tensor(x, requires_grad=True)
    kt = torch.tensor(k, requires_grad=True)
    reset_launch_counts()
    gx, gk = torch.autograd.grad(conv3x3_same(xt, kt), [xt, kt],
                                 torch.tensor(dy))
    assert launch_counts() == {}
    np.testing.assert_allclose(gx.numpy(), jx, atol=1e-5)
    np.testing.assert_allclose(gk.numpy(), jk, atol=1e-5)
    np.testing.assert_allclose(
        conv3x3_dgrad(torch.tensor(dy), torch.tensor(k)).numpy(), jx,
        atol=1e-5)
    np.testing.assert_allclose(
        conv3x3_wgrad(torch.tensor(x), torch.tensor(dy)).numpy(), jk,
        atol=1e-5)


def test_b1_backward_gradcheck_f64():
    x = torch.randn(2, 4, 5, 3, dtype=torch.float64, requires_grad=True)
    k = torch.randn(3, 3, 3, 4, dtype=torch.float64, requires_grad=True)
    assert torch.autograd.gradcheck(conv3x3_same, (x, k))
    # only what is asked for: a frozen weight takes no wgrad
    y = conv3x3_same(x, k.detach())
    (gx,) = torch.autograd.grad(y.sum(), [x])
    assert gx.shape == x.shape


def test_b1_wgrad_plain_matches_reference_and_bf16_rounds_once():
    """The plain wgrad is the sum over pixels of shifted products; in bf16
    it sums in f32 and rounds once (one bf16 ulp of the largest)."""
    x, _ = _conv_inputs(2, 5, 6, 4, 3, seed=8)
    dy = np.random.RandomState(9).randn(2, 5, 6, 3).astype(np.float32)
    xp = np.pad(x, ((0, 0), (1, 1), (1, 1), (0, 0)))
    want = np.stack([np.einsum("nhwc,nhwd->cd", xp[:, a:a + 5, b:b + 6], dy)
                     for a in range(3) for b in range(3)]).reshape(3, 3, 4, 3)
    got = reference_conv3x3_wgrad(torch.tensor(x), torch.tensor(dy))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    got16 = reference_conv3x3_wgrad(torch.tensor(x).bfloat16(),
                                    torch.tensor(dy).bfloat16())
    assert got16.dtype == torch.bfloat16
    xb = torch.tensor(x).bfloat16().float().numpy()
    db = torch.tensor(dy).bfloat16().float().numpy()
    xbp = np.pad(xb, ((0, 0), (1, 1), (1, 1), (0, 0)))
    want16 = np.stack([np.einsum("nhwc,nhwd->cd", xbp[:, a:a + 5, b:b + 6],
                                 db) for a in range(3) for b in range(3)])
    np.testing.assert_allclose(got16.float().numpy().reshape(9, 4, 3),
                               want16, atol=2.0 ** -7 * np.abs(want16).max())


@pytest.mark.parametrize("shape,dtype,aligned,plan", [
    # the flagship train step on 132 SMs: 64->64 and 128->128 on TMA, 64
    # pixels a step, four ring slots, clusters of two splits, about one
    # block per SM over the 64-channel tiles; the stem on split-K
    ((256, 32, 32, 64, 64), torch.bfloat16, True, ("tma", 132, 2, 4, 2)),
    ((256, 16, 16, 128, 128), torch.bfloat16, True, ("tma", 32, 4, 4, 2)),
    ((256, 32, 32, 3, 64), torch.bfloat16, True, ("split_k", 132, 128, 3, 1)),
    # f32 takes the f32 path (two blocks an SM over 32 x 32 channel tiles,
    # two ring slots), bf16 MNIST's Cin 65 split-K; never more ranges than
    # K steps
    ((256, 32, 32, 64, 64), torch.float32, True, ("f32", 66, 64, 2, 1)),
    ((1, 4, 4, 64, 64), torch.bfloat16, True, ("split_k", 1, 128, 3, 1)),
    ((1, 6, 6, 65, 64), torch.float32, True, ("f32", 1, 64, 2, 1)),
    ((1, 6, 6, 65, 64), torch.bfloat16, True, ("split_k", 1, 128, 3, 1)),
    # W = 7: taps would not start on swizzle atoms
    ((2, 7, 7, 64, 64), torch.bfloat16, True, ("split_k", 1, 128, 3, 1)),
    # a pointer off 16 bytes: TMA cannot address it
    ((4, 32, 32, 64, 64), torch.bfloat16, False, ("split_k", 32, 128, 3, 1)),
    # W 72: two rows are 9 k16 slices, more than the kernel's instances
    ((2, 7, 72, 64, 64), torch.bfloat16, True, ("split_k", 8, 128, 3, 1)),
    # W 128: one row fits one ring slot only
    ((1, 2, 128, 8, 8), torch.bfloat16, True, ("split_k", 2, 128, 3, 1)),
    # TMA at the card tests' shapes: W 24 takes 4 rows (96 pixels), W 8
    # 8 rows, W 64 one row and two slots; one step, one split, no cluster
    ((4, 32, 32, 64, 64), torch.bfloat16, True, ("tma", 64, 2, 4, 2)),
    ((2, 16, 16, 128, 128), torch.bfloat16, True, ("tma", 8, 4, 4, 2)),
    ((3, 8, 24, 64, 128), torch.bfloat16, True, ("tma", 6, 4, 3, 2)),
    ((2, 8, 8, 64, 64), torch.bfloat16, True, ("tma", 2, 8, 4, 2)),
    ((1, 64, 64, 64, 64), torch.bfloat16, True, ("tma", 64, 1, 2, 2)),
    ((1, 8, 8, 64, 64), torch.bfloat16, True, ("tma", 1, 8, 4, 1)),
])
def test_b1_wgrad_splits_plan(shape, dtype, aligned, plan):
    """wgrad_plan: the path, the K ranges, the step (image rows on TMA,
    pixels on split-K), the ring slots and the cluster, from shapes, dtype,
    132 SMs and the pointers' alignment only."""
    got = wgrad_plan(*shape, dtype, 132, aligned=aligned)
    assert tuple(got) == plan


def _replay_step(shape):
    """The plan's rows, splits and cluster where it takes TMA, else 2 rows
    (a tail step wherever H is odd) in up to 3 ranges, each its own
    cluster."""
    n, h, w, cin, cout = shape
    plan = wgrad_plan(n, h, w, cin, cout, torch.bfloat16, 132)
    if plan.path == "tma":
        return plan.rows, plan.splits, plan.cluster
    return 2, min(3, n * -(-h // 2)), 1


@pytest.mark.parametrize("shape", BWD_SHAPES + [(2, 8, 8, 64, 64),
                                                (2, 4, 16, 128, 64)])
def test_b1_wgrad_tma_replay_matches_reference_and_jax_vjp(shape):
    """The TMA path's decomposition, replayed in plain f32 torch, against
    reference_conv3x3_wgrad and jax.vjp of the JAX reference_conv3x3: atol
    1e-5 (f32 sums in another order)."""
    import jax

    x, k = _conv_inputs(*shape, seed=10)
    dy = (0.1 * np.random.RandomState(11).randn(*shape[:3], shape[4])
          ).astype(np.float32)
    rows, splits, cluster = _replay_step(shape)
    got = run_wgrad_plan(torch.tensor(x), torch.tensor(dy), rows, splits,
                         cluster)
    assert got.shape == (3, 3, shape[3], shape[4])
    ref = reference_conv3x3_wgrad(torch.tensor(x), torch.tensor(dy))
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=1e-5)
    _, vjp = jax.vjp(j_reference_conv3x3, jnp.asarray(x), jnp.asarray(k))
    _, jk = vjp(jnp.asarray(dy))
    np.testing.assert_allclose(got.numpy(), np.asarray(jk), atol=1e-5)


def test_b1_wgrad_tma_replay_pins_each_tap():
    """One-hot x: each tap's sum is one dy pixel (or zero where the source
    pixel lies outside the image), exactly, at the corners, an edge and
    inside, across a split boundary mid-image."""
    n, h, w, cin, cout = 2, 5, 8, 4, 3
    x = torch.zeros(n, h, w, cin)
    hot = [(0, 0, 0, 0), (0, 2, 3, 1), (1, 4, 7, 2), (1, 0, 5, 3)]
    for p in hot:
        x[p] = 1.0
    dy = torch.arange(n * h * w * cout, dtype=torch.float32).reshape(
        n, h, w, cout)
    got = run_wgrad_plan(x, dy, 2, 6, 2)
    want = torch.zeros(3, 3, cin, cout)
    for img, r, c, ci in hot:
        for kh in range(3):
            for kw in range(3):
                hh, ww = r - kh + 1, c - kw + 1
                if 0 <= hh < h and 0 <= ww < w:
                    want[kh, kw, ci] = dy[img, hh, ww]
    assert torch.equal(got, want)
