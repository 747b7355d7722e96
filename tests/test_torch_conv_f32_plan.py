"""B1's f32 core and the f32 wgrad on the CPU: their launch plans and the
decompositions the kernels run.

The plans (``conv3x3_f32_plan``, and ``wgrad_plan`` for f32) are pure
Python: pinned here at the flagship f32 shapes, at MNIST's 65 -> 64 and
64 -> 65 at batch 128 and 256, at odd widths, and for the u-sweep fleet's
members, which get a single run's plan (a member-batched launch is
bit-equal to single launches only so); and held to what the C entry points
take.  Plain-torch replays of each decomposition (the chunks of 32 and the
nine-tap step of the 65th channel, the K shares, the wgrad's ranges and
folded channel) are held to the JAX package at 1e-5: ``reference_conv3x3``
and the Pallas B1 in interpret mode for the forward and the dgrad,
``jax.vjp`` of the conv for the wgrad.  The kernels themselves are held to
the plain versions on the card (``tests/test_torch_cuda.py -k f32``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neural_ode_metasolver_tpu.ops.pallas_im2col import (
    conv3x3_im2col_gemm,
    reference_conv3x3 as j_reference_conv3x3,
)
from neural_ode_metasolver_tpu_torch import _build, backend
from neural_ode_metasolver_tpu_torch.ops import conv3x3 as c3
from tests.test_torch_runners import one_torch_thread  # noqa: F401

SMS = 132  # the H100's SMs
FLEET = 16  # the u-sweep fleet's members (runners/u_sweep.py)


def _inputs(n, h, w, cin, cout, seed=0):
    rs = np.random.RandomState(seed)
    x = rs.randn(n, h, w, cin).astype(np.float32)
    k = (rs.randn(3, 3, cin, cout) * 0.1).astype(np.float32)
    dy = (rs.randn(n, h, w, cout) * 0.1).astype(np.float32)
    return x, k, dy


@pytest.mark.parametrize("shape,plan", [
    # the flagship f32 shapes: 128 rows, two blocks an SM, four ring slots
    ((256, 32, 32, 64, 64), ("f32_halo", 128, 64, 1, 4)),
    ((256, 16, 16, 128, 128), ("f32_halo", 128, 64, 1, 4)),
    # MNIST's ConcatConv2d: 64 rows and K in two shares at batch 128 (and
    # each fleet member), 32 rows and four shares at 256, where they give
    # every SM two blocks
    ((128, 6, 6, 65, 64), ("f32_halo", 64, 64, 2, 4)),
    ((256, 6, 6, 65, 64), ("f32_halo", 32, 64, 4, 4)),
    # its dgrad, 64 -> 65: one tile of 72 columns (two blocks an SM)
    ((128, 6, 6, 64, 65), ("f32_halo", 64, 72, 2, 4)),
    ((256, 6, 6, 64, 65), ("f32_halo", 64, 72, 2, 4)),
    # odd widths: Cin 1, 3, 33, 129 (a nine-tap step), Cout 1, 3, 65
    ((128, 13, 13, 1, 64), ("f32_halo", 32, 64, 4, 4)),
    ((128, 13, 13, 3, 64), ("f32_halo", 32, 64, 4, 4)),
    ((128, 13, 13, 33, 64), ("f32_halo", 32, 64, 4, 4)),
    ((128, 13, 13, 129, 64), ("f32_halo", 32, 64, 4, 4)),
    ((128, 26, 26, 64, 1), ("f32_halo", 128, 64, 1, 4)),
    ((128, 26, 26, 64, 3), ("f32_halo", 128, 64, 1, 4)),
    ((128, 26, 26, 64, 65), ("f32_halo", 128, 72, 1, 4)),
    # W 720 > rows + 2: the three bands; two ring slots fit three blocks
    ((1, 2, 720, 64, 64), ("f32_bands", 64, 64, 2, 2)),
])
def test_f32_conv_plan_pins(shape, plan):
    """conv3x3_f32_plan from one run's shapes and 132 SMs."""
    assert tuple(c3.conv3x3_f32_plan(*shape, SMS)) == plan


@pytest.mark.parametrize("shape,plan", [
    ((256, 32, 32, 64, 64), ("f32", 66, 64, 2, 1)),
    # 16 tiles: 16 ranges fill one wave of two blocks an SM (17 would
    # leave 8 blocks to a second)
    ((256, 16, 16, 128, 128), ("f32", 16, 64, 2, 1)),
    # MNIST: Cin 65 is two blocks of 32 with the 65th folded, so 4 tiles
    # of 32 x 32; ranges of three 64-pixel steps
    ((128, 6, 6, 65, 64), ("f32", 24, 64, 2, 1)),
    ((256, 6, 6, 65, 64), ("f32", 48, 64, 2, 1)),
    ((128, 6, 6, 64, 65), ("f32", 24, 64, 2, 1)),
    ((128, 13, 13, 1, 64), ("f32", 113, 64, 2, 1)),
    ((128, 13, 13, 129, 64), ("f32", 33, 64, 2, 1)),
    ((128, 26, 26, 64, 1), ("f32", 132, 64, 2, 1)),
    ((2, 8, 8, 65, 64), ("f32", 1, 64, 2, 1)),
])
def test_f32_wgrad_plan_pins(shape, plan):
    """wgrad_plan in f32: K ranges of at most two blocks an SM over the
    tiles, at least three K steps a range, two ring slots."""
    assert tuple(c3.wgrad_plan(*shape, torch.float32, SMS)) == plan


@pytest.mark.parametrize("cin,cout,fold,tiles", [
    (65, 64, 1, 4), (33, 3, 1, 1), (129, 64, 1, 8), (36, 8, 4, 1),
    (64, 65, 0, 6), (40, 64, 0, 4), (3, 64, 0, 2), (1, 1, 0, 1)])
def test_f32_wgrad_folds_the_channels_past_the_last_32(cin, cout, fold,
                                                       tiles):
    """At most 4 channels past a whole 32 take no block of their own;
    more, or no whole 32, make a short block."""
    assert c3._wgrad_f32_fold(cin) == fold
    steps = 64  # K steps enough for two ranges a tile on `tiles` SMs
    plan = c3.wgrad_plan(1, 1, steps * c3.WGRAD_F32_BK, cin, cout,
                         torch.float32, tiles)
    assert plan.splits == 2  # two blocks an SM over `tiles` tiles


def _f32_smem_fits(shape, plan):
    """The shared memory the C entry point computes for the plan, against
    the opt-in size, and the blocks an SM the kernel instance is built
    for (csrc/conv3x3_f32.cuh::f32_blocks_per_sm)."""
    n, h, w, cin, cout = shape
    bps = 3 if plan.ksplit > 1 and plan.cols == 64 else 2
    smem = c3._f32_smem(w, cin, *plan[1:])
    return smem <= c3.SMEM_OPTIN and (plan.stages == 2 or smem <= (
        c3.SM_SMEM // bps - c3.BLOCK_RESERVED))


@pytest.mark.parametrize("n", [1, 2, 8, 128, 256])
@pytest.mark.parametrize("hw", [1, 6, 13, 26, 32, 150, 720])
@pytest.mark.parametrize("cin,cout", [(65, 64), (64, 65), (1, 64),
                                      (129, 3), (512, 512), (40, 72)])
def test_f32_plans_ask_only_what_the_kernels_take(n, hw, cin, cout):
    """Every plan keeps the C entry points' rules: 128 threads of 8 x 8
    sums (rows x ksplit = 128), 64 or 72 columns (72 only for Cout 65 to
    72), 2 to 4 ring slots in the shared memory the block may take, the
    bands exactly where W > rows + 2; the wgrad's K step of 64 pixels, no
    more ranges than steps, none of a cluster."""
    h = max(1, hw // 2) if hw > 32 else hw
    plan = c3.conv3x3_f32_plan(n, h, hw, cin, cout, SMS)
    assert plan.rows * plan.ksplit == c3.F32_THREADS
    assert plan.rows in c3.F32_ROWS
    assert plan.cols == (72 if 64 < cout <= 72 else 64)
    assert 2 <= plan.stages <= 4
    assert (plan.path == "f32_bands") == (hw > plan.rows + 2)
    assert _f32_smem_fits((n, h, hw, cin, cout), plan)
    wp = c3.wgrad_plan(n, h, hw, cin, cout, torch.float32, SMS)
    steps = -(-n * h * hw // c3.WGRAD_F32_BK)
    assert (wp.path, wp.rows, wp.stages, wp.cluster) == ("f32", 64, 2, 1)
    assert 1 <= wp.splits <= steps


def _fake_lib(calls):
    """A C library that records its launches' arguments."""
    class Lib:
        def conv3x3_same_launch(self, *args):
            calls.append(("conv", args))
            return 0

        def conv3x3_wgrad_launch(self, *args):
            calls.append(("wgrad", args))
            return 0
    return Lib()


def test_f32_plans_take_one_run_not_the_fleet(monkeypatch):
    """A fleet's member-batched launch hands the C entry points a single
    run's plan (its images, not the fleet's): B1 64 rows with K in two
    shares at 128 images, where 16 x 128 images would take 128 rows; the
    dgrad's 72 columns over weights padded to 68; the wgrad's 24 ranges a
    member, where 16 x 128 images would take 132."""
    calls = []
    monkeypatch.setattr(_build, "load", lambda name: _fake_lib(calls))
    monkeypatch.setattr(_build, "check_cuda_tensors", lambda *a, **k: None)
    monkeypatch.setattr(_build, "stream_handle", lambda t: 0)
    monkeypatch.setattr(c3, "_sms", lambda device: SMS)
    meta = dict(device="meta", dtype=torch.float32)
    x = torch.empty(FLEET, 128, 6, 6, 65, **meta)
    w = torch.empty(FLEET, 3, 3, 65, 64, **meta)
    dy = torch.empty(FLEET, 128, 6, 6, 64, **meta)
    backend.reset_launch_counts()
    c3.conv3x3_same(x, w)
    # dgrad on meta tensors: the wrapper pads only CUDA weights, so pass
    # the padded flip the CUDA path builds
    wf = torch.nn.functional.pad(w.flip(-4, -3).transpose(-2, -1),
                                 (0, 3)).contiguous()
    c3._launch_conv(dy, wf, c3.DGRAD_NAME, cout=65)
    c3.conv3x3_wgrad(x, dy)
    assert backend.launch_counts() == {"conv3x3_same": 1, "conv3x3_dgrad": 1,
                                       "conv3x3_wgrad": 1}
    (_, fwd), (_, bwd), (_, wg) = calls
    single = c3.conv3x3_f32_plan(128, 6, 6, 65, 64, SMS)
    fleet = c3.conv3x3_f32_plan(FLEET * 128, 6, 6, 65, 64, SMS)
    assert single != fleet
    code = c3.CONV_PATHS.index(single.path)
    # dtype, x, w, out, S, N, H, W, Cin, Cout, ldw, plan..., device, stream
    assert fwd[4:11] == (FLEET, 128, 6, 6, 65, 64, 64)
    assert fwd[11:16] == (code, *single[1:])
    dplan = c3.conv3x3_f32_plan(128, 6, 6, 64, 65, SMS)
    assert bwd[4:11] == (FLEET, 128, 6, 6, 64, 65, 68)
    assert bwd[11:16] == (c3.CONV_PATHS.index(dplan.path), *dplan[1:])
    wplan = c3.wgrad_plan(128, 6, 6, 65, 64, torch.float32, SMS)
    assert wplan.splits != c3.wgrad_plan(FLEET * 128, 6, 6, 65, 64,
                                         torch.float32, SMS).splits
    # ..., S, N, H, W, Cin, Cout, path, splits, rows, stages, cluster, ...
    assert wg[5:11] == (FLEET, 128, 6, 6, 65, 64)
    assert wg[11:16] == (c3.WGRAD_PATHS.index("f32"), *wplan[1:])


def test_f32_wgrad_refuses_more_members_than_grid_z():
    """The f32 wgrad's members x ranges share grid dimension z (65,535):
    the launch refuses more, as the C entry point does."""
    plan = c3.wgrad_plan(128, 6, 6, 65, 64, torch.float32, SMS)
    x = torch.zeros(c3.MAX_GRID_Z // plan.splits + 1, 1, 1, 1, 1)
    with pytest.raises(ValueError, match="grid dimension z"):
        c3._launch_wgrad(x, x, plan)


def _ksplit_plans(n, h, w, cin, cout):
    """The picked plan and the same tile at each K-share count."""
    picked = c3.conv3x3_f32_plan(n, h, w, cin, cout, SMS)
    return [picked] + [picked._replace(rows=r, ksplit=c3.F32_THREADS // r)
                       for r in c3.F32_ROWS if r != picked.rows]


REPLAY_SHAPES = [(2, 6, 6, 65, 64), (2, 6, 6, 64, 65), (2, 5, 7, 1, 8),
                 (1, 6, 6, 3, 64), (2, 4, 4, 33, 3), (1, 3, 5, 129, 1),
                 (2, 4, 6, 40, 65), (1, 3, 9, 36, 8)]


@pytest.mark.parametrize("shape", REPLAY_SHAPES)
def test_f32_core_replay_matches_jax(shape):
    """The f32 core's decomposition, replayed in plain f32 torch under the
    picked plan and every K-share count, against JAX's reference_conv3x3
    (f32) at 1e-5; the dgrad's (B1 on flipped weights) against jax.vjp of
    it in x."""
    x, k, dy = _inputs(*shape)
    n, h, w, cin, cout = shape
    ref = np.asarray(j_reference_conv3x3(jnp.asarray(x, jnp.float32),
                                         jnp.asarray(k, jnp.float32)))
    _, vjp = jax.vjp(j_reference_conv3x3, jnp.asarray(x, jnp.float32),
                     jnp.asarray(k, jnp.float32))
    jdx, _ = vjp(jnp.asarray(dy, jnp.float32))
    xt, kt, dyt = (torch.from_numpy(a) for a in (x, k, dy))
    for plan in _ksplit_plans(*shape):
        got = c3.run_conv3x3_f32_plan(xt, kt, plan)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), ref, atol=1e-5)
    for plan in _ksplit_plans(n, h, w, cout, cin):
        got = c3.run_conv3x3_f32_plan(dyt, c3.flip_weights(kt), plan)
        np.testing.assert_allclose(got.numpy(), np.asarray(jdx), atol=1e-5)


def test_f32_core_replay_matches_pallas_b1():
    """MNIST's 65 -> 64 (two chunks and the nine-tap step of the 65th
    channel, K in two shares) against the Pallas B1 in interpret mode."""
    x, k, _ = _inputs(2, 6, 6, 65, 64, seed=3)
    plan = c3.conv3x3_f32_plan(128, 6, 6, 65, 64, SMS)
    assert (plan.rows, plan.ksplit) == (64, 2)
    pallas = np.asarray(conv3x3_im2col_gemm(
        jnp.asarray(x, jnp.float32), jnp.asarray(k, jnp.float32), m_tile=8,
        interpret=True))
    got = c3.run_conv3x3_f32_plan(torch.from_numpy(x), torch.from_numpy(k),
                                  plan)
    np.testing.assert_allclose(got.numpy(), pallas, atol=1e-5)


@pytest.mark.parametrize("shape", REPLAY_SHAPES + [(3, 6, 6, 65, 64)])
@pytest.mark.parametrize("splits", [1, 2, 3])
def test_f32_wgrad_replay_matches_jax_vjp(shape, splits):
    """The f32 wgrad's decomposition (64-pixel steps in ordered ranges, each
    block's 32 Cin channels and the folded ones under each tap, zero where
    a source pixel lies outside its image), replayed in plain f32 torch,
    against jax.vjp of the JAX reference_conv3x3 in w at 1e-5.  At 3 x 6 x
    6 pixels the ranges cut a 64-pixel step off mid-image."""
    x, k, dy = _inputs(*shape, seed=5)
    steps = -(-shape[0] * shape[1] * shape[2] // c3.WGRAD_F32_BK)
    splits = min(splits, steps)
    _, vjp = jax.vjp(j_reference_conv3x3, jnp.asarray(x, jnp.float32),
                     jnp.asarray(k, jnp.float32))
    _, jdw = vjp(jnp.asarray(dy, jnp.float32))
    got = c3.run_wgrad_f32_plan(torch.from_numpy(x), torch.from_numpy(dy),
                                splits)
    assert got.shape == (3, 3, shape[3], shape[4])
    np.testing.assert_allclose(got.numpy(), np.asarray(jdw), atol=1e-5)
