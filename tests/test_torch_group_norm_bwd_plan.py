"""B3's backward plan (``launch_plan(..., backward=True)``) at every
GroupNorm shape of the nets the port runs, and its gradient at the wide
CIFAR shapes, on the CPU.

The shapes come from a forward of each net at full width (batch 1, one RK
step, GN in every slot for the CIFAR nets, 32 groups), recorded where
``nn.group_norm`` calls ``fused_group_norm_act``.  At each one, in f32 and
bf16: the plan is the staged path (x and dout copied into shared memory),
its threads touch every element once and every vector slot of the
block's stash once, and it stays within ``SMEM_OPTIN`` and a portable
cluster.  The occupancy rule the design relies on: a staged block's
shared memory leaves two blocks an SM, its threads and its registers
(``__launch_bounds__(256, 2)``: at most 128 a thread) too, and dout's copy
fills the stash's last plane exactly.  The gradient of
``fused_group_norm_act`` at (2, 8, 8, 256) and (2, 4, 4, 512) with the
exact GELU matches ``jax.vjp`` of the Pallas kernel in interpret mode at
the 5e-4 of ``test_torch_group_norm.py``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neural_ode_metasolver_tpu.ops.pallas_kernels import (
    fused_group_norm_act as j_fused_group_norm_act,
)
from neural_ode_metasolver_tpu_torch.models import build_model
from neural_ode_metasolver_tpu_torch.models import nn as fnn
from neural_ode_metasolver_tpu_torch.ops import parse_solver_dsl
from neural_ode_metasolver_tpu_torch.ops.group_norm import (
    BLOCK_RESERVED,
    MAX_CLUSTER,
    MAX_THREADS,
    SM_SMEM,
    SMEM_OPTIN,
    TWO_A_SM,
    _layout,
    fused_group_norm_act,
    launch_plan,
)
from test_torch_group_norm import _covered, _inputs
from test_torch_runners import one_torch_thread  # noqa: F401 (autouse)

GN = dict(norms=("GN",) * 3, num_gn_groups=32)
NETS = {"mnist": {}, "metanode10": GN, "metanode18": GN, "metanode34": GN,
        "premetanode10": GN}
# the train step's batch of each net (chip_smoke.py's phases 11 and 18)
BATCH = {"mnist": 128}
DTYPES = [torch.float32, torch.bfloat16]
REGS_A_THREAD = 128  # __launch_bounds__(256, 2) of the staged instances
SM_THREADS, SM_REGS = 2048, 65536  # an H100 SM's


@pytest.fixture(scope="module")
def net_shapes():
    """name -> sorted {(h, w, c, groups)} of every GroupNorm of one
    forward."""
    out = {}
    real = fnn.fused_group_norm_act
    for name, cfg in NETS.items():
        seen = set()

        def record(x, scale, bias, groups, *rest, _seen=seen):
            _seen.add((*x.shape[1:], groups))
            return real(x, scale, bias, groups, *rest)

        model = build_model(name, device="cpu", **cfg)
        x = torch.rand((1, 28, 28, 1) if name == "mnist" else (1, 32, 32, 3),
                       generator=torch.Generator().manual_seed(0))
        fnn.fused_group_norm_act = record
        try:
            with torch.no_grad():
                model(x, parse_solver_dsl("rk2,u,1,-1,0.5,-1"))
        finally:
            fnn.fused_group_norm_act = real
        out[name] = sorted(seen)
    return out


def test_the_nets_reach_the_wide_shapes(net_shapes):
    wide = {(8, 8, 256, 32), (4, 4, 512, 32)}
    assert wide <= set(net_shapes["metanode18"])
    assert wide <= set(net_shapes["metanode34"])
    assert set(net_shapes["metanode10"]) == {(32, 32, 64, 32),
                                             (16, 16, 128, 32)}
    assert {s[:3] for s in net_shapes["mnist"]} == {
        (26, 26, 64), (13, 13, 64), (6, 6, 64)}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", list(NETS))
def test_bwd_plan_covers_every_element_once(net_shapes, name, dtype):
    n = BATCH.get(name, 256)
    for h, w, c, groups in net_shapes[name]:
        plan = launch_plan(n, h, w, c, groups, dtype, backward=True)
        assert plan.path == "staged" and plan.stash and plan.regs == 0
        assert plan.smem_bytes <= SMEM_OPTIN
        assert 1 <= plan.cluster <= MAX_CLUSTER
        assert 32 * plan.warps <= MAX_THREADS
        # one sample: every block of its cluster, every thread's vectors
        assert (_covered(plan, 1, h * w, c) == 1).all()
        # each block's threads write and read back the stash's slots
        # (element offset in the slice over vec) 0 .. npx * C / vec, once
        threads = 32 * plan.warps
        vpp, cols, rows, ncols = _layout(c, plan.vec, threads)
        per = -(-h * w // plan.cluster)
        for rank in range(plan.cluster):
            p0 = min(h * w, rank * per)
            npx = min(h * w, p0 + per) - p0
            slots = [p * vpp + cv
                     for t in range(threads) if t // cols < rows
                     for cv in range(t % cols, vpp, cols)
                     for p in range(t // cols, npx, rows)]
            assert sorted(slots) == list(range(npx * vpp))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", list(NETS))
def test_bwd_plan_leaves_two_blocks_an_sm(net_shapes, name, dtype):
    n = BATCH.get(name, 256)
    size = dtype.itemsize
    for h, w, c, groups in net_shapes[name]:
        plan = launch_plan(n, h, w, c, groups, dtype, backward=True)
        threads = 32 * plan.warps
        assert plan.smem_bytes <= TWO_A_SM
        assert 2 * (plan.smem_bytes + BLOCK_RESERVED) <= SM_SMEM
        assert 2 * threads <= SM_THREADS
        assert 2 * threads * REGS_A_THREAD <= SM_REGS
        # a block's slice of x and dout in `size` bytes an element, dxhat in
        # f32: dout's copy is one 16-byte plane of the stash per vector
        per = -(-h * w // plan.cluster)
        assert per * c * size == per * (c // plan.vec) * 16
        assert plan.smem_bytes > per * c * (size + 4)


@pytest.mark.parametrize("shape", [(2, 8, 8, 256), (2, 4, 4, 512)])
def test_wide_gradient_matches_pallas_vjp(shape):
    """dx, dscale and dbias through fused_group_norm_act (32 groups, exact
    GELU) on CPU tensors against jax.vjp of the Pallas kernel in interpret
    mode: atol/rtol 5e-4."""
    x, scale, bias = _inputs(shape, seed=11)
    g = np.random.RandomState(12).randn(*shape).astype(np.float32)
    _, vjp = jax.vjp(lambda a, s, b: j_fused_group_norm_act(
        a, s, b, 32, 1e-5, "gelu", True), *(jnp.asarray(v) for v in (
            x, scale, bias)))
    want = vjp(jnp.asarray(g))
    ts = [torch.tensor(v, requires_grad=True) for v in (x, scale, bias)]
    got = torch.autograd.grad(fused_group_norm_act(*ts, 32, 1e-5, "gelu"),
                              ts, torch.tensor(g))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b, np.float32),
                                   atol=5e-4, rtol=5e-4)
