"""The member-batched kernels' plain versions and the members' layers, on
the CPU: B1's forward, dgrad and wgrad and B3's forward and backward with
a leading member axis against per-member plain calls (exactly), their
autograd, the plans with a member count and the C entry points' refusals
as the wrappers mirror them, and the members' paths of ``models/nn.py``
(grouped conv, ``bmm``, BN per member, SN/WN per member) against
per-member single-run calls.  The launches themselves (bit-equal to S
single launches) are held on the card: ``chip_smoke.py`` phase 23 and
``tests/test_torch_cuda.py -k member``."""
import numpy as np
import pytest
import torch

from neural_ode_metasolver_tpu_torch.models import nn as fnn
from neural_ode_metasolver_tpu_torch.ops import conv3x3 as c3
from neural_ode_metasolver_tpu_torch.ops import group_norm as gn
from tests.test_torch_runners import one_torch_thread  # noqa: F401

S, N = 3, 2


def _r(*shape, seed=0):
    return torch.from_numpy(
        np.random.RandomState(seed).randn(*shape).astype(np.float32))


@pytest.mark.parametrize("h,cin,cout", [(6, 65, 64), (5, 3, 8)])
def test_member_conv3x3_plain_versions_equal_per_member_calls(h, cin, cout):
    x, w = _r(S, N, h, h, cin), 0.1 * _r(S, 3, 3, cin, cout, seed=1)
    dy = _r(S, N, h, h, cout, seed=2)
    y, dx, dw = (c3.conv3x3_same(x, w), c3.conv3x3_dgrad(dy, w),
                 c3.conv3x3_wgrad(x, dy))
    assert dw.shape == (S, 3, 3, cin, cout)
    for m in range(S):
        assert torch.equal(y[m], c3.conv3x3_same(x[m], w[m]))
        assert torch.equal(dx[m], c3.conv3x3_dgrad(dy[m], w[m]))
        assert torch.equal(dw[m], c3.conv3x3_wgrad(x[m], dy[m]))
    assert torch.equal(c3.flip_weights(w)[1], c3.flip_weights(w[1]))


def test_member_conv3x3_autograd_gives_each_member_its_gradient():
    x = _r(S, N, 4, 4, 5).requires_grad_()
    w = (0.1 * _r(S, 3, 3, 5, 6, seed=1)).requires_grad_()
    g = _r(S, N, 4, 4, 6, seed=2)
    gx, gw = torch.autograd.grad((c3.conv3x3_same(x, w) * g).sum(), [x, w])
    for m in range(S):
        xm = x[m].detach().requires_grad_()
        wm = w[m].detach().requires_grad_()
        sx, sw = torch.autograd.grad((c3.conv3x3_same(xm, wm) * g[m]).sum(),
                                     [xm, wm])
        torch.testing.assert_close(gx[m], sx, rtol=0, atol=0)
        torch.testing.assert_close(gw[m], sw, rtol=0, atol=0)


@pytest.mark.parametrize("act", ["relu", None])
@pytest.mark.parametrize("h", [6, 13])
def test_member_group_norm_plain_versions_equal_per_member_calls(act, h):
    x, do = _r(S, N, h, h, 64), _r(S, N, h, h, 64, seed=3)
    sc, b = 1 + 0.1 * _r(S, 64, seed=4), 0.1 * _r(S, 64, seed=5)
    y = gn.fused_group_norm_act(x, sc, b, 32, act=act)
    dx, dsc, db = gn.group_norm_backward(x, sc, b, do, 32, act=act)
    dx_only = gn.group_norm_backward(x, sc, b, do, 32, act=act,
                                     params=False)
    assert dsc.shape == (S, 64) and dx_only[1] is None
    assert torch.equal(dx_only[0], dx)
    for m in range(S):
        assert torch.equal(y[m], gn.fused_group_norm_act(x[m], sc[m], b[m],
                                                         32, act=act))
        want = gn.group_norm_backward(x[m], sc[m], b[m], do[m], 32, act=act)
        for got, ref in zip((dx[m], dsc[m], db[m]), want):
            assert torch.equal(got, ref)


def test_member_group_norm_autograd_gives_member_rows():
    x = _r(S, N, 6, 6, 64).requires_grad_()
    sc = (1 + 0.1 * _r(S, 64, seed=1)).requires_grad_()
    b = (0.1 * _r(S, 64, seed=2)).requires_grad_()
    g = _r(S, N, 6, 6, 64, seed=3)
    grads = torch.autograd.grad(
        (gn.fused_group_norm_act(x, sc, b, 32, act="relu") * g).sum(),
        [x, sc, b])
    assert grads[1].shape == (S, 64)
    for m in range(S):
        want = gn.group_norm_backward(x[m].detach(), sc[m].detach(),
                                      b[m].detach(), g[m], 32, act="relu")
        for got, ref in zip(grads, want):
            torch.testing.assert_close(got[m], ref, rtol=0, atol=0)


def test_plans_do_not_depend_on_the_member_count():
    """Each member runs a single run's plan (its sums keep their order);
    the f32 (and the bf16 split-K) wgrad's members x splits must fit grid
    dimension z: the launch refuses more, as the C entry point does."""
    one = c3.wgrad_plan(128, 6, 6, 65, 64, torch.float32, 132)
    assert one.path == "f32"
    too_many = c3.MAX_GRID_Z // one.splits + 1
    x = torch.zeros(too_many, 1, 1, 1, 1)
    with pytest.raises(ValueError, match="grid dimension z"):
        c3._launch_wgrad(x, x, one)
    # the TMA path launches once a member: no grid limit from members
    tma = c3.wgrad_plan(256, 32, 32, 64, 64, torch.bfloat16, 132)
    assert tma.path == "tma"
    for shape in ((26, 26), (13, 13), (6, 6)):
        assert gn.launch_plan(128, *shape, 64, 32, torch.float32) == \
            gn.launch_plan(16 * 128, *shape, 64, 32, torch.float32)


def test_member_shape_refusals():
    """What the C entry points refuse, the wrappers refuse first."""
    x, w = _r(S, N, 4, 4, 5), _r(S, 3, 3, 5, 6)
    with pytest.raises(ValueError, match="not"):
        c3.conv3x3_same(x, w[:2])  # member counts differ
    with pytest.raises(ValueError, match="not"):
        c3.conv3x3_same(x[0], w)  # stacked weights, one run's images
    with pytest.raises(ValueError, match="not"):
        c3.conv3x3_dgrad(_r(S, N, 4, 4, 6), w[:2])
    with pytest.raises(ValueError, match="not"):
        c3.conv3x3_wgrad(x, _r(N, 4, 4, 6))
    xg = _r(S, N, 4, 4, 8)
    with pytest.raises(ValueError, match="are not"):
        gn.fused_group_norm_act(xg, torch.ones(8), torch.zeros(8), 4)
    with pytest.raises(ValueError, match="are not"):
        gn.fused_group_norm_act(xg, torch.ones(2, 8), torch.zeros(2, 8), 4)


def test_member_layers_match_per_member_calls():
    """Grouped conv (stride 1 and 2, bias), bmm and BN (train and eval,
    new running statistics) per member, against the single-run layers."""
    x = _r(S, N, 9, 9, 4)
    for stride, pad, k in ((1, 0, 3), (2, 1, 4)):
        p = {"kernel": 0.2 * _r(S, k, k, 4, 6, seed=1),
             "bias": _r(S, 6, seed=2)}
        y = fnn.conv2d(p, x, stride=stride, padding=pad)
        for m in range(S):
            torch.testing.assert_close(
                y[m], fnn.conv2d({"kernel": p["kernel"][m],
                                  "bias": p["bias"][m]}, x[m],
                                 stride=stride, padding=pad),
                rtol=1e-5, atol=1e-5)
    lin = {"kernel": _r(S, 4, 10, seed=3), "bias": _r(S, 10, seed=4)}
    f = fnn.global_avg_pool(x)
    out = fnn.linear(lin, f)
    bnp = {"scale": 1 + _r(S, 4, seed=5), "bias": _r(S, 4, seed=6)}
    bns = {"mean": _r(S, 4, seed=7), "var": 1 + _r(S, 4, seed=8).abs()}
    for train in (True, False):
        yb, st = fnn.batch_norm(bnp, bns, x, train)
        for m in range(S):
            ym, stm = fnn.batch_norm({k: v[m] for k, v in bnp.items()},
                                     {k: v[m] for k, v in bns.items()},
                                     x[m], train)
            torch.testing.assert_close(yb[m], ym, rtol=1e-5, atol=1e-5)
            for k in st:
                torch.testing.assert_close(st[k][m], stm[k], rtol=1e-6,
                                           atol=1e-6)
    for m in range(S):
        torch.testing.assert_close(
            out[m], fnn.linear({k: v[m] for k, v in lin.items()}, f[m]),
            rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("kind", ["SN", "WN"])
@pytest.mark.parametrize("train", [True, False])
def test_member_param_norms_match_per_member_calls(kind, train):
    pnd = fnn.make_param_norm_def(kind)
    members = [pnd.wrap_init(torch.Generator().manual_seed(m),
                             fnn.conv2d_init(torch.Generator().manual_seed(
                                 10 + m), 4, 6, 3, use_bias=False))
               for m in range(S)]
    stack = lambda trees: None if trees[0] is None else {  # noqa: E731
        k: torch.stack([t[k] for t in trees]) for k in trees[0]}
    p_eff, st = pnd.materialize(stack([m[0] for m in members]),
                                stack([m[1] for m in members]), train)
    for m, (pm, sm) in enumerate(members):
        want, want_st = pnd.materialize(pm, sm, train)
        torch.testing.assert_close(p_eff["kernel"][m], want["kernel"],
                                   rtol=1e-5, atol=1e-6)
        if want_st is not None:
            torch.testing.assert_close(st["sn_u"][m], want_st["sn_u"],
                                       rtol=1e-5, atol=1e-6)
