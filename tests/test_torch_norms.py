"""The port's norm layers, param norms and init schemes against the JAX
package's (``models/nn.py``), on the CPU.

Norms: every ``NormDef`` kind in train and eval mode, with the activation
after it (fused into B3's plain version where B3 computes it), y and BN's
new running state within 2e-5 (the bar of ``tests/test_models.py``).
Param norms: SN and WN ``materialize`` of a conv and a linear kernel in
both modes, with JAX's ``sn_u`` and ``wn_g`` carried across, within 3e-5.
Inits: their draws cannot match JAX's, so their properties are held: the
orthogonal kernels' orthonormal rows on the (O, I*H*W) matrix, the xavier
bound with zero bias, the orthogonal linear's bias 1e-3, and the same
leaves re-initialized as JAX's walk."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neural_ode_metasolver_tpu.models import MODEL_REGISTRY as J_REGISTRY
from neural_ode_metasolver_tpu.models import init_cifar as j_init_cifar
from neural_ode_metasolver_tpu.models import nn as jnn
from neural_ode_metasolver_tpu_torch.models import nn as pnn
from neural_ode_metasolver_tpu_torch.models import (
    build_model,
    cifar_params_from_jax,
)
from test_torch_runners import one_torch_thread  # noqa: F401 (autouse)


def _x(shape, seed=0):
    rs = np.random.RandomState(seed)
    return (rs.randn(*shape) * 2.0 + 0.5).astype(np.float32)


def _j(tree):
    return jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float32),
                                  tree)


def _t(tree):
    return jax.tree_util.tree_map(lambda a: torch.tensor(np.asarray(a)),
                                  tree)


NORM_CASES = [(kind, train, act)
              for kind in ("BN", "GN", "LN", "IN", "NF")
              for train in (True, False)
              for act in (None, "GeLU")]


@pytest.mark.parametrize("kind,train,act", NORM_CASES,
                         ids=[f"{k}-{'train' if t else 'eval'}-{a}"
                              for k, t, a in NORM_CASES])
def test_norm_def_matches_jax(kind, train, act):
    c = 16
    x = _x((3, 5, 5, c))
    jd = jnn.make_norm_def(kind, num_groups=4)
    jp, js = jd.init(c)
    rs = np.random.RandomState(1)
    if jp is not None:
        jp = {"scale": rs.rand(c).astype(np.float32) + 0.5,
              "bias": rs.randn(c).astype(np.float32)}
    if js is not None:
        js = {"mean": rs.randn(c).astype(np.float32),
              "var": rs.rand(c).astype(np.float32) + 0.5}
    jy, jns = jd.apply(None if jp is None else _j(jp),
                       None if js is None else _j(js), jnp.asarray(x), train)
    if act is not None:
        jy = jnn.get_activation(act)(jy)
    pd = pnn.make_norm_def(kind, num_groups=4)
    pp, ps = pd.init(c)
    assert (pp is None) == (jp is None) and (ps is None) == (js is None)
    st = None if js is None else _t(js)
    py, pns = pd.apply(None if jp is None else _t(jp), st, torch.tensor(x),
                       train, act)
    np.testing.assert_allclose(py.numpy(), np.asarray(jy), atol=2e-5)
    if js is None:
        assert pns is None and jns is None
        return
    for k in ("mean", "var"):
        np.testing.assert_allclose(pns[k].numpy(), np.asarray(jns[k]),
                                   atol=2e-5)
    if not train:  # eval mode hands the state back untouched
        assert pns is st


@pytest.mark.parametrize("act", ["ReLU", "Tanh", "Softsign", "GeLUpoly",
                                 "GeLUtanh", "AF"])
def test_group_norm_fuses_or_follows_each_activation(act):
    """GN then each registry activation: fused into B3 where it has the
    activation, applied after it otherwise; the same function as JAX's."""
    x = _x((2, 4, 4, 8), seed=2)
    jy, _ = jnn.make_norm_def("GN", 2).apply(
        _j({"scale": np.full(8, 1.5, np.float32),
            "bias": np.full(8, 0.1, np.float32)}), None, jnp.asarray(x),
        False)
    jy = jnn.get_activation(act)(jy)
    py, _ = pnn.make_norm_def("GN", 2).apply(
        {"scale": torch.full((8,), 1.5), "bias": torch.full((8,), 0.1)},
        None, torch.tensor(x), False, act)
    np.testing.assert_allclose(py.numpy(), np.asarray(jy), atol=2e-5)


def test_norm_def_groups_names_and_state_untouched():
    # GN clamps its groups to C and refuses channels its groups do not
    # divide, as torch's GroupNorm (and JAX's NormDef) do
    pd = pnn.make_norm_def("GN", num_groups=32)
    p, _ = pd.init(8)
    x = torch.tensor(_x((2, 3, 3, 8)))
    y, _ = pd.apply(p, None, x, True)
    jy, _ = jnn.make_norm_def("GN", 32).apply(_j(jax.tree_util.tree_map(
        np.asarray, {k: v.numpy() for k, v in p.items()})), None,
        jnp.asarray(x.numpy()), True)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=2e-5)
    with pytest.raises(ValueError, match="divisible"):
        pnn.make_norm_def("GN", num_groups=32).init(48)
    with pytest.raises(NameError):
        pnn.make_norm_def("XN")
    with pytest.raises(NameError):
        pnn.make_param_norm_def("XN")
    with pytest.raises(NameError):
        pnn.apply_init_scheme(torch.Generator(), {}, "kaiming")
    # train mode returns new running statistics and leaves the old ones
    bp, bs = pnn.make_norm_def("BN").init(8)
    before = {k: v.clone() for k, v in bs.items()}
    _, new = pnn.make_norm_def("BN").apply(bp, bs, x, True)
    assert all(torch.equal(bs[k], before[k]) for k in bs)
    assert not torch.equal(new["mean"], bs["mean"])
    assert not new["mean"].requires_grad


PN_CASES = [(kind, train, kernel)
            for kind in ("SN", "WN")
            for train in (True, False)
            for kernel in ("conv", "linear")]


@pytest.mark.parametrize("kind,train,kernel", PN_CASES,
                         ids=[f"{k}-{'train' if t else 'eval'}-{w}"
                              for k, t, w in PN_CASES])
def test_param_norm_materialize_matches_jax(kind, train, kernel):
    shape = (3, 3, 6, 10) if kernel == "conv" else (12, 7)
    w = np.random.RandomState(3).randn(*shape).astype(np.float32) * 0.3
    jd = jnn.make_param_norm_def(kind)
    jp, js = jd.wrap_init(jax.random.key(0), {"kernel": jnp.asarray(w)})
    if kind == "WN":  # g away from the init's norms, so the scale shows
        jp = dict(jp, wn_g=jp["wn_g"] * 1.7)
    je, jns = jd.materialize(jp, js, train)
    pd = pnn.make_param_norm_def(kind)
    pp, ps = pd.wrap_init(torch.Generator().manual_seed(0),
                          {"kernel": torch.tensor(w)})
    assert set(pp) == set(jp) and (ps is None) == (js is None)
    if kind == "WN":
        np.testing.assert_allclose(pp["wn_g"].numpy(),
                                   np.asarray(jp["wn_g"]) / 1.7, rtol=1e-6)
    pe, pns = pd.materialize(_t(jp), None if js is None else _t(js), train)
    assert set(pe) == {"kernel"}
    np.testing.assert_allclose(pe["kernel"].numpy(), np.asarray(je["kernel"]),
                               atol=3e-5)
    if kind == "SN":
        np.testing.assert_allclose(pns["sn_u"].numpy(),
                                   np.asarray(jns["sn_u"]), atol=3e-5)
        u0 = ps["sn_u"]
        assert abs(float(torch.linalg.vector_norm(u0)) - 1.0) < 1e-6
        moved = not np.allclose(np.asarray(jns["sn_u"]),
                                np.asarray(js["sn_u"]))
        assert moved == train  # eval mode iterates nothing


def test_param_norm_gradient_matches_jax():
    """SN's train-mode gradient flows through sigma but not through u and
    v, as JAX's stop_gradient has it."""
    w = np.random.RandomState(4).randn(3, 3, 4, 5).astype(np.float32)
    jd = jnn.make_param_norm_def("SN")
    jp, js = jd.wrap_init(jax.random.key(1), {"kernel": jnp.asarray(w)})
    jg = jax.grad(lambda k: jnp.sum(jnp.sin(jd.materialize(
        {"kernel": k}, js, True)[0]["kernel"])))(jnp.asarray(w))
    k = torch.tensor(w, requires_grad=True)
    pe, _ = pnn.make_param_norm_def("SN").materialize({"kernel": k},
                                                      _t(js), True)
    (pg,) = torch.autograd.grad(torch.sin(pe["kernel"]).sum(), k)
    np.testing.assert_allclose(pg.numpy(), np.asarray(jg), atol=3e-5)


def _rows_orthonormal(mat):
    m = mat if mat.shape[0] <= mat.shape[1] else mat.T
    np.testing.assert_allclose(m @ m.T, np.eye(m.shape[0]), atol=1e-5)


def test_orthogonal_and_xavier_inits():
    gen = torch.Generator().manual_seed(5)
    conv = pnn.conv2d_init(gen, 6, 10, 3, use_bias=True)
    ortho = pnn.orthogonal_conv_init(gen, conv)
    _rows_orthonormal(pnn._kernel_as_matrix(ortho["kernel"]).numpy())
    assert torch.equal(ortho["bias"], conv["bias"])
    wide = pnn.orthogonal_conv_init(gen, pnn.conv2d_init(gen, 64, 3, 1))
    _rows_orthonormal(pnn._kernel_as_matrix(wide["kernel"]).numpy())
    xav = pnn.xavier_conv_init(gen, conv)
    bound = np.sqrt(2.0) * np.sqrt(6.0 / (6 * 9 + 10 * 9))
    assert float(xav["kernel"].abs().max()) <= bound
    assert float(xav["kernel"].abs().max()) > 0.8 * bound
    assert torch.equal(xav["bias"], torch.zeros(10))
    fc = pnn.orthogonal_fc_init(gen, pnn.linear_init(gen, 16, 10))
    _rows_orthonormal(fc["kernel"].T.numpy())
    assert torch.equal(fc["bias"], torch.full((10,), 1e-3))


@pytest.mark.parametrize("scheme", ["orthogonal", "xavier"])
def test_init_scheme_reinitializes_the_leaves_jax_does(scheme):
    """The same leaves change as under JAX's walk (every conv kernel, the
    linear only under orthogonal, xavier zeroes conv biases), and WN's
    wn_g keeps the first init's norms."""
    kw = dict(in_planes=8, norms=("BN", "GN", "NF"), num_gn_groups=4,
              param_norms=("WN", "SN", "PNF"))
    jp, _ = j_init_cifar(jax.random.key(0), J_REGISTRY["metanode10"](**kw))
    jp2 = jnn.apply_init_scheme(jax.random.key(1), jp, scheme)
    jsd = cifar_params_from_jax(jax.tree_util.tree_map(np.asarray, jp))
    jsd2 = cifar_params_from_jax(jax.tree_util.tree_map(np.asarray, jp2))
    j_changed = {k for k in jsd if not torch.equal(jsd[k], jsd2[k])}
    base = build_model("metanode10", device="cpu", **kw)
    model = build_model("metanode10", device="cpu", init_scheme=scheme, **kw)
    psd, psd2 = base.state_dict(), model.state_dict()
    assert set(psd) >= set(jsd)
    p_changed = {k for k in jsd if not torch.equal(psd[k], psd2[k])}
    assert p_changed == j_changed and p_changed
    assert {k for k in p_changed if not k.endswith("kernel")} == (
        {"params.fc.bias"} if scheme == "orthogonal" else set())
    for k in psd:
        if k.endswith("wn_g"):
            assert torch.equal(psd[k], psd2[k])
            mat = pnn._kernel_as_matrix(psd[k.replace("wn_g", "kernel")])
            torch.testing.assert_close(psd[k], torch.linalg.vector_norm(
                mat, dim=1))
        if k.endswith("kernel") and psd2[k].dim() == 4 and \
                scheme == "orthogonal":
            _rows_orthonormal(pnn._kernel_as_matrix(psd2[k]).numpy())
