"""Kernel B3 (``ops/group_norm.py``) against the JAX package.

On CPU tensors ``fused_group_norm_act`` runs its plain version, which must
match the Pallas kernel run in interpret mode and the JAX two-pass
reference at the bars of ``tests/test_pallas.py`` (atol 2e-4 in f32, 3e-2
with bf16 I/O); ``nn.group_norm`` must match the JAX ``nn.group_norm``.
The CUDA kernel itself is checked against the plain version on the card
(``test_torch_cuda.py``).
"""
import numpy as np
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
    fused_group_norm_act,
    group_norm_reference,
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
