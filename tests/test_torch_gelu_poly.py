"""GeLUpoly's plain versions and its dispatch (``ops/gelu_poly.py``,
``models/nn.py::gelu_poly``), on the CPU.

``gelu_poly_backward_reference``, the analytic derivative the card tests
hold the backward kernel to, must match autograd of the composition in f64
and f32, on a grid through 0, tiny values, the clamp's edges at exactly
+-8 and beyond them.  The ``autograd.Function``s run here with the plain
versions in the kernels' places: they save x alone, give dx in x's dtype
and return no gradient that autograd does not ask for; the one made for
torch.func keeps working under ``torch.func.vmap``.  A CPU tensor, and
``get_activation("GeLUpoly", False)``, take the composition and count no
launch.  The kernels themselves are checked on the card
(``test_torch_cuda.py``).
"""
from types import SimpleNamespace

import pytest
import torch

from neural_ode_metasolver_tpu_torch import launch_counts, reset_launch_counts
from neural_ode_metasolver_tpu_torch.models import nn as fnn
import neural_ode_metasolver_tpu_torch.ops.gelu_poly as gp

torch.set_num_threads(1)


def _grid(dtype):
    """0, tiny values, the clamp's edges and beyond, and a dense sweep."""
    edges = [0.0, 1e-30, -1e-30, 1e-7, -1e-7, 1e-3, -1e-3, 8.0, -8.0,
             7.999, -7.999, 8.001, -8.001, 9.0, -9.0, 20.0, -20.0, 1e4, -1e4]
    sweep = torch.linspace(-12.0, 12.0, 4801, dtype=torch.float64)
    return torch.cat([torch.tensor(edges, dtype=torch.float64), sweep]).to(
        dtype)


def _autograd_dx(x, g):
    x = x.detach().clone().requires_grad_(True)
    gp.gelu_poly_reference(x).backward(g)
    return x.grad


@pytest.mark.parametrize("dtype,atol", [(torch.float64, 1e-13),
                                        (torch.float32, 2e-6)])
def test_backward_reference_matches_autograd_of_the_composition(dtype, atol):
    x = _grid(dtype)
    g = torch.cos(torch.arange(x.numel(), dtype=dtype))  # signs and sizes
    got = gp.gelu_poly_backward_reference(x, g)
    want = _autograd_dx(x, g)
    assert got.dtype == dtype
    assert (got - want).abs().max().item() <= atol
    # the mask is inclusive at exactly +-8, zero beyond: dx is phi there
    for v in (8.0, -8.0, 9.0, -9.0, 1e4, -1e4):
        one = torch.tensor([v], dtype=dtype)
        assert torch.allclose(gp.gelu_poly_backward_reference(
            one, torch.ones_like(one)), _autograd_dx(one, torch.ones_like(
                one)), atol=atol, rtol=0)


def test_backward_reference_rounds_once_to_x_dtype():
    x = _grid(torch.bfloat16)
    g = torch.ones_like(x)
    got = gp.gelu_poly_backward_reference(x, g)
    want = gp.gelu_poly_backward_reference(x.float(), g.float())
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, want.to(torch.bfloat16))


@pytest.mark.parametrize("fn", ["_GeluPoly", "_GeluPolyT"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float64])
def test_function_on_the_cpu_saves_x_alone(dtype, fn):
    x = _grid(dtype).reshape(-1, 5).requires_grad_(True)
    reset_launch_counts()
    y = getattr(gp, fn).apply(x)
    assert torch.equal(y, gp.gelu_poly_reference(x.detach()))
    saved = y.grad_fn.saved_tensors
    assert len(saved) == 1 and saved[0] is x
    g = torch.full_like(y, 0.5)
    y.backward(g)
    assert x.grad.dtype == dtype
    assert torch.equal(x.grad, gp.gelu_poly_backward_reference(
        x.detach(), g))
    assert launch_counts() == {}  # the plain versions count nothing


def test_function_backward_returns_only_what_is_asked():
    x = torch.linspace(-3, 3, 7)
    g = torch.ones_like(x)
    ctx = SimpleNamespace(saved_tensors=(x,), needs_input_grad=(False,))
    assert gp._GeluPoly.backward(ctx, g) is None
    ctx.needs_input_grad = (True,)
    assert torch.equal(gp._GeluPoly.backward(ctx, g),
                       gp.gelu_poly_backward_reference(x, g))


@pytest.mark.parametrize("dim", [0, 1])
def test_function_under_vmap_applies_itself_to_the_unbatched_tensor(dim):
    """``parallel/ensemble.py``'s route: the RHS under ``torch.func.vmap``
    of an expanded (not contiguous) carry, batched along ``dim``, and a
    gradient through it."""
    y0 = torch.linspace(-9, 9, 12, dtype=torch.float32).reshape(3, 4)
    y0.requires_grad_(True)
    ys = y0.unsqueeze(dim).expand(*((4, 3, 4) if dim == 0 else (3, 4, 4)))
    out = torch.func.vmap(gp._GeluPolyT.apply, in_dims=dim, out_dims=dim)(ys)
    assert torch.equal(out, gp.gelu_poly_reference(ys.detach()))
    out.sum().backward()
    want = 4 * gp.gelu_poly_backward_reference(y0.detach(),
                                               torch.ones_like(y0))
    assert torch.allclose(y0.grad, want, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("use_kernels", [True, False])
def test_cpu_dispatch_takes_the_composition(use_kernels):
    x = _grid(torch.float32).requires_grad_(True)
    reset_launch_counts()
    y = fnn.get_activation("GeLUpoly", use_kernels)(x)
    assert torch.equal(y, gp.gelu_poly_reference(x))
    assert torch.equal(fnn.gelu_poly(x), y)
    assert torch.equal(gp.fused_gelu_poly(x), y)
    y.sum().backward()
    assert torch.equal(x.grad, _autograd_dx(x, torch.ones_like(x)))
    assert y.grad_fn.name() != "_GeluPolyBackward"
    assert launch_counts() == {}


def test_get_activation_unchanged_on_the_cpu():
    x = _grid(torch.bfloat16)
    assert fnn.get_activation("GeLUpoly") is fnn.gelu_poly
    assert torch.equal(fnn.get_activation("GeLUpoly")(x),
                       gp.gelu_poly_reference(x))
    assert fnn.get_activation("GeLUpoly", False) is gp.gelu_poly_reference


def test_custom_op_on_the_cpu_is_the_composition():
    x = _grid(torch.float32)
    assert torch.equal(torch.ops.nodems.gelu_poly(x),
                       gp.gelu_poly_reference(x))
