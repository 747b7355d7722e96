"""Plain float32 reference of the MNIST MetaNODE
(juliagusak/neural-ode-metasolver, ``sopa/src/models/odenet_mnist``) with
conv downsampling:

  conv 3x3 VALID (in -> dim) -> GN -> ReLU -> conv 4x4 s2 p1 -> GN -> ReLU
  -> conv 4x4 s2 p1
  ODE block: y' = GN(ConcatConv(t, ReLU(GN(ConcatConv(t, ReLU(GN(y)))))))
             ConcatConv: a constant-t channel first, then y, 3x3 SAME
             (dim + 1 -> dim), with bias; RK2(u), n steps on [0, 1]
  GN -> ReLU -> global average pool -> Linear

GroupNorm takes min(32, dim) groups, eps 1e-5.  Weights are a flat dict
``params.<path>`` (conv kernels HWIO), inputs NHWC.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from . import common

__all__ = ["check", "param_spec", "forward", "forward_ops"]


def check(cfg: dict) -> None:
    if cfg.get("downsampling_method") != "conv" or not cfg.get("is_odenet"):
        raise ValueError("mnist_metanode computes the conv-downsampling "
                         "ODE net only")


def _groups(cfg: dict) -> int:
    return min(32, cfg["dim"])


def param_spec(cfg: dict) -> List[Tuple[str, tuple, object]]:
    """(name, shape, init) of every parameter in a fixed order: a uniform
    bound 1/sqrt(fan_in) for conv and linear kernels and biases, "ones" and
    "zeros" for GroupNorm's scale and bias."""
    check(cfg)
    d, c, k = cfg["dim"], cfg["image"][2], cfg["num_classes"]
    spec = []

    def conv(name, cin, cout, ks):
        b = (cin * ks * ks) ** -0.5
        spec.extend([(f"{name}.kernel", (ks, ks, cin, cout), b),
                     (f"{name}.bias", (cout,), b)])

    def gn(name):
        spec.extend([(f"{name}.scale", (d,), "ones"),
                     (f"{name}.bias", (d,), "zeros")])

    conv("params.down.conv0", c, d, 3)
    gn("params.down.norm0")
    conv("params.down.conv1", d, d, 4)
    gn("params.down.norm1")
    conv("params.down.conv2", d, d, 4)
    gn("params.blocks.0.norm1")
    conv("params.blocks.0.conv1", d + 1, d, 3)
    gn("params.blocks.0.norm2")
    conv("params.blocks.0.conv2", d + 1, d, 3)
    gn("params.blocks.0.norm3")
    gn("params.head.norm")
    spec.extend([("params.head.fc.kernel", (d, k), d ** -0.5),
                 ("params.head.fc.bias", (k,), d ** -0.5)])
    return spec


def forward(cfg: dict, P: Dict[str, torch.Tensor], x: torch.Tensor,
            u: float, activation: str = "ReLU", precision: str = "f32"
            ) -> torch.Tensor:
    """Logits (N, classes) of NHWC images ``x``, the ODE block solved at
    RK2(u) over the configuration's step count.  The net's activations are
    ReLU, as the published net runs them, whatever ``activation`` says."""
    del activation
    g = _groups(cfg)

    def cv(h, name, s, p):
        return common.conv(h, P[name + ".kernel"], s, p, P[name + ".bias"],
                           precision)

    def gn(h, name):
        return common.group_norm(h, P[name + ".scale"], P[name + ".bias"], g)

    def concat(h, t, name):
        tt = torch.full_like(h[:, :1], float(t))
        return cv(torch.cat([tt, h], dim=1), name, 1, 1)

    def rhs(t, y):
        o = concat(F.relu(gn(y, "params.blocks.0.norm1")), t,
                   "params.blocks.0.conv1")
        o = concat(F.relu(gn(o, "params.blocks.0.norm2")), t,
                   "params.blocks.0.conv2")
        return gn(o, "params.blocks.0.norm3")

    h = cv(x.permute(0, 3, 1, 2).contiguous(), "params.down.conv0", 1, 0)
    h = cv(F.relu(gn(h, "params.down.norm0")), "params.down.conv1", 2, 1)
    h = cv(F.relu(gn(h, "params.down.norm1")), "params.down.conv2", 2, 1)
    h = common.rk2_solve(rhs, h, u, cfg["solver"]["n_steps"])
    h = F.relu(gn(h, "params.head.norm")).mean(dim=(2, 3))
    return common.linear(h, P["params.head.fc.kernel"],
                         P["params.head.fc.bias"], precision)


def forward_ops(cfg: dict, batch: int) -> List[dict]:
    """The forward's convs, GroupNorms and linear layer in order, with
    their shapes (see ``cifar_prebasic.forward_ops``); a GroupNorm op
    carries n, h, w, c and its activation."""
    H, W, C = cfg["image"]
    d = cfg["dim"]
    ops = []

    def conv(h, w, cin, cout, k, stride, pad, solve=None, first=False):
        ho = (h + 2 * pad - k) // stride + 1
        wo = (w + 2 * pad - k) // stride + 1
        ops.append(dict(kind="conv", n=batch, h=h, w=w, ho=ho, wo=wo,
                        cin=cin, cout=cout, k=k, stride=stride, pad=pad,
                        solve=solve, first=first))
        return ho, wo

    def gn(h, w, act, solve=None):
        ops.append(dict(kind="gn", n=batch, h=h, w=w, c=d, act=act,
                        solve=solve))

    h, w = conv(H, W, C, d, 3, 1, 0, first=True)
    gn(h, w, "relu")
    h, w = conv(h, w, d, d, 4, 2, 1)
    gn(h, w, "relu")
    h, w = conv(h, w, d, d, 4, 2, 1)
    for _ in range(2 * cfg["solver"]["n_steps"]):
        gn(h, w, "relu", 0)
        conv(h, w, d + 1, d, 3, 1, 1, solve=0)
        gn(h, w, "relu", 0)
        conv(h, w, d + 1, d, 3, 1, 1, solve=0)
        gn(h, w, None, 0)
    gn(h, w, "relu")
    ops.append(dict(kind="linear", n=batch, fin=d, fout=cfg["num_classes"]))
    return ops
