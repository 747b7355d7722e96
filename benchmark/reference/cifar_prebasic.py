"""Plain float32 reference of the CIFAR-10 pre-activation MetaNODE family
(``premetanode*`` of juliagusak/neural-ode-metasolver,
``sopa/src/models/odenet_cifar10``), for the NF / PNF configuration the
benchmark runs: no norm layers, no param norms, every activation the
configuration's.

  conv1 (3 -> in_planes, 3x3, no bias) -> act           (faithful_preact_bug)
  per stage i (stride 1, 2, ...; width in_planes * 2^i):
    PreBasicBlock:  act -> conv3x3(stride) -> act -> conv3x3,
                    + shortcut (1x1 conv of stride s where the shape
                    changes, else the input)
    ODE blocks:     y' = conv2(act(conv1(act(y)))), RK2(u), n steps on [0, 1]
  global average pool -> Linear

Weights are a flat dict ``params.<path>`` (conv kernels HWIO, the linear
kernel (in, out)); inputs NHWC.  ``forward_ops`` lists the forward's convs
and its linear layer with their shapes, which the benchmark counts work
from.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from . import common

__all__ = ["check", "param_spec", "forward", "forward_ops"]


def check(cfg: dict) -> None:
    """Raise for a configuration this reference does not compute."""
    if (cfg.get("block_type") != "prebasic"
            or set(cfg.get("norms", ())) != {"NF"}
            or set(cfg.get("param_norms", ())) != {"PNF"}
            or not cfg.get("faithful_preact_bug", False)):
        raise ValueError("cifar_prebasic computes the prebasic NF/PNF "
                         "family with faithful_preact_bug only")


def _stages(cfg: dict) -> List[Tuple[int, int, int, int]]:
    """(width, stride, res blocks, ode blocks) per stage."""
    w = cfg["in_planes"]
    return [(w * 2 ** i, 1 if i == 0 else 2, r, o)
            for i, (r, o) in enumerate(cfg["num_blocks"])]


def param_spec(cfg: dict) -> List[Tuple[str, tuple, float]]:
    """(name, shape, uniform bound) of every parameter, in a fixed order;
    the bound is 1/sqrt(fan_in), PyTorch's default for conv and linear."""
    check(cfg)
    spec = []

    def conv(name, cin, cout, k):
        spec.append((f"{name}.kernel", (k, k, cin, cout),
                     (cin * k * k) ** -0.5))

    cin = cfg["image"][2]
    conv("params.conv1", cin, cfg["in_planes"], 3)
    cur = cfg["in_planes"]
    for li, (w, stride, n_res, n_ode) in enumerate(_stages(cfg)):
        for r in range(n_res):
            p = f"params.layer{li + 1}.res.{r}"
            s = stride if r == 0 else 1
            conv(f"{p}.conv1", cur, w, 3)
            conv(f"{p}.conv2", w, w, 3)
            if s != 1 or cur != w:
                conv(f"{p}.sc_conv", cur, w, 1)
            cur = w
        for o in range(n_ode):
            p = f"params.layer{li + 1}.ode.{o}"
            conv(f"{p}.conv1", cur, cur, 3)
            conv(f"{p}.conv2", cur, cur, 3)
    spec.append(("params.fc.kernel", (cur, cfg["num_classes"]), cur ** -0.5))
    spec.append(("params.fc.bias", (cfg["num_classes"],), cur ** -0.5))
    return spec


def forward(cfg: dict, P: Dict[str, torch.Tensor], x: torch.Tensor,
            u: float, activation: str, precision: str = "f32"
            ) -> torch.Tensor:
    """Logits (N, classes) of NHWC images ``x`` with the ODE blocks solved
    at RK2(u) over the configuration's step count; ``precision`` as
    ``common`` says (every held tensor rounded under ``"fp8"``)."""
    fn = common.ACTIVATIONS[activation]
    hold = lambda t: common.rounded(t, precision)  # noqa: E731
    act = lambda t: hold(fn(t))  # noqa: E731
    cv = lambda h, name, s, p: hold(common.conv(  # noqa: E731
        h, P[name + ".kernel"], s, p, precision=precision))
    n_steps = cfg["solver"]["n_steps"]
    h = act(cv(hold(x.permute(0, 3, 1, 2).contiguous()), "params.conv1", 1,
               1))
    for li, (w, stride, n_res, n_ode) in enumerate(_stages(cfg)):
        for r in range(n_res):
            p = f"params.layer{li + 1}.res.{r}"
            s = stride if r == 0 else 1
            o = cv(act(h), f"{p}.conv1", s, 1)
            o = cv(act(o), f"{p}.conv2", 1, 1)
            sc = cv(h, f"{p}.sc_conv", s, 0) if f"{p}.sc_conv.kernel" in P \
                else h
            h = hold(o + sc)
        for o in range(n_ode):
            p = f"params.layer{li + 1}.ode.{o}"
            def rhs(t, y, p=p):
                return cv(act(cv(act(y), f"{p}.conv1", 1, 1)), f"{p}.conv2",
                          1, 1)

            h = common.rk2_solve(rhs, h, u, n_steps, hold=hold)
    return common.linear(hold(h.mean(dim=(2, 3))), P["params.fc.kernel"],
                         P["params.fc.bias"], precision)


def forward_ops(cfg: dict, batch: int) -> List[dict]:
    """The forward's convs and linear layer in order, with their shapes:
    conv ops carry n, h, w (input), ho, wo, cin, cout, k, stride, pad and
    ``solve`` (the ODE block they belong to, else None) and ``first``
    (their input is the image)."""
    H, W, C = cfg["image"]
    n_steps = cfg["solver"]["n_steps"]
    ops = []

    def conv(h, w, cin, cout, k, stride, pad, solve=None, first=False):
        ho = (h + 2 * pad - k) // stride + 1
        wo = (w + 2 * pad - k) // stride + 1
        ops.append(dict(kind="conv", n=batch, h=h, w=w, ho=ho, wo=wo,
                        cin=cin, cout=cout, k=k, stride=stride, pad=pad,
                        solve=solve, first=first))
        return ho, wo

    h, w = conv(H, W, C, cfg["in_planes"], 3, 1, 1, first=True)
    cur = cfg["in_planes"]
    solve = 0
    for width, stride, n_res, n_ode in _stages(cfg):
        for r in range(n_res):
            s = stride if r == 0 else 1
            h2, w2 = conv(h, w, cur, width, 3, s, 1)
            conv(h2, w2, width, width, 3, 1, 1)
            if s != 1 or cur != width:
                conv(h, w, cur, width, 1, s, 0)
            h, w, cur = h2, w2, width
        for _ in range(n_ode):
            for _ in range(2 * n_steps):  # two stages a step
                conv(h, w, cur, cur, 3, 1, 1, solve=solve)
                conv(h, w, cur, cur, 3, 1, 1, solve=solve)
            solve += 1
    ops.append(dict(kind="linear", n=batch, fin=cur,
                    fout=cfg["num_classes"]))
    return ops
