"""The work a unit of a cell needs, counted from the configuration's shapes
(not from what kernels launch), and the card's peaks it is held against.

A unit is a training step or a served request.  ``step_ops`` turns the
reference's list of forward layers into the unit's operations, each with a
``phase``:

  fwd     every layer of every forward (an attack's and the training
          pass's each count once; recomputation does not)
  dgrad   the input gradient of every conv and linear layer that a
          backward needs it of: all of them in an attack (which
          differentiates the image), all but the first in a training pass
  wgrad   the weight gradient of every conv and linear layer in a
          training pass
  gn_bwd  a GroupNorm's backward (with its activation), in every backward

Peaks are NVIDIA's data sheet for one H100 SXM, dense: 989 TFLOP/s in
bf16, 495 in TF32, 67 in float32 off the tensor cores, 3.35 TB/s of HBM.
The least time of an operation is the larger of its FLOPs over the peak of
its precision and its bytes (each input read once, each output written
once) over the bandwidth.
"""
from __future__ import annotations

from typing import Dict, List

PEAK_FLOPS = {"bf16": 989e12, "tf32": 495e12, "f32": 67e12}
PEAK_BYTES_PER_S = 3.35e12
DTYPE_BYTES = {"bfloat16": 2, "float32": 4}


def step_ops(family, cfg: dict, traffic: dict) -> List[dict]:
    """The operations of one unit of ``traffic`` on ``cfg``: copies of the
    reference's forward ops with ``phase``, ``grad`` (a gradient flows),
    ``members`` (runs the op is made for) and ``bytes_per``
    (the activation dtype's size) set."""
    fwd = family.forward_ops(cfg, int(traffic["batch"]))
    base = dict(members=int(traffic.get("members", 1)),
                bytes_per=DTYPE_BYTES[cfg["compute_dtype"]])
    if traffic["driver"] == "serve":
        return [dict(op, **base, phase="fwd", grad=False) for op in fwd]
    out = []
    passes = (["attack"] if traffic.get("attack") else []) + ["train"]
    for p in passes:
        out += [dict(op, **base, phase="fwd", grad=True, pass_=p)
                for op in fwd]
        for op in fwd:
            if op["kind"] == "gn":
                out.append(dict(op, **base, phase="gn_bwd", grad=True,
                                pass_=p))
                continue
            if p == "attack" or not op.get("first"):
                out.append(dict(op, **base, phase="dgrad", grad=True,
                                pass_=p))
            if p == "train":
                out.append(dict(op, **base, phase="wgrad", grad=True,
                                pass_=p))
    return out


def flops(op: dict) -> float:
    """2 x the multiply-adds of a conv or linear op (any phase); 0 for the
    norm layers, whose arithmetic the bytes bound."""
    m = op["members"]
    if op["kind"] == "conv":
        return 2.0 * m * op["n"] * op["ho"] * op["wo"] * op["cout"] \
            * op["cin"] * op["k"] * op["k"]
    if op["kind"] == "linear":
        return 2.0 * m * op["n"] * op["fin"] * op["fout"]
    return 0.0


def nbytes(op: dict) -> float:
    """The bytes an op must move: each input once, each output once."""
    m, b = op["members"], op["bytes_per"]
    if op["kind"] == "conv":
        x = op["n"] * op["h"] * op["w"] * op["cin"]
        y = op["n"] * op["ho"] * op["wo"] * op["cout"]
        w = op["k"] * op["k"] * op["cin"] * op["cout"]
        return float(m * b * (x + y + w))
    if op["kind"] == "linear":
        return float(m * b * (op["n"] * (op["fin"] + op["fout"])
                              + op["fin"] * op["fout"]))
    elems = op["n"] * op["h"] * op["w"] * op["c"]
    tensors = 3 if op["phase"] == "gn_bwd" else 2
    return float(m * b * tensors * elems)


def least_seconds(fl: float, by: float, peak: str) -> float:
    return max(fl / PEAK_FLOPS[peak], by / PEAK_BYTES_PER_S)


def model_flops(ops: List[dict]) -> float:
    """The model FLOPs of a unit: every conv and linear op, all phases."""
    return sum(flops(op) for op in ops)


def assign(ops: List[dict], classes, cell) -> Dict[str, List[dict]]:
    """Each op to the first kernel class (by precedence) that claims it;
    ops no class claims are left out."""
    out: Dict[str, List[dict]] = {}
    for op in ops:
        for k in classes:
            claims = getattr(k.module, "claims", None)
            if claims is not None and claims(op, cell):
                out.setdefault(k.name, []).append(op)
                break
    return out


def least_ms_by_class(ops: List[dict], classes, cell) -> Dict[str, float]:
    """Least device ms a unit, by kernel class, from the class's own
    ``least_seconds(ops, peak)``."""
    peak = cell.config["peak"]
    by = assign(ops, classes, cell)
    return {k.name: 1e3 * k.module.least_seconds(by[k.name], peak)
            for k in classes if k.name in by}
