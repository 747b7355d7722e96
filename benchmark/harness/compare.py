"""The numbers that decide ``correct``, and their limits.

Training (a step's object driven through its first steps, the reference
following the same steps from the same weights, batches and step seed):

  loss_gap           the largest |loss - ref| / |ref| over the steps (and
                     members); loss1_gap the same of the first step alone
  grad_gap           the first step's gradient as the optimizer received
                     it, by the worst leaf: |norm - ref norm| / max(ref
                     norm, the median leaf's ref norm)
  change_gap         every parameter's change over the steps, by the worst
                     leaf, measured the same way; leaves whose reference
                     gradient is under a thousandth of the median leaf's
                     are left out (they move by round-off alone);
                     change_median_gap the median leaf's

A cell's file of limits names the numbers it compares.

A fleet's leaves are each member's slice of each parameter.

Serving: ``logit_gap``, the largest |logits - ref| over a request's
logits, over the largest |ref| of that request, over every answer of the
window.  A number that is not finite fails.
"""
from __future__ import annotations

import math
import statistics
from typing import Dict, List, Optional, Sequence, Tuple

import torch

Key = Tuple[str, int]


def leaf_norms(tree: Dict[str, torch.Tensor], members: Optional[int]
               ) -> Dict[Key, float]:
    """The L2 norm of each leaf (each member's slice of it for a fleet)."""
    out: Dict[Key, float] = {}
    for k, t in tree.items():
        t = t.detach().double()
        if members is None:
            out[(k, 0)] = float(torch.linalg.vector_norm(t))
        else:
            norms = torch.linalg.vector_norm(t.reshape(members, -1), dim=1)
            for m, v in enumerate(norms.tolist()):
                out[(k, m)] = v
    return out


def leaf_gaps(prog: Dict[Key, float], ref: Dict[Key, float],
              keep: Optional[Sequence[Key]] = None) -> List[float]:
    """Each leaf's |norm - ref norm| / max(ref norm, the median leaf's ref
    norm); inf for a leaf the program lacks or a gap not finite."""
    keys = list(ref) if keep is None else list(keep)
    med = statistics.median(ref[k] for k in keys)
    out = []
    for k in keys:
        gap = (abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30)
               if k in prog else math.inf)
        out.append(gap if math.isfinite(gap) else math.inf)
    return out


def training_readings(prog: dict, ref: dict,
                      members: Optional[int] = None) -> Dict[str, float]:
    """``prog`` and ``ref``: ``{"losses": [...], "grads": {...}, "change":
    {...}}``; a fleet's losses are per step lists of the members'."""
    lp = torch.tensor(prog["losses"], dtype=torch.float64)
    lr = torch.tensor(ref["losses"], dtype=torch.float64)
    if lp.shape != lr.shape:
        steps = torch.full(lr.shape[:1], math.inf, dtype=torch.float64)
    else:
        rel = (lp - lr).abs() / lr.abs().clamp_min(1e-30)
        steps = rel.reshape(rel.shape[0], -1).amax(1)
    steps = [v if math.isfinite(v) else math.inf for v in steps.tolist()]
    rg = leaf_norms(ref["grads"], members)
    med = statistics.median(rg.values())
    keep = [k for k, v in rg.items() if v >= 1e-3 * med]
    change = leaf_gaps(leaf_norms(prog["change"], members),
                       leaf_norms(ref["change"], members), keep)
    return {
        "loss_gap": max(steps),
        "loss1_gap": steps[0],
        "grad_gap": max(leaf_gaps(leaf_norms(prog["grads"], members), rg)),
        "change_gap": max(change),
        "change_median_gap": statistics.median(change),
    }


def logit_gap(answers: List[Tuple[int, torch.Tensor]],
              ref: Dict[int, torch.Tensor]) -> float:
    """The worst answer's gap: each answer (pool index, logits) against
    the reference's logits of the same inputs."""
    if not answers:
        return math.inf
    worst = 0.0
    by_index: Dict[int, List[torch.Tensor]] = {}
    for i, z in answers:
        by_index.setdefault(i, []).append(z)
    for i, zs in by_index.items():
        r = ref[i].double()
        z = torch.stack(zs).double()
        gap = float(((z - r).abs().amax(dim=(1, 2))
                     / r.abs().amax().clamp_min(1e-30)).max())
        if not math.isfinite(gap):
            return math.inf
        worst = max(worst, gap)
    return worst


def judge(readings: Dict[str, float], limits: Dict[str, float]
          ) -> Tuple[bool, Dict[str, dict]]:
    """``correct`` and each number beside its limit; a number with no
    reading, or one that is not finite, fails."""
    checks = {}
    ok = True
    for name, limit in limits.items():
        v = readings.get(name, math.inf)
        good = math.isfinite(v) and v <= limit
        ok = ok and good
        checks[name] = {"value": v if math.isfinite(v) else str(v),
                        "limit": limit}
    return ok, checks
