"""Serving traffic: one caller in a closed loop, each request a batch of
seeded images handed over as a host tensor, answered when its logits are
on the host.

The traffic file sets ``batch``, ``pool`` (distinct request batches, made
from the seed and sent in turn), ``images``, ``activation``,
``warm_requests`` and ``trace_units``.  Every answer of the window is kept
with the index of its batch, and the check compares each against the
reference's logits of that batch.
"""
from __future__ import annotations

import time

import torch

from benchmark import reference
from benchmark.harness import compare, port, runs


def setup(cell, seed: int, device) -> dict:
    from neural_ode_metasolver_tpu_torch.serving import ServedModel

    cfg, tr = cell.config, cell.traffic
    family = reference.load(cfg["reference"])
    weights = runs.make_weights(family.param_spec(cfg), seed, device)
    g = torch.Generator(device=device).manual_seed(
        runs.sub_seed(seed, "requests"))
    shape = (int(tr["pool"]), int(tr["batch"])) + tuple(cfg["image"])
    pool = port.images(shape, tr["images"], g, device).cpu()
    model = port.model(cfg, tr["activation"], device)
    model.load_state_dict(weights)
    served = ServedModel(model, [port.solver(cfg)],
                         compute_dtype=getattr(torch, cfg["compute_dtype"]))
    run = {"device": device, "served": served, "pool": pool, "next": 0,
           "answers": [], "failed": 0, "weights": weights,
           "unit_images": int(tr["batch"])}
    for _ in range(int(tr["warm_requests"])):
        unit(run)
    return run


def unit(run: dict) -> float:
    """One request: the next pool batch in, its logits on the host; returns
    its latency in seconds."""
    i = run["next"] % run["pool"].shape[0]
    t0 = time.perf_counter()
    try:
        z = run["served"](run["pool"][i]).cpu()
    except RuntimeError:
        run["failed"] += 1
        z = None
    dt = time.perf_counter() - t0
    run["next"] += 1
    if z is not None:
        run["answers"].append((i, z))
    return dt


def window(run: dict, seconds: float) -> dict:
    failed, start = run["failed"], len(run["answers"])
    lat = []
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        lat.append(unit(run))
    dt = time.perf_counter() - t0
    done = len(run["answers"]) - start
    return {"units": len(lat), "seconds": dt, "latencies": lat,
            "images": done * run["unit_images"], "attempted": len(lat),
            "failed": run["failed"] - failed}


def release(run: dict) -> dict:
    out = {"answers": run["answers"], "failed": run["failed"],
           "inputs": {"weights": run["weights"], "pool": run["pool"]}}
    run.clear()
    return out


@torch.no_grad()
def reference_logits(cell, inputs: dict, indices, precision: str = "f32"
                     ) -> dict:
    """The reference's logits of each pool batch in ``indices``, on the
    weights' device."""
    cfg, tr = cell.config, cell.traffic
    family = reference.load(cfg["reference"])
    w = inputs["weights"]
    dev = next(iter(w.values())).device
    out = {}
    from benchmark.reference import common
    with common.precision_flags(precision):
        for i in sorted(set(indices)):
            out[i] = family.forward(cfg, w, inputs["pool"][i].to(dev),
                                    cfg["solver"]["u"], tr["activation"],
                                    precision).cpu()
    return out


def check(cell, out: dict, prog=None) -> dict:
    answers = prog if prog is not None else out["answers"]
    ref = reference_logits(cell, out["inputs"], [i for i, _ in answers])
    gap = compare.logit_gap(answers, ref)
    return {"logit_gap": gap if out.get("failed", 0) == 0 else float("inf")}
