"""Training traffic: a closed loop of train steps, back to back, on a pool
of seeded batches held on the device.

The traffic file sets ``batch``, ``pool`` (batches in the pool),
``images`` ("normal" or "uniform"), ``check_steps`` (the first steps,
which the reference follows), ``activation``, ``optimizer``, and
optionally ``attack`` (FGSM with a random start), ``noise`` (the solver
smoothing), ``members`` with ``member_u`` (a fleet: one step trains every
member, member m at its own u) and ``trace_units`` (steps in a traced
window).

Set-up builds one step object from the seed (weights made on the device,
then handed to the program), drives it through the check steps on pool
batches 0, 1, 2, ... (all rows differ), and hands the same object to the
window, which goes on through the pool in turn.  The program's side of the
check is read on the way: each check step's loss, the first gradient as
the optimizer received it (from its state after one step) and each
parameter's change over the check steps.
"""
from __future__ import annotations

import time
from typing import Optional

import torch

from benchmark import reference
from benchmark.harness import compare, port, runs
from benchmark.reference import training as ref_training


def _optimizer(opt: dict):
    from neural_ode_metasolver_tpu_torch.training import (cyclic_lr,
                                                          make_optimizer)

    lr = opt["lr"]
    if isinstance(lr, dict):
        lr = cyclic_lr(lr["base"], lr["max"], lr["step_size_up"])
    return make_optimizer(opt["name"], lr, momentum=opt.get("momentum", 0.9),
                          weight_decay=opt.get("weight_decay", 0.0))


def _opt_grads(opt: dict, opt_state: dict):
    """The gradient the rule received at its first step, from its state:
    SGD's trace is it; RMSprop's nu is 0.01 g^2, whose root is |g|."""
    if opt["name"] == "sgd":
        return {k: v.detach().clone()
                for k, v in opt_state["momentum"].items()}
    return {k: (v / 0.01).sqrt() for k, v in opt_state["nu"].items()}


def setup(cell, seed: int, device) -> dict:
    """The step object driven through its check steps (module
    docstring)."""
    from neural_ode_metasolver_tpu_torch.ops import SolverOptions
    from neural_ode_metasolver_tpu_torch.training import (
        AttackConfig, NoiseConfig, create_train_state, make_train_step)
    from neural_ode_metasolver_tpu_torch.training import fleet

    cfg, tr = cell.config, cell.traffic
    family = reference.load(cfg["reference"])
    members = tr.get("members")
    weights = runs.make_weights(family.param_spec(cfg), seed, device,
                                members)
    lead = (members,) if members else ()
    g = torch.Generator(device=device).manual_seed(
        runs.sub_seed(seed, "batches"))
    pool, batch = int(tr["pool"]), int(tr["batch"])
    xs = port.images((pool,) + lead + (batch,) + tuple(cfg["image"]),
                 tr["images"], g, device)
    ys = torch.randint(0, cfg["num_classes"], (pool,) + lead + (batch,),
                       generator=g, device=device)
    model = port.model(cfg, tr["activation"], device)
    opt = _optimizer(tr["optimizer"])
    solvers = [port.solver(cfg)]
    dtype = getattr(torch, cfg["compute_dtype"])
    attack = AttackConfig()
    if tr.get("attack"):
        a = tr["attack"]
        attack = AttackConfig(mode=a["mode"], eps=a["eps"], alpha=a["alpha"],
                              mean=tuple(cfg["normalization"]["mean"]),
                              std=tuple(cfg["normalization"]["std"]))
    noise = NoiseConfig()
    if tr.get("noise"):
        n = tr["noise"]
        noise = NoiseConfig(noise_type=n["type"], sigma=n["sigma"],
                            prob=n["prob"])
    compute = None if dtype == torch.float32 else dtype
    if members:
        member_seeds = [runs.sub_seed(seed, f"member{m}")
                        for m in range(members)]
        gens = fleet.fleet_generators(member_seeds)
        state = fleet.create_fleet_state(model, opt, state_dict=weights)
        dyn = fleet.stack_fleet_solvers([[solvers[0].replace(
            u=torch.tensor(float(u)))] for u in tr["member_u"]])
        fstep = fleet.make_fleet_train_step(model, opt, solvers,
                                            SolverOptions(), attack, noise,
                                            compute_dtype=compute)
        step = lambda st, x, y: fstep(st, x, y, gens, dyn)  # noqa: E731
        step_seeds = member_seeds
    else:
        model.load_state_dict(weights)
        state = create_train_state(model, opt)
        tstep = make_train_step(model, opt, solvers, SolverOptions(), attack,
                                noise, compute_dtype=compute)
        step_seeds = runs.sub_seed(seed, "steps")
        gen = torch.Generator().manual_seed(step_seeds)
        step = lambda st, x, y: tstep(st, x, y, gen)  # noqa: E731
    losses, grads = [], None
    for i in range(int(tr["check_steps"])):
        state, m = step(state, xs[i], ys[i])
        losses.append(m["loss"].detach().clone())
        if grads is None:
            grads = _opt_grads(tr["optimizer"], state.opt_state)
    change = {k: p.detach() - weights[k] for k, p in state.params.items()}
    runs.sync(device)
    prog = {"losses": [v.tolist() for v in losses], "grads": grads,
            "change": change}
    inputs = {"weights": weights, "xs": xs[:len(losses)],
              "ys": ys[:len(losses)], "step_seeds": step_seeds}
    return {"device": device, "step": step, "state": state, "xs": xs,
            "ys": ys, "next": len(losses), "prog": prog, "inputs": inputs,
            "unit_images": batch * (members or 1), "model": model}


def unit(run: dict) -> None:
    """One window step on the pool's next batch."""
    i = run["next"] % run["xs"].shape[0]
    run["state"], _ = run["step"](run["state"], run["xs"][i], run["ys"][i])
    run["next"] += 1


def window(run: dict, seconds: float) -> dict:
    """Steps back to back until ``seconds`` have passed; the window closes
    when the last step's work is done."""
    dev = run["device"]
    runs.sync(dev)
    t0 = time.perf_counter()
    n = 0
    while True:
        unit(run)
        n += 1
        if time.perf_counter() - t0 >= seconds:
            break
    runs.sync(dev)
    return {"units": n, "seconds": time.perf_counter() - t0,
            "images": n * run["unit_images"], "attempted": n, "failed": 0}


def release(run: dict) -> dict:
    """Free the program's state; returns what the check reads."""
    out = {"prog": run["prog"], "inputs": run["inputs"]}
    run.clear()
    return out


def reference_run(cell, inputs: dict, precision: str = "f32",
                  half_batch: bool = False) -> dict:
    """The reference's check steps from the run's inputs (a fleet's member
    by member, stacked)."""
    cfg, tr = cell.config, cell.traffic
    family = reference.load(cfg["reference"])
    xs, ys = inputs["xs"], inputs["ys"]
    if not tr.get("members"):
        return ref_training.train_steps(
            family, cfg, tr, inputs["weights"], list(zip(xs, ys)),
            inputs["step_seeds"], cfg["solver"]["u"], precision, half_batch)
    outs = []
    for m, u in enumerate(tr["member_u"]):
        outs.append(ref_training.train_steps(
            family, cfg, tr, {k: v[m] for k, v in inputs["weights"].items()},
            [(x[m], y[m]) for x, y in zip(xs, ys)], inputs["step_seeds"][m],
            float(u), precision, half_batch))
    return {"losses": [[o["losses"][i] for o in outs]
                       for i in range(len(xs))],
            "grads": {k: torch.stack([o["grads"][k] for o in outs])
                      for k in outs[0]["grads"]},
            "change": {k: torch.stack([o["change"][k] for o in outs])
                       for k in outs[0]["change"]}}


def check(cell, out: dict, prog: Optional[dict] = None) -> dict:
    """The numbers of ``correct``: the program's check steps (or ``prog``,
    a stand-in's) against the float32 reference."""
    ref = reference_run(cell, out["inputs"])
    return compare.training_readings(prog or out["prog"], ref,
                                     cell.traffic.get("members"))
