#!/usr/bin/env python3
"""Read the numbers that decide ``correct`` over many seeds in one process,
for the program, for its control and for planted faults, at a cell's own
size, so that each limit can be set between the program's readings and
theirs.

    python3 benchmark/control.py --workload <cell> --seeds 1,2,3
        --what program|control|half_batch|unchanged [--seconds 2]

  program     the program's run as ``run.py`` makes it (a serving cell's
              window lasts ``--seconds``), against the float32 reference
  control     the reference computed in the precision below the
              configuration's (``control_precision``: fp8 operands for a
              bfloat16 configuration, TF32 for a float32 one) in the
              program's place
  half_batch  a training cell's reference trained on the first half of
              every batch, the mean taken over it, in the program's place
  unchanged   a training cell's state left as it was by every step: no
              gradient reaches the optimizer and no parameter moves

Each seed prints one JSON line of readings; the last line gives each
number's least and largest reading.  Runs on the CUDA card; the benchmark's
own runs never run this.
"""
import argparse
import gc
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WHAT = ("program", "control", "half_batch", "unchanged")


def readings(cell, seed: int, what: str, device, seconds: float = 2.0
             ) -> dict:
    """The numbers of ``correct`` for one seed of ``what`` (module
    docstring)."""
    import torch

    from benchmark.harness import compare

    driver = cell.driver()
    run = driver.setup(cell, seed, device)
    if what == "program" and cell.traffic["driver"] == "serve":
        driver.window(run, seconds)
    out = driver.release(run)
    del run
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    if what == "program":
        return driver.check(cell, out)
    precision = cell.config["control_precision"]
    if cell.traffic["driver"] == "serve":
        if what != "control":
            raise ValueError(f"a serving cell has no {what!r} fault")
        idx = range(out["inputs"]["pool"].shape[0])
        ctrl = driver.reference_logits(cell, out["inputs"], idx, precision)
        return driver.check(cell, out, [(i, ctrl[i]) for i in idx])
    if what == "unchanged":
        prog = {"losses": out["prog"]["losses"],
                "grads": {k: torch.zeros_like(v)
                          for k, v in out["prog"]["grads"].items()},
                "change": {k: torch.zeros_like(v)
                           for k, v in out["prog"]["change"].items()}}
        return driver.check(cell, out, prog)
    stand_in = driver.reference_run(
        cell, out["inputs"], precision if what == "control" else "f32",
        half_batch=what == "half_batch")
    return compare.training_readings(
        stand_in, driver.reference_run(cell, out["inputs"]),
        cell.traffic.get("members"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--what", choices=WHAT, default="program")
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    from benchmark.harness import cell as cellmod

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    cell = cellmod.resolve(args.workload, ROOT)
    seen = {}
    for seed in (int(s) for s in args.seeds.split(",")):
        r = readings(cell, seed, args.what, torch.device("cuda", 0),
                     args.seconds)
        print(json.dumps({"cell": cell.name, "what": args.what,
                          "seed": seed, "readings": r}), flush=True)
        for k, v in r.items():
            seen.setdefault(k, []).append(v)
    print(json.dumps({"cell": cell.name, "what": args.what,
                      "least": {k: min(v) for k, v in seen.items()},
                      "largest": {k: max(v) for k, v in seen.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
