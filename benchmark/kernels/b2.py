"""Kernel B2, the RK2 solve of a CIFAR ODE block in one forward with no
gradient (a served request), whatever launches it: it owns every op of
such a solve where the traffic names B2 the solve's kernel.  Least time of
a solve: its convs' FLOPs over the peak against its state's bytes (the
block's input read once and its output written once, and the weights),
the larger; summed over the solves."""
from benchmark.harness import work

PRIORITY = 10
# B2's convs carry an epilogue (template argument 1, 2 or 3), and its
# first activation is a kernel of its own
PATTERNS = [r"nodems::conv3x3_(?:igemm|halo|f32)_kernel<[^()]*\b[123]>",
            r"gelu_rounded_kernel"]


def claims(op, cell):
    return (cell.traffic.get("solve_kernel") == "b2" and not op["grad"]
            and op.get("solve") is not None)


def least_seconds(ops, peak):
    total = 0.0
    for s in sorted({o["solve"] for o in ops}):
        convs = [o for o in ops if o["solve"] == s and o["kind"] == "conv"]
        fl = sum(work.flops(o) for o in convs)
        c = convs[0]
        state = c["members"] * c["n"] * c["h"] * c["w"] * c["cin"]
        weights = sum(o["k"] * o["k"] * o["cin"] * o["cout"]
                      for o in convs[:2])
        by = c["bytes_per"] * (2 * state + c["members"] * weights)
        total += work.least_seconds(fl, by, peak)
    return total
