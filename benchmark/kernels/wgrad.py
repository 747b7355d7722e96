"""The wgrad kernel: the weight gradient of every stride-1 SAME 3x3 conv.
Least time: summed over the ops, each the larger of its FLOPs bound and
its bytes (x and dy read once, dw written once)."""
from benchmark.harness import work

PRIORITY = 20
PATTERNS = [r"wgrad_(?:partial|tma|f32|reduce)_kernel"]


def claims(op, cell):
    return (op["kind"] == "conv" and op["k"] == 3 and op["stride"] == 1
            and op["pad"] == 1 and op["phase"] == "wgrad")


def least_seconds(ops, peak):
    return sum(work.least_seconds(work.flops(o), work.nbytes(o), peak)
               for o in ops)
