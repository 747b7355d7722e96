"""Kernel B3, GroupNorm fused with its activation, and its backward: every
GroupNorm of the unit, forward and backward.  Least time: bytes over the
bandwidth (x and y forward; x, dy and dx backward), summed."""
from benchmark.harness import work

PRIORITY = 20
PATTERNS = [r"nodems::gn_act_kernel", r"nodems::gn_act_bwd_kernel",
            r"gn_param_grad_reduce"]


def claims(op, cell):
    return op["kind"] == "gn"


def least_seconds(ops, peak):
    return sum(work.least_seconds(work.flops(o), work.nbytes(o), peak)
               for o in ops)
