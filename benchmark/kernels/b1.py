"""Kernel B1, the stride-1 SAME 3x3 conv, and its input gradient (B1 on
flipped weights): every such conv's forward and dgrad that no kernel of
higher precedence computes.  Least time: summed over the ops, each the
larger of its FLOPs and bytes bounds."""
from benchmark.harness import work

PRIORITY = 20
# B1's kernels: the bf16 gather and halo kernels and the f32 core, with the
# plain store epilogue (template argument 0), and the narrow halo kernel
PATTERNS = [r"nodems::conv3x3_(?:igemm|halo|f32)_kernel<[^()]*\b0>",
            r"nodems::conv3x3_halo_narrow_kernel"]


def claims(op, cell):
    return (op["kind"] == "conv" and op["k"] == 3 and op["stride"] == 1
            and op["pad"] == 1 and op["phase"] in ("fwd", "dgrad"))


def least_seconds(ops, peak):
    return sum(work.least_seconds(work.flops(o), work.nbytes(o), peak)
               for o in ops)
