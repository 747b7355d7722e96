"""Seconds from the process's start to the first timed unit: imports, the
CUDA context, the kernels built or loaded, the weights and inputs made,
and the warm-up (a training cell's check steps)."""


def read(ctx):
    return ctx.setup_s
