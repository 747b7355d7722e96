"""Device operations (kernels, copies, fills) a step in the trace."""
from benchmark.harness import layers


def read(ctx):
    return layers.device_ops(ctx)
