"""Device ms a step of the kernels launched under the program's
``nodems.attack`` range (by their launching op's start on the host)."""
from benchmark.harness import layers


def read(ctx):
    return layers.range_ms(ctx, "nodems.attack")
