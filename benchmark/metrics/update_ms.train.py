"""Device ms a step of the kernels launched under the program's
``nodems.update`` range: the optimizer's update (every member's, in a
fleet)."""
from benchmark.harness import layers


def read(ctx):
    return layers.range_ms(ctx, "nodems.update")
