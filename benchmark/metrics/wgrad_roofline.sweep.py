"""The ``wgrad``'s share of its roofline: the least time of the work its
class owns in a unit, counted from the configuration's shapes
(``benchmark/kernels/wgrad.py``), over the device time of the kernels its
patterns name, in %.  Nothing is read where the launch counters disagree
with the cell's expected launches or no kernel of the class ran."""
from benchmark.harness.layers import roofline


def read(ctx):
    return roofline(ctx, "wgrad")
