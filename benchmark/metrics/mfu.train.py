"""The whole unit's share of the card's peak: the unit's model FLOPs (2 x
multiply-adds of every conv and linear layer, each forward once, and the
input and weight gradients each backward needs, counted from the
configuration's shapes, ``benchmark/harness/work.py``) times the traced
units, over the seconds the same units take run again untraced (the
profiler's cost a launch left out), over the peak of the precision the
configuration's convs run in, in %."""
from benchmark.harness import layers


def read(ctx):
    return layers.mfu(ctx)
