"""The share of a unit's untraced wall time in which no device operation
runs: 1 minus the union of the device intervals of the traced units over
the host seconds of as many units run untraced, in %.  (The device record's
``busy_s`` and ``window_s`` are the traced window's, which a host-paced
unit stretches by the profiler's cost a launch.)"""
from benchmark.harness import layers


def read(ctx):
    return layers.idle(ctx)
