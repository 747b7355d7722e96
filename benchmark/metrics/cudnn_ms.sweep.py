"""Device ms a step of cuDNN's and cuBLAS's kernels (the ``library``
kernel class)."""
from benchmark.harness import layers


def read(ctx):
    return layers.class_ms(ctx, "library")
