"""Images answered in the window over the window's seconds."""
from benchmark.harness import layers


def read(ctx):
    return layers.img_per_s(ctx)
