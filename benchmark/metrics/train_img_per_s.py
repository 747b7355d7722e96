"""Images trained in the window over the window's seconds, the window
closing when the last step's work is done."""
from benchmark.harness import layers


def read(ctx):
    return layers.img_per_s(ctx)
