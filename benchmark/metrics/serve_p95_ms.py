"""The 95th percentile (nearest rank) of every request's latency in the
window, from the call with host images to its logits on the host."""
import math


def read(ctx):
    lat = sorted(ctx.latencies)
    if not lat:
        return None
    return 1e3 * lat[max(0, math.ceil(0.95 * len(lat)) - 1)]
