"""Arithmetic the metric readers share, one function a quantity, so that a
quantity split by the end-to-end metric it moves (``mfu.train``,
``mfu.sweep``) is read alike."""
from __future__ import annotations

from typing import Optional


def img_per_s(ctx) -> Optional[float]:
    """Images of the window (every member's, in a fleet) over its
    seconds."""
    return ctx.images / ctx.seconds if ctx.images and ctx.seconds > 0 \
        else None


def mfu(ctx) -> Optional[float]:
    """The unit's model FLOPs times the units, over the seconds the same
    units take untraced, over the peak of the configuration's precision, in
    %."""
    if not ctx.flops_per_unit or ctx.plain_wall_s <= 0:
        return None
    return 100.0 * ctx.flops_per_unit * ctx.units / ctx.plain_wall_s \
        / ctx.peak_flops


def idle(ctx) -> Optional[float]:
    """The share of a unit's untraced wall time in which no device
    operation runs, in %: 1 minus the device's busy time (the union of its
    intervals in the traced units) over the wall time of as many units run
    untraced."""
    if ctx.plain_wall_s <= 0 or ctx.busy_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.busy_s / ctx.plain_wall_s)


def range_ms(ctx, name: str) -> Optional[float]:
    """Device ms a unit of the kernels launched under the program's range
    ``name``."""
    return ctx.range_ms.get(name) or None


def class_ms(ctx, kernel_class: str) -> Optional[float]:
    """Device ms a unit of a kernel class's kernels."""
    return ctx.class_ms.get(kernel_class) or None


def elementwise_ms(ctx) -> Optional[float]:
    """Device ms a unit of the kernels no class claims (copies and fills
    left out)."""
    return ctx.elementwise_ms if ctx.elementwise_ms > 0 else None


def device_ops(ctx) -> Optional[float]:
    """Device operations a unit in the trace."""
    return ctx.device_ops if ctx.device_ops > 0 else None


def roofline(ctx, kernel_class: str) -> Optional[float]:
    """A kernel class's share of its roofline in %: the least time of the
    work it owns in a unit over the device time of its kernels in a unit;
    None where the launches disagree with the cell's or either is 0."""
    least = ctx.least_ms.get(kernel_class, 0.0)
    took = ctx.class_ms.get(kernel_class, 0.0)
    if not ctx.launches_ok or least <= 0 or took <= 0:
        return None
    return 100.0 * least / took
