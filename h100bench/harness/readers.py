"""Arithmetic shared by the per-layer metric readers: a layer's roofline
share, and the idle share and the share of the card's peak of the
traced units. The profiler slows the host, so those two take the device
time and the work of the traced units over their wall time untraced:
the units' count times the seconds a unit took in the untraced units run
just before the trace (``ctx.unit_s``). A reader that finds nothing to
read returns None, and the metric is left out of the line."""

from typing import Iterable, Optional

from harness import peaks


def roofline(ctx, ranges: Iterable[str]) -> Optional[float]:
    """Percent: the least time of the layer's calls (each the larger of its
    operations over the peak and its bytes over the bandwidth) over the
    device time of the kernels its ranges enclose."""
    ranges = set(ranges)
    least = sum(peaks.least_s(w["flops"], w["bytes"], ctx.dtype)
                for name, w in ctx.calls if name in ranges)
    device = sum(ctx.summary.layer_device_s.get(n, 0.0) for n in ranges)
    if least <= 0 or device <= 0:
        return None
    return 100.0 * least / device


def untraced_s(ctx) -> float:
    """The traced units' wall time as the untraced units ran."""
    return ctx.units * ctx.unit_s


def mfu(ctx, ranges: Iterable[str]) -> Optional[float]:
    """Percent: the operations of the traced calls in ``ranges`` over the
    units' untraced wall time, at the card's peak in the served dtype."""
    ranges = set(ranges)
    flops = sum(w["flops"] for name, w in ctx.calls if name in ranges)
    if flops <= 0 or untraced_s(ctx) <= 0:
        return None
    return 100.0 * flops / untraced_s(ctx) / peaks.FLOPS[ctx.dtype]


def idle(ctx) -> Optional[float]:
    """Percent of the units' untraced wall time in which no kernel, copy
    or fill of the traced units ran."""
    busy = ctx.summary.busy_s
    if untraced_s(ctx) <= 0 or busy <= 0:
        return None
    return 100.0 * (1.0 - busy / untraced_s(ctx))
