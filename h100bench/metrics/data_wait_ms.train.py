"""Host milliseconds a train step spent waiting in ``next(loop.data)``
(the loader's prefetch thread), the mean over the traced steps."""
import statistics


def read(ctx):
    waits = getattr(ctx, "data_wait_ms", None)
    return statistics.fmean(waits) if waits else None
