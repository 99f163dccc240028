"""Device: the share of the profiled stretch in which no operation ran on
the card, in %: 100 less the union of the device intervals over the
stretch's wall time."""

from benchmark.metrics._busy import busy_union


def read(ctx):
    if not ctx.kernels or ctx.window_s <= 0:
        return None
    busy = busy_union((s, e) for _, s, e in ctx.kernels) * 1e-6
    return 100.0 * (1.0 - busy / ctx.window_s)
