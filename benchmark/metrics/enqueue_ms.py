"""Streams entry: the mean host time inside the entry call, per batch, in
ms (the benchmark's own span around the call; the traced run's batches
outside the profiled stretch)."""


def read(ctx):
    if not ctx.enqueue_s:
        return None
    return 1e3 * sum(ctx.enqueue_s) / len(ctx.enqueue_s)
