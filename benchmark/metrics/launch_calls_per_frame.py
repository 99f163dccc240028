"""Streams entry: CUDA runtime and driver launch calls in the profiled
stretch, per frame. A count: it repeats exactly; a CUDA graph or a fused
loop lowers it."""

from benchmark.metrics._busy import is_launch


def read(ctx):
    if not ctx.frames:
        return None
    launches = sum(is_launch(name) for name in ctx.runtime)
    return launches / ctx.frames if launches else None
