"""Device: the card's busy time per frame in the profiled stretch, in µs
(the union of the device intervals ÷ the stretch's frames). The work the
card does for a frame, whatever the host's pace: steadier from run to run
than the host-paced rate it stands beside."""

from benchmark.metrics._busy import busy_union


def read(ctx):
    if not ctx.kernels or not ctx.frames:
        return None
    return busy_union((s, e) for _, s, e in ctx.kernels) / ctx.frames
