"""Tracker: the mean host time a batch inside the program's
``camkifu.rectify_track_streams`` span in the profiled stretch, in ms
(the stream-batched tracker and its warp launches). Host time under the
profiler, which inflates each op: compare it from run to run, not with
``enqueue_ms``."""

from benchmark.metrics._spans import host_ms


def read(ctx):
    return host_ms(ctx, "camkifu.rectify_track_streams")
