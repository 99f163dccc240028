"""Classification: the mean host time a batch inside the program's
``camkifu.scan_streams.classify`` span in the profiled stretch, in ms
(the luma downsample, the zone statistics, both classifiers, the motion
gate and the region agreement, before the vote loop). Host time under the
profiler: compare it from run to run, not with ``enqueue_ms``."""

from benchmark.metrics._spans import host_ms


def read(ctx):
    return host_ms(ctx, "camkifu.scan_streams.classify")
