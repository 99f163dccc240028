"""Vote scan: the mean host time a batch inside the program's
``camkifu.scan_streams.votes`` span in the profiled stretch, in ms (the
Python loop over frames and its final stacks). Host time under the
profiler: compare it from run to run, not with ``enqueue_ms``."""

from benchmark.metrics._spans import host_ms


def read(ctx):
    return host_ms(ctx, "camkifu.scan_streams.votes")
