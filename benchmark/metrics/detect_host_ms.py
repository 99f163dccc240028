"""Detection: the mean host time a batch inside the program's
``camkifu.detect_batch`` span in the profiled stretch, in ms (stage 1's
launches, the shared-canvas refines, the verdict fetch and any frame
refined alone). Host time under the profiler: compare it from run to
run, not with ``enqueue_ms``."""

from benchmark.metrics._spans import host_ms


def read(ctx):
    return host_ms(ctx, "camkifu.detect_batch")
