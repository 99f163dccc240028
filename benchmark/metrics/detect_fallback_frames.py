"""Detection: frames a batch refined alone, outside a shared canvas (a
frame of a chunk that failed validation): the program's
``camkifu.detect_batch.refine_one`` spans in the profiled stretch over
its entry spans. 0 where every chunk validated; nothing where the
stretch holds no ``camkifu.detect_batch`` span."""

from benchmark.metrics._spans import entries, in_stretch


def read(ctx):
    spans = entries(ctx)
    if spans is None or not in_stretch(ctx, ("camkifu.detect_batch",)):
        return None
    return len(in_stretch(ctx, ("camkifu.detect_batch.refine_one",))) \
        / len(spans)
