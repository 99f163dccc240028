"""Streams entry: the card's idle time a batch while the host is inside
the program's entry span (``camkifu.multistream_read_meta`` or
``camkifu.multistream_track_read``) in the profiled stretch, in ms: the
time the card waited on the program's own host code, apart from the
loop's waits and copies between the entry calls. The stretch less the
union of the device intervals, intersected with the union of the entry
spans: with E the entry spans and K the device intervals, the length of
E ∪ K less that of K."""

from benchmark.metrics._busy import busy_union
from benchmark.metrics._spans import entries


def read(ctx):
    spans = entries(ctx)
    if spans is None:
        return None
    t0, t1 = ctx.span_us
    busy = [(max(s, t0), min(e, t1)) for _, s, e in ctx.kernels
            if min(e, t1) > max(s, t0)]
    return 1e-3 * (busy_union(spans + busy) - busy_union(busy)) / len(spans)
