"""Arithmetic on the program's own spans in a profiled stretch: the host
events named ``camkifu.*`` (``camkifu_tpu_torch.utils.profiling.span``),
on the profiler's clock beside the kernels. The entry call of each batch
is one entry span, and every other span of that batch lies inside it."""

from __future__ import annotations

#: The entry call of a batch: fixed cameras, handheld ones.
ENTRY = ("camkifu.multistream_read_meta", "camkifu.multistream_track_read")


def in_stretch(ctx, names) -> list:
    """(start, end) of the host events named in ``names``, clipped to the
    stretch (``ctx.span_us``); those wholly outside it left out."""
    t0, t1 = ctx.span_us
    return [(max(s, t0), min(e, t1)) for n, s, e in ctx.host_ops
            if n in names and min(e, t1) > max(s, t0)]


def entries(ctx):
    """The entry spans of the stretch, one a batch, or None: where the
    stretch holds none (a program without spans), where it holds no
    device operation (a run off the card), or where their count is not
    the stretch's batch count."""
    spans = in_stretch(ctx, ENTRY)
    if not ctx.kernels or not spans or len(spans) != len(ctx.batches):
        return None
    return spans


def host_ms(ctx, name: str):
    """The mean host time a batch inside the spans named ``name``, in ms,
    or None where the stretch has none of them."""
    spans = entries(ctx)
    inner = in_stretch(ctx, (name,))
    if spans is None or not inner:
        return None
    return 1e-3 * sum(e - s for s, e in inner) / len(spans)

