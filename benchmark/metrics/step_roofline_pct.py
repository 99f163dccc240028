"""Device, whole step: the profiled stretch's share of the card's peak, in
%: the least time of the bytes its frames need at the least
(``_bytes.step_bytes``: the pixels under each board read once, the labels
written once) at the card's peak bandwidth, over the stretch's wall
time."""

from benchmark.metrics import _bytes
from benchmark.metrics._peaks import hbm_bytes_per_s


def read(ctx):
    peak = hbm_bytes_per_s(ctx.device_name)
    if peak is None or ctx.window_s <= 0 or not ctx.batches:
        return None
    need = sum(_bytes.step_bytes(ctx.taps(r), ctx.cfg["gsize"])
               for r in ctx.batches)
    return 100.0 * need / peak / ctx.window_s
