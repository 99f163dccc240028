"""Kernels: the rectification warp's share of its roofline, in %: the
least time of the bytes the profiled batches' rectification needs
(``_bytes.warp_bytes``, from the true corners) at the card's peak
bandwidth, over the summed device time of the warp kernel's launches."""

from benchmark.metrics import _bytes
from benchmark.metrics._peaks import hbm_bytes_per_s

KERNEL = "warp_kernel<"


def read(ctx):
    peak = hbm_bytes_per_s(ctx.device_name)
    t = sum(e - s for name, s, e in ctx.kernels if KERNEL in name) * 1e-6
    if peak is None or t <= 0:
        return None
    cfg = ctx.cfg
    need = sum(_bytes.warp_bytes(ctx.taps(r), cfg["gsize"], cfg["zone"])
               for r in ctx.batches)
    return 100.0 * need / peak / t
