"""Kernels: detection's share of its roofline, in %: the least time of
the edge, hysteresis and Hough launches of the profiled batches, each at
its bound (``_detect_work``: one ``detect_batch`` call of every stream in
each batch that re-detects, a pool batch whose index is a multiple of the
configuration's ``reanchor.period_batches``), over the summed device time
of those launches (the edge kernel and its outer lines' NMS, the
hysteresis kernel, the Hough kernel and its split sum)."""

from benchmark.metrics import _detect_work
from benchmark.metrics._peaks import hbm_bytes_per_s

#: The kernels' names as the device trace gives them (demangled).
KERNELS = ("edge_kernel", "outer_nms_kernel", "hysteresis_kernel",
           "hough_kernel", "hough_sum")


def _is_detection(name: str) -> bool:
    return any(f"{k}<" in name or f"{k}(" in name for k in KERNELS)


def read(ctx):
    if hbm_bytes_per_s(ctx.device_name) is None or not ctx.batches \
            or "reanchor" not in ctx.cfg:
        return None
    t = sum(e - s for name, s, e in ctx.kernels
            if _is_detection(name)) * 1e-6
    if t <= 0:
        return None
    period = ctx.cfg["reanchor"]["period_batches"]
    calls = sum(k % period == 0 for k in ctx.batches)
    if calls == 0:
        return None
    need = calls * _detect_work.detect_s(ctx.cfg["streams"])
    return 100.0 * need / t
