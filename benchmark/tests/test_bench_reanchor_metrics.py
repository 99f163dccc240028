"""The readers of the re-detecting cell (``detect_host_ms``,
``detect_fallback_frames``, ``detect_roofline_pct``) on hand-made traces
whose every value is worked out by hand, and on traces that give them
nothing to read (the parent's program, which has no detection span; a
run off the card)."""

from __future__ import annotations

import pytest

from benchmark import run
from benchmark.metrics import _detect_work, detect_fallback_frames, \
    detect_host_ms, detect_roofline_pct

CARD = "NVIDIA H100 80GB HBM3"


def _ctx(host_ops, kernels, batches=2, span_us=(100.0, 300.0),
         device=CARD, streams=8, period=1):
    """A stretch of pool batches 0 … ``batches`` − 1, re-detecting every
    ``period``."""
    ctx = run.TraceContext({"streams": streams,
                            "reanchor": {"period_batches": period}},
                           None, None, device)
    ctx.host_ops, ctx.kernels = host_ops, kernels
    ctx.span_us = span_us
    ctx.window_s = (span_us[1] - span_us[0]) * 1e-6
    ctx.batches = list(range(batches))
    return ctx


def _ops(fallbacks=(0, 3)):
    """Two batches in [100, 300] µs and a third after it. Batch 1: entry
    [110, 170], detection [111, 141] (coarse [111, 120], refine
    [120, 141]); batch 2: entry [200, 280], detection [201, 251], with
    ``fallbacks`` frames refined alone in each batch's refine."""
    ops = [("camkifu.multistream_track_read", 110.0, 170.0),
           ("camkifu.detect_batch", 111.0, 141.0),
           ("camkifu.detect_batch.coarse", 111.0, 120.0),
           ("camkifu.detect_batch.refine", 120.0, 141.0),
           ("camkifu.rectify_track_streams", 141.0, 160.0),
           ("camkifu.multistream_track_read", 200.0, 280.0),
           ("camkifu.detect_batch", 201.0, 251.0),
           ("camkifu.detect_batch.coarse", 201.0, 210.0),
           ("camkifu.detect_batch.refine", 210.0, 251.0),
           # Outside the stretch: not counted.
           ("camkifu.multistream_track_read", 320.0, 390.0),
           ("camkifu.detect_batch", 321.0, 350.0),
           ("camkifu.detect_batch.refine_one", 330.0, 340.0)]
    for lo, n in zip((120.0, 210.0), fallbacks):
        ops += [("camkifu.detect_batch.refine_one", lo + i, lo + i + 0.5)
                for i in range(n)]
    return ops


KERNELS = [("void edge_kernel<4, 2>(float const*, float*)", 112.0, 113.0),
           ("outer_nms_kernel(float const*, float*, int, int)", 113.0,
            113.5),
           ("void hysteresis_kernel<true>(float const*, float*)", 114.0,
            115.5),
           ("hough_kernel(float const*, float const*)", 116.0, 117.0),
           ("void hough_sum<long long>(long long const*)", 117.0, 117.5),
           ("void warp_kernel<3>(unsigned char const*)", 142.0, 150.0),
           ("void edge_kernel<4, 2>(float const*, float*)", 202.0, 203.0),
           ("outer_nms_kernel(float const*, float*, int, int)", 203.0,
            203.5),
           ("void hysteresis_kernel<true>(float const*, float*)", 204.0,
            205.5),
           ("hough_kernel(float const*, float const*)", 206.0, 207.0),
           ("void hough_sum<long long>(long long const*)", 207.0, 207.5)]


def test_detection_host_time_a_batch():
    assert detect_host_ms.read(_ctx(_ops(), KERNELS)) \
        == pytest.approx(1e-3 * (30 + 50) / 2)


@pytest.mark.parametrize("fallbacks,want", [((0, 0), 0.0), ((0, 3), 1.5),
                                            ((8, 8), 8.0)])
def test_frames_refined_alone_a_batch(fallbacks, want):
    assert detect_fallback_frames.read(_ctx(_ops(fallbacks), KERNELS)) \
        == pytest.approx(want)


def test_detection_share_of_its_roofline():
    """Each batch's five detection launches take 1 + 0.5 + 1.5 + 1 + 0.5
    = 4.5 µs; the warp's launch is not detection's."""
    ctx = _ctx(_ops(), KERNELS)
    need = 2 * (_detect_work.edge_s(8) + _detect_work.hysteresis_s(8)
                + _detect_work.hough_s(8))
    assert detect_roofline_pct.read(ctx) \
        == pytest.approx(100.0 * need / (2 * 4.5e-6))


@pytest.mark.parametrize("batches,period,calls", [(16, 8, 2), (9, 8, 2),
                                                  (3, 2, 2), (2, 1, 2)])
def test_detection_work_counts_the_redetecting_batches(batches, period,
                                                       calls):
    """Only the pool batches at the period re-detect: the same two calls'
    launches, in stretches of more batches."""
    ctx = _ctx(_ops(), KERNELS, batches=batches, period=period)
    need = calls * _detect_work.detect_s(8)
    assert detect_roofline_pct.read(ctx) \
        == pytest.approx(100.0 * need / (2 * 4.5e-6))


def test_detection_work_from_the_shapes():
    """16 maps of 256² float32 read and written once: 8.39 MB at
    3.35 TB/s; 8 frames × 4,096 points × 128 θ × 12 operations at
    67 TFLOP/s."""
    px = 16 * 256 * 256
    assert _detect_work.edge_s(8) == pytest.approx(8 * px / 3.35e12)
    assert _detect_work.hysteresis_s(8) \
        == pytest.approx((8 * px + 128) / 3.35e12)
    assert _detect_work.hough_s(8) \
        == pytest.approx(12 * 128 * 8 * 4096 / 67e12)
    assert _detect_work.detect_s(8) == pytest.approx(
        _detect_work.edge_s(8) + _detect_work.hysteresis_s(8)
        + _detect_work.hough_s(8))


def test_nothing_to_read_without_detection():
    """The parent's program (entry spans, no detection span, no detection
    kernel), a run off the card, an unknown card and an empty stretch."""
    parent = [op for op in _ops() if not op[0].startswith(
        "camkifu.detect_batch")]
    tracker_only = [k for k in KERNELS if "warp_kernel" in k[0]]
    readers = (detect_host_ms, detect_fallback_frames, detect_roofline_pct)
    for ctx in (_ctx(parent, tracker_only), _ctx(_ops(), []),
                _ctx([], [], batches=0, span_us=(0.0, 0.0))):
        assert [r.read(ctx) for r in readers] == [None] * 3
    # No re-detecting batch in the stretch (pool batches 1–7 of 8), or a
    # configuration that never re-detects.
    assert detect_roofline_pct.read(_ctx(_ops(), KERNELS, batches=8,
                                         period=8)) is not None
    ctx = _ctx(_ops(), KERNELS)
    ctx.batches = list(range(1, 8))
    ctx.cfg["reanchor"]["period_batches"] = 8
    assert detect_roofline_pct.read(ctx) is None
    ctx.cfg = {"streams": 8}
    ctx.batches = [0, 1]
    assert detect_roofline_pct.read(ctx) is None
    assert detect_roofline_pct.read(_ctx(_ops(), KERNELS,
                                         device="a card")) is None


@pytest.mark.parametrize("batches", [1, 3])
def test_nothing_to_read_where_the_entry_spans_miss_the_batches(batches):
    ctx = _ctx(_ops(), KERNELS, batches=batches)
    assert detect_host_ms.read(ctx) is None
    assert detect_fallback_frames.read(ctx) is None
