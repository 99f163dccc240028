"""The frozen arithmetic of the per-layer metrics, on hand-computed
cases: the busy share, the launch count, the idle gaps, the bytes a
rectification needs, and each reader on a made-up trace."""

from __future__ import annotations

import types

import pytest
import torch

from benchmark.metrics import _busy, _bytes, device_idle_pct, \
    device_us_per_frame, enqueue_ms, launch_calls_per_frame, \
    step_roofline_pct, warp_roofline_pct
from benchmark.metrics._peaks import PEAKS

H100 = "NVIDIA H100 80GB HBM3"


def test_busy_union_overlaps_and_gaps():
    # [0, 4] ∪ [2, 6] ∪ [10, 11] ∪ [10.5, 10.75] = 6 + 1
    assert _busy.busy_union([(10, 11), (0, 4), (2, 6), (10.5, 10.75)]) == 7
    assert _busy.merged([(2, 6), (0, 4), (10, 11)]) == [[0, 6], [10, 11]]
    assert _busy.busy_union([]) == 0.0


def test_launch_calls_and_variants():
    names = ["cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
             "cudaGraphLaunch", "cudaLaunchKernel_v7000",
             "cudaMemcpyAsync", "cudaStreamSynchronize", "cudaEventRecord"]
    assert [_busy.is_launch(n) for n in names] == [True] * 5 + [False] * 3


def test_idle_gaps_by_host_op():
    device = [(0, 10), (20, 30)]
    host = [("outer", 0, 100), ("aten::where", 9, 14),
            ("bench.wait", 31, 40)]
    # Gap [10, 20] begins inside aten::where (the latest-starting op that
    # runs at 10); gap [30, 40] begins inside "outer" alone (bench.wait
    # starts after it began).
    gaps = _busy.idle_gaps(device, host, 0, 40)
    assert gaps == [["aten::where", 10], ["outer", 10]]
    assert _busy.idle_gaps([], [], 0, 5) == [["host idle", 5]]


def test_top_ops_sums_by_name():
    ev = [("k1", 0, 2), ("k2", 2, 3), ("k1", 5, 6)]
    assert _busy.top_ops(ev) == [["k1", 3], ["k2", 1]]


def _one_to_one(size: int, x0: float = 10.5, y0: float = 20.5):
    """Corners that map the canonical image onto the frame pixel for
    pixel: canonical (u, v) lands on (x0 + u, y0 + v), half-way between
    two pixels, so float32 rounding moves no tap."""
    lo, hi = 7.5, size - 8.5                # zone 16: the corner centres
    return torch.tensor([[[x0 + lo, y0 + lo], [x0 + hi, y0 + lo],
                          [x0 + hi, y0 + hi], [x0 + lo, y0 + hi]]])


def test_tap_pixels_one_to_one():
    """A one-to-one map: each output pixel's taps are the pixel at its
    floor and the next one right and down, so an S² image reads (S+1)²
    distinct pixels."""
    g, zone = 3, 16
    s = g * zone
    taps = _bytes.tap_pixels(_one_to_one(s), torch.zeros(1), (100, 100),
                             g, zone)
    assert int(taps[0]) == (s + 1) ** 2
    assert _bytes.warp_bytes(taps, g, zone) == (s + 1) ** 2 * 3 \
        + s * s * 3 * 4
    assert _bytes.step_bytes(taps, g) == (s + 1) ** 2 * 3 + g * g


def test_tap_pixels_clamped_at_the_edge():
    """Taps past the frame clamp onto its edge pixels: a map that puts
    the image's last rows and columns outside the frame reads fewer."""
    g, zone = 3, 16
    s = g * zone
    taps = _bytes.tap_pixels(_one_to_one(s, 60.5, 60.5), torch.zeros(1),
                             (100, 100), g, zone)
    assert int(taps[0]) == 40 * 40


def _ctx(**kw):
    base = dict(cfg={"gsize": 3, "zone": 16}, device_name=H100, kernels=[],
                runtime=[], window_s=0.0, frames=0, enqueue_s=[],
                batches=[])
    base.update(kw)
    return types.SimpleNamespace(**base)


def test_readers_on_a_made_up_trace():
    s = 48
    taps = _bytes.tap_pixels(_one_to_one(s), torch.zeros(1), (100, 100), 3,
                             16).repeat(4)
    kernels = [("void warp_kernel<3, false>(...)", 0.0, 2.0),
               ("aten::something", 1.0, 5.0), ("Memcpy DtoH", 8.0, 9.0)]
    ctx = _ctx(kernels=kernels, window_s=10e-6, frames=4, batches=[0],
               runtime=["cudaLaunchKernel"] * 6 + ["cudaMemcpyAsync"],
               enqueue_s=[0.010, 0.020])
    ctx.taps = lambda r: taps
    assert device_idle_pct.read(ctx) == pytest.approx(100 * (1 - 6 / 10))
    assert device_us_per_frame.read(ctx) == pytest.approx(6 / 4)
    assert launch_calls_per_frame.read(ctx) == 1.5
    assert enqueue_ms.read(ctx) == pytest.approx(15.0)
    peak = PEAKS[H100]["hbm_bytes_per_s"]
    need = _bytes.warp_bytes(taps, 3, 16)
    assert warp_roofline_pct.read(ctx) == pytest.approx(
        100 * need / peak / 2e-6)
    assert step_roofline_pct.read(ctx) == pytest.approx(
        100 * _bytes.step_bytes(taps, 3) / peak / 10e-6)


def test_readers_return_nothing_without_their_source():
    ctx = _ctx(device_name="some other card", kernels=[("x", 0, 1)],
               window_s=1.0, frames=1, batches=[0])
    ctx.taps = lambda r: torch.ones(1, dtype=torch.long)
    assert warp_roofline_pct.read(ctx) is None       # no warp launched
    assert step_roofline_pct.read(ctx) is None       # no peak for the card
    empty = _ctx()
    for reader in (device_idle_pct, device_us_per_frame,
                   launch_calls_per_frame, enqueue_ms):
        assert reader.read(empty) is None
