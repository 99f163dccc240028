"""The readers of the program's spans (``metrics/_spans.py``:
``track_host_ms``, ``classify_host_ms``, ``votes_host_ms``,
``entry_idle_ms``) on hand-made traces whose every value is worked out by
hand, on traces that give them nothing to read, and on the spans of a
real CPU profile of the program sorted by ``run._events``."""

from __future__ import annotations

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark import run
from benchmark.metrics import classify_host_ms, entry_idle_ms, \
    track_host_ms, votes_host_ms

READERS = (track_host_ms, classify_host_ms, votes_host_ms, entry_idle_ms)


def _ctx(host_ops, kernels, batches=2, span_us=(100.0, 300.0)):
    ctx = run.TraceContext(None, None, None, "a card")
    ctx.host_ops, ctx.kernels = host_ops, kernels
    ctx.span_us = span_us
    ctx.window_s = (span_us[1] - span_us[0]) * 1e-6
    ctx.batches = list(range(batches))
    return ctx


def _handheld_ops():
    """Two batches in a stretch [100, 300] µs, and a third entry call
    after it. Batch 1: entry [110, 170], tracker [112, 130], classify
    [130, 150], votes [150, 168]; batch 2: entry [200, 280], tracker
    [202, 230], classify [230, 250], votes [250, 279]."""
    return [
        ("camkifu.multistream_track_read", 110.0, 170.0),
        ("camkifu.rectify_track_streams", 112.0, 130.0),
        ("aten::mul", 113.0, 114.0),
        ("camkifu.scan_streams.classify", 130.0, 150.0),
        ("camkifu.scan_streams.votes", 150.0, 168.0),
        ("aten::copy_", 172.0, 190.0),
        ("camkifu.multistream_track_read", 200.0, 280.0),
        ("camkifu.rectify_track_streams", 202.0, 230.0),
        ("camkifu.scan_streams.classify", 230.0, 250.0),
        ("camkifu.scan_streams.votes", 250.0, 279.0),
        # Outside the stretch: not counted.
        ("camkifu.multistream_track_read", 320.0, 390.0),
        ("camkifu.rectify_track_streams", 322.0, 340.0),
    ]


#: Busy [100, 120], [140, 180] (past the first entry's end: the idle gap
#: [180, 210] straddles the second entry's start), [210, 260], and a
#: kernel from 290 that runs past the stretch's end.
KERNELS = [("k", 100.0, 120.0), ("k", 140.0, 180.0), ("k", 210.0, 260.0),
           ("k", 290.0, 350.0)]


def test_host_time_a_batch_inside_each_span():
    ctx = _ctx(_handheld_ops(), KERNELS)
    assert track_host_ms.read(ctx) == pytest.approx(1e-3 * (18 + 28) / 2)
    assert classify_host_ms.read(ctx) == pytest.approx(1e-3 * (20 + 20) / 2)
    assert votes_host_ms.read(ctx) == pytest.approx(1e-3 * (18 + 29) / 2)


def test_device_idle_inside_the_entry_spans():
    """Entry 1 [110, 170]: idle [120, 140] = 20. Entry 2 [200, 280]: idle
    [200, 210] (the straddling gap's part inside it) and [260, 280] = 30.
    The loop's idle [180, 200] and [280, 290] lie outside every entry."""
    ctx = _ctx(_handheld_ops(), KERNELS)
    assert entry_idle_ms.read(ctx) == pytest.approx(1e-3 * (20 + 30) / 2)
    # The kernel past the stretch counts only inside it; clipped by
    # hand, the same value.
    clipped = KERNELS[:3] + [("k", 290.0, 300.0)]
    assert entry_idle_ms.read(_ctx(_handheld_ops(), clipped)) \
        == pytest.approx(entry_idle_ms.read(ctx))


def test_a_fixed_trace_has_no_tracker_span():
    ops = [op for op in _handheld_ops()
           if op[0] != "camkifu.rectify_track_streams"]
    ops = [("camkifu.multistream_read_meta", *op[1:])
           if op[0] == "camkifu.multistream_track_read" else op for op in ops]
    ctx = _ctx(ops, KERNELS)
    assert track_host_ms.read(ctx) is None
    assert classify_host_ms.read(ctx) == pytest.approx(0.020)
    assert votes_host_ms.read(ctx) == pytest.approx(0.0235)
    assert entry_idle_ms.read(ctx) == pytest.approx(0.025)


def test_nothing_to_read_without_the_programs_spans():
    """The parent's trace (aten ops alone), a stretch with no device
    operation (a run off the card) and an empty context."""
    ops = [op for op in _handheld_ops() if not op[0].startswith("camkifu.")]
    for ctx in (_ctx(ops, KERNELS), _ctx(_handheld_ops(), []),
                _ctx([], [], batches=0, span_us=(0.0, 0.0))):
        assert [r.read(ctx) for r in READERS] == [None] * 4


@pytest.mark.parametrize("batches", [1, 3])
def test_nothing_to_read_where_the_entry_spans_miss_the_batches(batches):
    ctx = _ctx(_handheld_ops(), KERNELS, batches=batches)
    assert [r.read(ctx) for r in READERS] == [None] * 4


def test_the_programs_own_spans_through_the_events_sort():
    """Two calls of the fixed cell's entry at a tiny size under a CPU
    profiler: ``run._events`` keeps the spans among the host ops (none
    taken for a runtime call), and the readers find them; a made-up
    kernel stands in for the card. The children's host time a batch is
    within the entry span's."""
    from camkifu_tpu_torch.parallel import mesh

    torch.manual_seed(0)
    frames = torch.randint(0, 256, (2, 2, 120, 216, 3), dtype=torch.uint8)
    corners = torch.tensor([[40.0, 10.0], [170.0, 10.0], [180.0, 110.0],
                            [30.0, 110.0]]).expand(2, 4, 2)
    states = mesh.multistream_init_states(2, 9, 16, device="cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(2):
            states = mesh.multistream_read_meta(states, frames, corners, 9,
                                                16)[0]
    ctx = _ctx([], [], batches=2)
    ctx.window_s = 60.0
    run._events(prof, ctx)
    assert not any(n.startswith("camkifu.") for n in ctx.runtime)
    t0 = ctx.span_us[0]
    ctx.kernels = [("k", t0, t0 + 1.0)]
    entry = [e - s for n, s, e in ctx.host_ops
             if n == "camkifu.multistream_read_meta"]
    assert len(entry) == 2
    classify, votes = classify_host_ms.read(ctx), votes_host_ms.read(ctx)
    assert classify > 0 and votes > 0
    assert classify + votes <= 1e-3 * sum(entry) / 2
    assert track_host_ms.read(ctx) is None
    assert 0 < entry_idle_ms.read(ctx) <= 1e-3 * sum(entry) / 2
