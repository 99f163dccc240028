"""Detection's spans on the re-detecting stream path: under a CPU
``torch.profiler`` session each ``multistream_track_read(...,
redetect=True)`` call holds one ``camkifu.detect_batch`` inside its entry
span, and inside that one ``.coarse`` and one ``.refine``, which holds
one ``.shared`` for the chunk whose gate holds; a chunk forced to fail
its gate gives no ``.shared`` and one ``.refine_one`` a frame, inside
``.refine``; a call without ``redetect`` holds none of them. Two
streams × 2 frames of the benchmark generator's 360×640 handheld boards,
the Hough votes of each frame's first ``HOUGH_POINTS`` edge points alone
(the plain accumulator takes seconds a frame on the CPU; no span depends
on it)."""

import functools
import json
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark.traffic import generator
from camkifu_tpu_torch.board import bf_auto
from camkifu_tpu_torch.parallel import mesh

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
HW = (360, 640)
N, B = 2, 2
ENTRY = "camkifu.multistream_track_read"
DETECT = "camkifu.detect_batch"
COARSE = "camkifu.detect_batch.coarse"
REFINE = "camkifu.detect_batch.refine"
SHARED = "camkifu.detect_batch.shared"
ONE = "camkifu.detect_batch.refine_one"
HOUGH_POINTS = 512


@pytest.fixture(autouse=True)
def _few_hough_points(monkeypatch):
    real = bf_auto.hough_accumulate
    monkeypatch.setattr(
        bf_auto, "hough_accumulate",
        lambda pts, wts, rho_max: real(pts[:, :HOUGH_POINTS].contiguous(),
                                       wts[:, :HOUGH_POINTS].contiguous(),
                                       rho_max))


@functools.lru_cache(maxsize=1)
def _inputs():
    cfg = json.loads((ROOT / "benchmark/configs/"
                      "handheld19_reanchor_1080p.json").read_text())
    mix = json.loads((ROOT / "benchmark/traffic/streams.json")
                     .read_text())
    cfg["camera"]["drift_px"] = [d * HW[0] / 1080.0
                                 for d in cfg["camera"]["drift_px"]]
    cfg.update(frame_hw=list(HW), streams=N)
    mix.update(pool_batches=1, batch_frames=B)
    inputs = generator.make_inputs(cfg, mix, 2 ** 33 + 5, "cpu")
    return inputs["pool"][0], inputs["corners"][0, :, 0]


def _spans(redetect: bool):
    """One entry call under a CPU profiler → [(name, start, end, names of
    the enclosing spans)] of its ``camkifu.`` host events."""
    frames, seeds = _inputs()
    states = mesh.multistream_init_states(N, 19, 16, device="cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        mesh.multistream_track_read(states, frames, seeds, 19, 16,
                                    redetect=redetect)
    out = []
    for e in prof.events():
        if e.name.startswith("camkifu."):
            up, parent = [], e.cpu_parent
            while parent is not None:
                up.append(parent.name)
                parent = parent.cpu_parent
            out.append((e.name, e.time_range.start, e.time_range.end, up))
    return out


def _count(spans, name):
    return sum(n == name for n, _, _, _ in spans)


def _inside(spans, name, outer):
    """Every ``name`` span within an ``outer`` span in time and under it
    on the thread."""
    boxes = [(s, e) for n, s, e, _ in spans if n == outer]
    return all(any(s0 <= s and e <= e0 for s0, e0 in boxes) and outer in up
               for n, s, e, up in spans if n == name)


@functools.lru_cache(maxsize=None)
def _redetecting():
    return _spans(True)


def test_one_detection_a_call_inside_the_entry_span():
    spans = _redetecting()
    assert _count(spans, ENTRY) == 1
    assert [_count(spans, n) for n in (DETECT, COARSE, REFINE)] == [1, 1, 1]
    assert _inside(spans, DETECT, ENTRY)
    assert _inside(spans, COARSE, DETECT) and _inside(spans, REFINE, DETECT)
    # The coarse stage ends before the refine starts.
    coarse = next((s, e) for n, s, e, _ in spans if n == COARSE)
    refine = next((s, e) for n, s, e, _ in spans if n == REFINE)
    assert coarse[0] < coarse[1] <= refine[0]
    # These boards validate on their shared canvas.
    assert _count(spans, SHARED) == 1 and _inside(spans, SHARED, REFINE)
    assert _count(spans, ONE) == 0


def test_a_failed_chunk_gives_one_refine_one_a_frame(monkeypatch):
    monkeypatch.setattr(bf_auto, "SHARED_REFINE_SPREAD", -1.0)
    spans = _spans(True)
    assert [_count(spans, n) for n in (DETECT, COARSE, REFINE)] == [1, 1, 1]
    assert _count(spans, ONE) == N
    assert _inside(spans, ONE, REFINE)
    # The gate fails before the shared refine: none runs.
    assert _count(spans, SHARED) == 0


def test_without_redetect_no_detection_span():
    spans = _spans(False)
    assert _count(spans, ENTRY) == 1
    assert not {n for n, _, _, _ in spans} & {DETECT, COARSE, REFINE, ONE}


@pytest.mark.parametrize("name", [DETECT, COARSE, REFINE, ONE])
def test_each_span_is_named_in_the_package(name):
    text = (ROOT / "camkifu_tpu_torch/board/bf_auto.py").read_text()
    assert f'span("{name}")' in text
