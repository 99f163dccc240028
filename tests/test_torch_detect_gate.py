"""Detection routes before it refines (``bf_auto._detect_batch_routed``):
every chunk's stage-1 gate (``_shared_gate``) is read first, and only a
chunk that passes it is refined on its shared canvas (``_shared_refine``).
``detect_batch`` against the route that refines every chunk first,
spelled out here (``_chunked_route``, then each chunk's shared-canvas
corners where its full verdict holds and its frames refined alone where
it fails, or every frame refined alone where none holds): the corners
bit for bit, the stage-1 scores, and one ``_refine_shared_batch`` call
and one ``camkifu.detect_batch.shared`` span, inside
``camkifu.detect_batch.refine``, a chunk whose gate holds. Four batches
at 360×640:

- ``reanchor``: each stream's first frame at ``handheld19.reanchor``'s
  second re-detection (pool batch 8), rendered by the benchmark's
  generator with the sway scaled to the frame: the stage-1 quads spread
  past the gate and some scores fall below it, so no shared refine runs;
- ``fixed``: 16 fixed cameras on one board at the default corners (the
  same frame), two chunks of 8: both pass;
- ``drift``: ``test_torch_detect_route.py``'s drifting batch, one chunk
  of 4: it passes;
- ``mixed``: ``test_torch_detect_merge.py``'s batch in chunks of 2, the
  second holding a saturated board (score ≤ 0.55): one shared refine.

Stage 1 runs once for the file's 14 distinct frames (the plain Hough
takes seconds a frame on the CPU); ``detect_batch`` is handed its
outputs."""

import functools
import json
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark.traffic import generator
from camkifu_tpu.utils import synth
from camkifu_tpu_torch.board import bf_auto

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
HW = (360, 640)
RES = 256
#: The seed of the re-anchor batch, and its frame: pool batch 8's first.
SEED = 832043696
FRAME = 128
SHARED = "camkifu.detect_batch.shared"
REFINE = "camkifu.detect_batch.refine"


def _labels(n, seed):
    labels = np.zeros((19, 19), np.int8)
    idx = np.random.default_rng(seed).choice(361, n, replace=False)
    labels.flat[idx[::2]] = 1
    labels.flat[idx[1::2]] = 2
    return labels


def _reanchor_frames() -> torch.Tensor:
    """(8, H, W, 3) uint8: the benchmark generator's boards and pinhole
    corners of the re-anchor cell at ``FRAME``, one noise draw."""
    cfg = json.loads((ROOT / "benchmark/configs/"
                      "handheld19_reanchor_1080p.json").read_text())
    mix = json.loads((ROOT / "benchmark/traffic/streams.json").read_text())
    cfg["camera"]["drift_px"] = [d * HW[0] / cfg["frame_hw"][0]
                                 for d in cfg["camera"]["drift_px"]]
    cfg.update(frame_hw=list(HW))
    plan = generator.stream_plan(cfg, mix, SEED)
    clean = generator.render_clean(
        torch.as_tensor(np.stack([p["boards"][FRAME] for p in plan])),
        np.stack([p["pinhole"][FRAME] for p in plan]),
        generator.pinhole_grid(HW, 0.0, "cpu"), cfg["line_width"])
    return generator.add_noise(clean, cfg["noise_sigma"],
                               torch.Generator().manual_seed(SEED))


def _synth_frames() -> torch.Tensor:
    """(6, H, W, 3) uint8: the drifting batch's 4 frames, the saturated
    board, and a fixed camera's frame."""
    base = synth.default_corners(HW)
    frames = [synth.render_frame(
        _labels(40, 1), base + np.array([3.0 * np.sin(i / 2.0),
                                         3.0 * np.cos(i / 3.0)], np.float32),
        HW, seed=i)[0] for i in range(4)]
    frames.append(synth.render_frame(_labels(250, 3), None, HW, seed=3)[0])
    frames.append(synth.render_frame(_labels(40, 2), None, HW, seed=5)[0])
    return torch.from_numpy(np.stack(frames))


@functools.lru_cache(maxsize=1)
def _stage1():
    frames = torch.cat([_reanchor_frames(), _synth_frames()])
    return frames, bf_auto._detect_prepare_batch(frames, RES)


def _case(name: str):
    """(frames, (grays, quads, scores)) of the named batch."""
    rows = {"reanchor": list(range(8)), "fixed": [13] * 16,
            "drift": [8, 9, 10, 11], "mixed": [8, 9, 10, 12]}[name]
    frames, stage1 = _stage1()
    return frames[rows], tuple(t[rows] for t in stage1)


def _old_route(grays, quads, scores, chunk: int):
    """Every chunk refined on its shared canvas, then merged by the full
    verdicts → (corners, verdicts)."""
    corners, oks = bf_auto._chunked_route(grays, quads, scores, 19, chunk)

    def alone(lo, hi):
        return torch.stack([bf_auto._detect_refine(grays[i], quads[i],
                                                   scores[i], 19)
                            for i in range(lo, hi)])

    if not bool(oks.any()):
        return alone(0, grays.shape[0]), oks
    return torch.cat([corners[lo:lo + chunk] if ok else alone(lo, lo + chunk)
                      for lo, ok in zip(range(0, grays.shape[0], chunk),
                                        oks.tolist())]), oks


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous().view(torch.int32)


@pytest.mark.parametrize("name,chunk,gates,verdicts", [
    ("reanchor", 8, [False], [False]),
    ("fixed", 8, [True, True], [True, True]),
    ("drift", 8, [True], [True]),
    ("mixed", 2, [True, False], [True, False]),
])
def test_detect_batch_refines_only_the_chunks_that_pass_the_gate(
        monkeypatch, name, chunk, gates, verdicts):
    monkeypatch.setattr(bf_auto, "SHARED_CHUNK", chunk)
    frames, (grays, quads, scores) = _case(name)
    # A batch that is not a multiple of SHARED_CHUNK is one chunk.
    size = grays.shape[0] // len(gates)
    assert [bool(bf_auto._shared_gate(quads[lo:lo + size],
                                      scores[lo:lo + size], 19)[0])
            for lo in range(0, grays.shape[0], size)] == gates
    old, oks = _old_route(grays, quads, scores, size)
    assert oks.tolist() == verdicts

    calls = []
    real = bf_auto._refine_shared_batch

    def shared(*args):
        calls.append(args[0].shape[0])
        if not any(gates):
            raise AssertionError("a shared refine whose gate failed")
        return real(*args)

    monkeypatch.setattr(bf_auto, "_refine_shared_batch", shared)
    monkeypatch.setattr(bf_auto, "_detect_prepare_batch",
                        lambda f, res: (grays, quads, scores))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        corners, out_scores = bf_auto.detect_batch(frames)
    assert calls == [size] * sum(gates)
    spans = [e for e in prof.events() if e.name == SHARED]
    assert len(spans) == sum(gates)
    assert all(e.cpu_parent.name == REFINE for e in spans)
    assert out_scores is scores
    assert torch.equal(_bits(corners), _bits(old))
