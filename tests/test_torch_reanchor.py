"""Handheld streams that find their boards again:
``parallel.mesh.multistream_track_read(..., redetect=True)`` over two
batches with states carried, against the benchmark's plain reference of
the same path (``benchmark/reference/streams_reanchor.py``: detection,
tracker and vote scan written out in plain PyTorch) under the checks of
the configuration ``handheld19_reanchor_1080p``, on frames that the
benchmark's generator renders on the CPU at 360×640. One stream's first
frame of the second batch is black (a covered lens): it keeps its carried
seed in both.
Without ``redetect`` the call is today's, bitwise; with lenses it
refuses."""

import functools
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark import checks
from benchmark.reference import streams_reanchor, tracker as ref_tracker
from benchmark.traffic import generator
from camkifu_tpu_torch.board import bf_auto
from camkifu_tpu_torch.ops.lens import make_lens
from camkifu_tpu_torch.parallel import mesh
from camkifu_tpu_torch.stone import sf_meta
from camkifu_tpu_torch.utils import still

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
#: The smallest frames the CPU detection tests use; the reference's
#: tracker takes whole chunks of 16 frames.
HW = (360, 640)
N, B = 2, 16
SEED = 2 ** 33 + 21
#: tests/test_bf_auto.py's 11 px at 720p, at 360p.
TOL_PX = 5.5
#: The stream whose first frame of batch 1 is black (no board in view).
BLANK = 1


def _cfg_mix():
    cfg = json.loads((ROOT / "benchmark/configs/"
                      "handheld19_reanchor_1080p.json").read_text())
    mix = json.loads((ROOT / "benchmark/traffic/streams.json")
                     .read_text())
    scale = HW[0] / cfg["frame_hw"][0]
    cfg.update(frame_hw=list(HW), streams=N)
    cfg["camera"]["drift_px"] = [d * scale for d in cfg["camera"]["drift_px"]]
    mix.update(pool_batches=2, batch_frames=B)
    # Both batches re-detect, in the program and the reference.
    cfg["reanchor"]["period_batches"] = 1
    return cfg, mix


class _Recorder:
    """Records the seeds each call of ``fn`` tracks from (its second
    argument)."""

    def __init__(self, fn):
        self.fn, self.seeds = fn, []

    def __call__(self, frames, seeds, *args, **kwargs):
        self.seeds.append(seeds.clone())
        return self.fn(frames, seeds, *args, **kwargs)


@functools.lru_cache(maxsize=1)
def _runs():
    """(config, program outputs of both batches, the seeds each batch was
    tracked from, the reference's pairs, the reference's tracked-from
    seeds, the rendered corners)."""
    cfg, mix = _cfg_mix()
    inputs = generator.make_inputs(cfg, mix, SEED, "cpu")
    inputs["pool"][1, BLANK, 0] = 0
    anchor = inputs["corners"][0, :, 0].clone()
    prog_rec = _Recorder(mesh.rectify_track_streams)
    ref_rec = _Recorder(ref_tracker.rectify_track)
    mesh.rectify_track_streams = prog_rec
    ref_tracker.rectify_track = ref_rec
    try:
        states = mesh.multistream_init_states(N, cfg["gsize"], cfg["zone"],
                                              device="cpu")
        seeds, outs = anchor, []
        for k in range(2):
            (states, labels, conf, agitation, corners, _, _, seeds,
             detected, scores) = mesh.multistream_track_read(
                states, inputs["pool"][k], seeds, cfg["gsize"], cfg["zone"],
                redetect=True)
            outs.append({"labels": labels, "conf": conf, "corners": corners,
                         "seeds": seeds, "detected": detected,
                         "scores": scores,
                         **{f"state_{f}": v for f, v in
                            zip(states._fields, states)}})
        pairs = checks.pairs(streams_reanchor, cfg, inputs, anchor, outs, [])
    finally:
        mesh.rectify_track_streams = prog_rec.fn
        ref_tracker.rectify_track = ref_rec.fn
    return cfg, outs, prog_rec.seeds, pairs, ref_rec.seeds, inputs["corners"]


def test_redetecting_streams_match_the_reference():
    cfg, _, _, pairs, _, _ = _runs()
    assert len(pairs) == 2
    limits = {c["name"]: c["limit"] for c in cfg["checks"]}
    # The blank frame's detection is no board (compared below); the
    # others under every check of the configuration.
    keep = [i for i in range(N) if i != BLANK]
    for b, (got, want) in enumerate(pairs):
        got = dict(got)
        want = dict(want)
        if b == 1:
            for d in (got, want):
                d["detected"] = d["detected"][keep]
        values = checks.numbers(cfg["checks"], [(got, want)])
        assert all(values[k] <= limits[k] for k in limits), (b, values)
    got, want = pairs[1]
    assert torch.equal(torch.isfinite(got["detected"][BLANK]),
                       torch.isfinite(want["detected"][BLANK]))


def test_blank_frame_keeps_its_carried_seed():
    _, outs, prog_seeds, pairs, ref_seeds, _ = _runs()
    for side, tracked_from, out in (
            ("program", prog_seeds, [o for o in outs]),
            ("reference", ref_seeds, [w for _, w in pairs])):
        assert len(tracked_from) == 2, side
        for k in range(2):
            sc, det = out[k]["scores"], out[k]["detected"]
            for i in range(N):
                if k == 1 and i == BLANK:
                    # No board: the seed carried out of batch 0.
                    assert float(sc[i]) < bf_auto.DETECT_MIN_SCORE, side
                    assert torch.equal(tracked_from[1][i],
                                       out[0]["seeds"][i]), side
                else:
                    assert float(sc[i]) >= bf_auto.DETECT_MIN_SCORE, side
                    assert torch.equal(tracked_from[k][i], det[i]), side


def test_redetect_found_every_board():
    """Detection lands within ``TOL_PX`` of the rendered corners."""
    _, outs, _, _, _, truth = _runs()
    for k in range(2):
        for i in range(N):
            if k == 1 and i == BLANK:
                continue
            gap = torch.linalg.vector_norm(
                outs[k]["detected"][i] - truth[k, i, 0], dim=-1).max()
            assert float(gap) < TOL_PX, (k, i, float(gap))


@pytest.mark.parametrize("case", ["taken", "at_the_limit", "under_it",
                                  "not_finite"])
def test_accept_detections_is_detects_rule(case):
    """A detection replaces its stream's seed where its corners are finite
    and it scores at least ``DETECT_MIN_SCORE``, as the reference's
    ``redetect_seeds`` takes it."""
    from benchmark.reference import detect as ref_detect

    lo = bf_auto.DETECT_MIN_SCORE
    score, bad = {"taken": (0.5, False), "at_the_limit": (lo, False),
                  "under_it": (float(torch.tensor(lo).nextafter(
                      torch.tensor(0.0))), False),
                  "not_finite": (0.5, True)}[case]
    detected = torch.arange(16, dtype=torch.float32).reshape(2, 4, 2)
    if bad:
        detected[1, 2, 0] = float("nan")
    scores = torch.tensor([0.5, score])
    seeds = -torch.ones(2, 4, 2)
    got = bf_auto.accept_detections(detected, scores, seeds)
    assert torch.equal(got, ref_detect.redetect_seeds(detected, scores,
                                                      seeds))
    assert torch.equal(got[0], detected[0])
    taken = case in ("taken", "at_the_limit")
    assert torch.equal(got[1], detected[1] if taken else seeds[1])


def test_redetect_refuses_lenses():
    frames = torch.zeros((N, 2) + HW + (3,), dtype=torch.uint8)
    seeds = torch.zeros((N, 4, 2))
    states = mesh.multistream_init_states(N, 19, 16, device="cpu")
    lens = make_lens(0.05, HW)
    with pytest.raises(ValueError, match="lenses"):
        mesh.multistream_track_read(states, frames, seeds, lenses=lens,
                                    redetect=True)
    with pytest.raises(ValueError, match="lenses"):
        mesh.multistream_track_read(states, frames, seeds, lenses=lens,
                                    mesh=mesh.make_mesh(["cpu"] * 2),
                                    redetect=True)


def test_without_redetect_the_call_is_todays_bitwise():
    """A 9×9 board at 120×216, 2 streams × 2 frames: the entry call with
    ``redetect`` left off and set False, against its body as it was (the
    tracker, then the vote scan), output by output."""
    hw, g, zone = (120, 216), 9, 16
    corners = still.default_corners(hw)
    labels = np.zeros((g, g), np.int8)
    labels[2, 3], labels[6, 5] = 1, 2
    frames = torch.from_numpy(np.stack([np.stack([
        still.render_still(labels, hw, seed=10 * s + k, corners=corners)[0]
        for k in range(2)]) for s in range(N)]))
    seeds = torch.from_numpy(np.stack([corners] * N).astype(np.float32))
    states = mesh.multistream_init_states(N, g, zone, device="cpu")
    canon, c, sharp, align, new_seeds = bf_auto.rectify_track_streams(
        frames, seeds, gsize=g, zone=zone)
    new_states, lab, conf, agitation = sf_meta.scan_streams(states, canon,
                                                            g, zone)
    today = (*new_states, lab, conf, agitation, c, sharp, align, new_seeds)
    for kwargs in ({}, {"redetect": False}):
        out = mesh.multistream_track_read(states, frames, seeds, g, zone,
                                          **kwargs)
        assert len(out) == 8
        flat = (*out[0], *out[1:])
        assert len(flat) == len(today)
        assert all(torch.equal(a, b) for a, b in zip(flat, today))
