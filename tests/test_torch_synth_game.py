"""The port's game renderer and move samplers against the reference's
(camkifu_tpu/utils/synth.py): the states ``render_game`` yields under every
timing hazard (flicker, white-balance drift, variable frame rate, removal
lag, the hand, a resting arm, a moving camera with rolling shutter) equal
the reference's, frame for frame; the samplers' moves and the gauntlet's
kifu equal; the gauntlet renders and its factory ends with the mp4 round
trip."""

import itertools

import numpy as np
import pytest
import torch

from camkifu_tpu.utils import synth as jsynth
from camkifu_tpu_torch.utils import synth

torch.set_num_threads(1)

#: Small frames: the states and the draws do not depend on the size.
HW = (96, 160)


def _moves_of(moves):
    return [(m.color, m.row, m.col) for m in moves]


def _cam(i):
    base = synth.default_corners(HW)
    th = np.deg2rad(0.2 * i)
    rot = np.array([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]],
                   np.float32)
    c0 = base.mean(axis=0)
    return (c0 + (base - c0) @ rot.T
            + np.float32([2.0 * np.sin(i / 5.0), 1.5 * np.cos(i / 7.0)])
            ).astype(np.float32)


GAMES = {
    "timing hazards": dict(frames_per_move=3, hand_frames=2, flicker=0.15,
                           wb_drift=0.08, removal_lag=7, vfr=0.2,
                           arm_rests=[(3, 4), (12, 2)]),
    "moving camera": dict(frames_per_move=[3] * 12 + [6] * 7, hand_frames=2,
                          corners_fn=_cam, rolling_shutter=0.7, vfr=0.12,
                          removal_lag=20, stone_jitter=0.07, clutter=2,
                          palette="walnut"),
}


@pytest.mark.parametrize("game", list(GAMES))
def test_render_game_yields_the_references_states(game):
    """Every yielded state equal to the reference's, in the same count and
    order; the frames (H, W, 3) uint8 tensors, each within 0.6 DN of the
    reference's on average (the sensor noise is numpy's draw in both, so
    only the drawing before it differs; 0.34 DN at most here)."""
    kw = GAMES[game]
    moves = jsynth.capture_rich_moves(19, seed=4)
    ref = list(jsynth.render_game(moves, frame_hw=HW, seed=4,
                                  empty_leadin=3, **kw))
    ours = list(synth.render_game(synth.capture_rich_moves(19, seed=4),
                                  frame_hw=HW, seed=4, empty_leadin=3,
                                  device="cpu", **kw))
    assert len(ours) == len(ref) > 19 * 3
    for k, ((f, s), (fj, sj)) in enumerate(zip(ours, ref)):
        assert np.array_equal(s, sj) and s.dtype == sj.dtype, k
        assert f.dtype == torch.uint8 and tuple(f.shape) == fj.shape
        d = np.abs(f.numpy().astype(np.int64) - fj).mean()
        assert d < 0.6, (k, d)


def test_render_game_checks_frames_per_move():
    with pytest.raises(ValueError, match="2 entries for 3 moves"):
        next(synth.render_game(synth.sample_moves(3), frames_per_move=[3, 3],
                               frame_hw=HW, device="cpu"))


@pytest.mark.parametrize("n, seed, gsize", [(40, 7, 19), (25, 3, 13),
                                            (12, 1, 9)])
def test_move_samplers_match_the_reference(n, seed, gsize):
    assert _moves_of(synth.sample_moves(n, gsize=gsize, seed=seed)) == \
        _moves_of(jsynth.sample_moves(n, gsize=gsize, seed=seed))
    assert _moves_of(synth.capture_rich_moves(n + 10, gsize=gsize,
                                              seed=seed)) == \
        _moves_of(jsynth.capture_rich_moves(n + 10, gsize=gsize, seed=seed))


def test_game_states_match_the_reference():
    moves = synth.capture_rich_moves(24, seed=2)
    for (s, m), (sj, mj) in zip(synth.game_states(moves),
                                jsynth.game_states(
                                    jsynth.capture_rich_moves(24, seed=2))):
        assert np.array_equal(s, sj) and _moves_of([m]) == _moves_of([mj])


@pytest.mark.parametrize("gsize", [19, 13, 9])
def test_gauntlet_scenario_moves_and_its_round_trip(gsize, monkeypatch):
    """The scenario's kifu equals the reference's; its factory yields the
    rendered game (at the scenario's size) through the mp4 round trip, as
    the reference's does: here the first frames, with the round trip
    recorded."""
    moves, _ = synth.gauntlet_scenario(19, seed=11, gsize=gsize,
                                       device="cpu")
    jmoves, _ = jsynth.gauntlet_scenario(19, seed=11, gsize=gsize)
    assert _moves_of(moves) == _moves_of(jmoves)
    for mod in (synth, jsynth):
        with pytest.raises(RuntimeError, match="got no frames"):
            mod.encode_roundtrip(iter(()))
    _, raw = synth._gauntlet(19, 11, HW, gsize, "cpu")
    first = next(raw())
    assert first.dtype == torch.uint8 and tuple(first.shape) == (*HW, 3)
    seen = []

    def roundtrip(frames, **kw):
        seen.append(kw)
        return [f.numpy() for f in itertools.islice(frames, 2)]

    monkeypatch.setattr(synth, "encode_roundtrip", roundtrip)
    _, factory = synth.gauntlet_scenario(19, seed=11, gsize=gsize,
                                         frame_hw=HW, device="cpu")
    got = list(factory())
    assert seen == [{}] and len(got) == 2
    assert np.array_equal(got[0], first.numpy())


def test_moves_from_sgf(tmp_path):
    from camkifu_tpu_torch.gamemodel.kifu import Kifu

    moves = synth.sample_moves(6, seed=8)
    kifu = Kifu()
    for m in moves:
        kifu.append(m)
    path = kifu.save(str(tmp_path / "game.sgf"))
    assert _moves_of(synth.moves_from_sgf(path)) == _moves_of(moves)
    assert _moves_of(jsynth.moves_from_sgf(path)) == _moves_of(moves)
