"""The port's copy of the independent OpenCV oracle (oracle_cv2) against the
reference's, on the host: ``detect_corners_cv2``, ``classify_frame_cv2``
and ``run_pipeline_cv2`` give the reference's answers on the same frames —
the port's still, the reference's renders at three stone counts, and the
film game (a fixed camera, 720p) — and read the truth where the
reference's own tests say they do. ``cv2.kmeans`` seeds its centres from
cv2's global random state, so each call starts from the same seed.
"""

import numpy as np
import pytest

from camkifu_tpu import oracle_cv2 as joracle
from camkifu_tpu.utils import synth as jsynth
from camkifu_tpu_torch import oracle_cv2
from camkifu_tpu_torch.core.gamesync import score_moves
from camkifu_tpu_torch.utils import still

HW = (720, 1280)


def _seeded(fn, *args):
    """``fn(*args)`` from cv2's random seed 0 (kmeans++ draws from it)."""
    import cv2

    cv2.setRNGSeed(0)
    return fn(*args)


def _board(n_stones, seed=0):
    labels = np.zeros((19, 19), np.int8)
    if n_stones:
        rng = np.random.default_rng(seed)
        idx = rng.choice(361, n_stones, replace=False)
        labels.flat[idx[:n_stones // 2]] = 1
        labels.flat[idx[n_stones // 2:]] = 2
    return labels


def _frames():
    """(name, frame, truth corners, truth labels) for each still."""
    out = []
    labels = _board(60, seed=4)
    frame, corners = still.render_still(labels, frame_hw=HW, seed=2)
    out.append(("port still", frame, corners, labels))
    for n in (0, 20, 100):            # tests/test_oracle_cv2.py's boards
        labels = _board(n)
        frame, corners = jsynth.render_frame(labels, frame_hw=HW)
        out.append((f"synth {n}", frame, corners, labels))
    return out


@pytest.mark.parametrize("case", range(4))
def test_detect_and_classify_match_the_reference(case):
    """Corners bitwise the reference's and within 0.15 cell of the truth;
    the reading on the true corners and on the detected ones bitwise the
    reference's, and the truth on the true corners."""
    name, frame, truth, labels = _frames()[case]
    got = oracle_cv2.detect_corners_cv2(frame)
    want = joracle.detect_corners_cv2(frame)
    assert got is not None and np.array_equal(got, want), name
    cell = np.linalg.norm(truth[1] - truth[0]) / 18
    assert np.abs(got - truth).max() < 0.15 * cell, name
    for corners in (truth, got):
        board = _seeded(oracle_cv2.classify_frame_cv2, frame, corners)
        assert board.dtype == np.int8
        assert np.array_equal(
            board, _seeded(joracle.classify_frame_cv2, frame, corners))
    assert np.array_equal(
        _seeded(oracle_cv2.classify_frame_cv2, frame, truth), labels), name


def test_detect_finds_no_board_like_the_reference():
    rng = np.random.default_rng(0)
    frame = rng.integers(0, 256, (240, 320, 3), np.uint8)
    assert oracle_cv2.detect_corners_cv2(frame) is None
    assert joracle.detect_corners_cv2(frame) is None


@pytest.mark.parametrize("corners", ["detected", "given"])
def test_run_pipeline_on_the_film_game_matches_the_reference(corners):
    """The film game (6 moves, a fixed 720p camera, sensor noise) through
    both oracles: the same moves, rejections, frame count and corners, and
    the truth's moves."""
    moves = still.sample_moves(6, seed=5)
    frames, truth = still.render_game(moves, 8, frame_hw=HW, seed=5,
                                      empty_leadin=4)
    c = None if corners == "detected" else truth
    ex, stats = _seeded(oracle_cv2.run_pipeline_cv2, iter(frames), c)
    jex, jstats = _seeded(joracle.run_pipeline_cv2, iter(frames), c)
    assert [(m.color, m.row, m.col) for m in ex.moves] == \
        [(m.color, m.row, m.col) for m in jex.moves]
    assert ex.rejected == jex.rejected
    assert stats["frames"] == jstats["frames"] == len(frames)
    assert stats["corners"] == jstats["corners"]
    assert score_moves(ex.moves, moves)["agreement"] == 1.0
