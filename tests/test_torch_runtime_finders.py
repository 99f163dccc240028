"""The port's registered finders in the runtime, on the CPU, by the port
alone: each selected by its label through the controller's API, over
3 moves of a 360×640 game, reads the game's moves."""

import numpy as np
import pytest
import torch

from camkifu_tpu_torch.config import cvconf
from camkifu_tpu_torch.core.capture import ArrayCapture
from camkifu_tpu_torch.core.controllerv import ControllerVSeq
from camkifu_tpu_torch.core.vmanager import VManagerSeq
from camkifu_tpu_torch.utils.still import (default_corners,
                                            handheld_corners, render_game,
                                            sample_moves)

torch.set_num_threads(1)

HW = (360, 640)
BATCH = 16


@pytest.fixture(scope="module")
def game():
    """tests/test_torch_runtime.py's game: 6 moves (seed 9) from a camera
    drifting (5, 4) px."""
    moves = sample_moves(6, seed=9)
    fpm = cvconf.vote_window + 3
    n = 6 + len(moves) * fpm
    frames, _ = render_game(
        moves, fpm, frame_hw=HW, seed=9, empty_leadin=6,
        corners=handheld_corners(n, HW, drift=(5.0, 4.0),
                                 periods=(8.0, 11.0)))
    return moves, list(frames)


def _moves(controller):
    return [(m.color, m.row, m.col) for m in controller.kifu.moves()]


@pytest.mark.parametrize("bf_name, sf_name", [
    ("manual", "meta"), ("manual", "clustering"), ("manual", "contours"),
    ("automatic", "clustering")])
def test_registered_finders_read_the_game(game, bf_name, sf_name):
    """The port's registered finders, selected by label, on 3 moves:
    clicked corners of a fixed camera (BoardFinderManual, its lens
    calibrated from them) under each stones finder's own warp, and
    BoardFinderAuto's own tracking pass (track_corners_batch) on the
    drifting camera under a finder that does not track."""
    moves, frames = game
    n = 6 + 3 * (cvconf.vote_window + 3)
    if bf_name == "manual":
        frames, _ = render_game(moves[:3], cvconf.vote_window + 3,
                                frame_hw=HW, seed=9, empty_leadin=6)
        frames = list(frames)
    controller = ControllerVSeq()
    vm = VManagerSeq(controller, video=None, batch=BATCH, device="cpu")
    vm.capture = ArrayCapture(frames[:n])
    controller.pipe("bfselect", bf_name)     # the registries, by label
    controller.pipe("sfselect", sf_name)
    bf = vm.board_finder
    if bf_name == "manual":
        bf.set_corners(default_corners(HW))
    else:
        bf._lens_checked = True
    vm.run()
    assert _moves(controller) == [(m.color, m.row, m.col)
                                  for m in moves[:3]]
    assert bf.metadata.get("lens_k1", 0.0) == 0.0
    if bf_name == "automatic":
        assert bf.corners_batch.shape == (BATCH, 4, 2)


def test_manual_corners_persist_per_path_and_not_across_array_sessions(
        tmp_path, monkeypatch):
    """BoardFinderManual keys its corner store by a video path or camera
    index: a path's corners come back in its next session, while two
    sessions over in-memory frames neither save nor share corners."""
    from camkifu_tpu_torch.board import bf_manual

    monkeypatch.setattr(bf_manual, "PERSIST_PATH",
                        str(tmp_path / "corners.json"))
    corners = default_corners(HW)

    def finder(video):
        vm = VManagerSeq(ControllerVSeq(), video=video, batch=BATCH,
                         device="cpu")
        return bf_manual.BoardFinderManual(vm)

    first = finder([np.zeros((*HW, 3), np.uint8)])
    assert first.key is None
    first.set_corners(corners)
    assert not (tmp_path / "corners.json").exists()
    assert not finder([np.zeros((*HW, 3), np.uint8)]).corners.ready()
    assert finder(None).key is None

    finder("game.mp4").set_corners(corners)
    again = finder("game.mp4")
    assert again.ready() and np.array_equal(again.corners.points,
                                            np.asarray(corners, np.float32))
    assert not finder("other.mp4").corners.ready()
    assert finder(0).key == "0"
