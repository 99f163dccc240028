"""The port alone on a recorded video, on the CPU: ``ckmain --nogui
--gsize auto -v game.mp4`` with the default finders, and ``filecheck``'s
``--oracle both`` on detected corners. The reference is left out here:
its board detection costs a long JAX compile
(tests/test_torch_video_app.py holds the two packages to each other with
given corners).
"""

import json

import pytest
import torch

from camkifu_tpu.gamemodel.kifu import Kifu as JKifu
from camkifu_tpu.utils import synth as jsynth
from camkifu_tpu_torch import ckmain, filecheck
from camkifu_tpu_torch.gamemodel.kifu import Kifu

torch.set_num_threads(1)

HW = (360, 640)


@pytest.fixture(autouse=True)
def _own_home(monkeypatch, tmp_path):
    """The finders store state under ``~``: keep it in tmp."""
    monkeypatch.setenv("HOME", str(tmp_path))


def _write(path, moves, per_move, leadin, seed):
    import cv2

    vw = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), 25,
                         (HW[1], HW[0]))
    for f, _ in jsynth.render_game(moves, frames_per_move=per_move,
                                   frame_hw=HW, empty_leadin=leadin,
                                   seed=seed):
        vw.write(f[:, :, ::-1])
    vw.release()
    return str(path)


def _moves(kifu):
    return [(m.color, m.row, m.col) for m in kifu.moves()]


def test_ckmain_reads_a_video_with_its_default_finders(tmp_path,
                                                       monkeypatch):
    """The port alone: ``ckmain --nogui --gsize auto --decoders 2 -v
    game.mp4`` with the default finders (detection, tracking, the vote
    scan; the first anchor's lens calibration pinned to a pinhole) reads
    the truth at the inferred size 19, and the kifu equals
    ``filecheck.run_runtime`` on the same decoded frames. The votes need
    each position held for the vote window: 8 frames a move."""
    from camkifu_tpu_torch.board import bf_auto

    monkeypatch.setattr(bf_auto, "estimate_lens_k1",
                        lambda *a, **kw: (0.0, 0.0))
    moves = jsynth.sample_moves(4, seed=13)
    video = _write(tmp_path / "held.mp4", moves, 8, 4, 13)
    want = [(m.color, m.row, m.col) for m in moves]
    sgf = str(tmp_path / "auto.sgf")
    assert ckmain.main(["-v", video, "--nogui", "--gsize", "auto",
                        "--batch", "16", "--decoders", "2", "--sgf", sgf,
                        "--device", "cpu"]) == 0
    kifu = Kifu.load(sgf)
    assert kifu.gsize == 19 and _moves(kifu) == want
    frames = list(filecheck.iter_video_frames(video))
    assert len(frames) == 36 and frames[0].shape == (*HW, 3)
    detected, _ = filecheck.run_runtime(frames, batch=16, device="cpu")
    assert [(m.color, m.row, m.col) for m in detected] == want


def test_filecheck_oracle_both_on_detected_corners(tmp_path, capsys):
    """With automatic detection, ``--oracle both`` adds the corners-shared
    tier: the cv2 classifier and votes re-run on the port's detected
    corners (the reference's tier 2)."""
    moves = jsynth.sample_moves(5, seed=17)
    video = _write(tmp_path / "game.mp4", moves, 6, 3, 17)
    sgf = str(tmp_path / "game.sgf")
    kifu = JKifu.new(sgf)
    for m in moves:
        kifu.append(m)
    kifu.save()
    assert filecheck.main([video, sgf, "--no-meta",
                           "--batch", "8", "--oracle", "both", "--device",
                           "cpu"]) == 0
    report = json.loads(capsys.readouterr().out.rsplit("\n\n", 1)[0])
    assert report["agreement"] == 1.0
    assert report["cv2_shared_agreement_vs_ref"] == 1.0
    assert report["tpu_vs_cv2_shared_agreement"] == 1.0
    assert 0.0 <= report["tpu_vs_cv2_agreement"] <= 1.0
