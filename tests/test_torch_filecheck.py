"""The port's accuracy harness (camkifu_tpu_torch/filecheck.py) against the
reference's (camkifu_tpu/filecheck.py): ``KifuChecker``'s report and diff
bitwise, the spec errors equal, ``check`` on a rendered game at agreement
1.0 with the reference's report (votes on and off), ``run_pipeline`` over
device tensors as over numpy frames, the strict neural checkpoint load,
``main``, and the paths that need cv2 raising ``NotImplementedError``."""

import numpy as np
import pytest
import torch

from camkifu_tpu import filecheck as jfilecheck
from camkifu_tpu.gamemodel.move import Move as JMove
from camkifu_tpu_torch import filecheck
from camkifu_tpu_torch.gamemodel.move import B, W, Move
from camkifu_tpu_torch.utils import synth

torch.set_num_threads(1)

#: The report keys that are the host clock's, not the reading's.
CLOCK = ("seconds", "fps")


def _without_clock(report: dict) -> dict:
    return {k: v for k, v in report.items() if k not in CLOCK}


def test_kifu_checker_report_and_diff_match_the_reference():
    ref = synth.sample_moves(12, seed=3)
    jref = [JMove("np", (m.color, m.row, m.col)) for m in ref]
    cases = [ref, ref[:5] + ref[6:], ref[:4] + [Move("np", (B, 0, 0))]
             + ref[5:], ref + [Move("np", (W, 18, 18))], [], ref[::-1]]
    checker, jchecker = filecheck.KifuChecker(ref), \
        jfilecheck.KifuChecker(jref)
    for detected in cases:
        jdet = [JMove("np", (m.color, m.row, m.col)) for m in detected]
        assert checker.report(detected) == jchecker.report(jdet)
        assert checker.diff_lines(detected) == jchecker.diff_lines(jdet)


SPEC_ERRORS = [
    ("synth:3:sepia", None, {}),
    ("synth:3:hard:fog:2", None, {}),
    ("synth:19:gauntlet:hard", None, {}),
    ("synth:19:gauntlet", None, {"oracle": "both"}),
    ("synth:19:gauntlet", None,
     {"corners": np.zeros((4, 2), np.float32)}),
    ("synth:19:gauntlet", None, {"use_meta": False}),
    ("game.mp4", None, {}),
]


@pytest.mark.parametrize("spec, sgf, kw", SPEC_ERRORS)
def test_spec_errors_match_the_reference(spec, sgf, kw):
    with pytest.raises(ValueError) as ours:
        filecheck.check(spec, sgf, device="cpu", **kw)
    with pytest.raises(ValueError) as want:
        jfilecheck.check(spec, sgf, **kw)
    assert str(ours.value) == str(want.value)


def test_paths_that_need_cv2_raise(tmp_path):
    """The 'real' and 'gauntlet' specs (an mp4 round trip), a video file
    (cv2 decode) and the cv2 oracle raise ``NotImplementedError`` naming
    what is missing, before anything is rendered or read."""
    sgf = tmp_path / "ref.sgf"
    sgf.write_text("(;GM[1]FF[4]SZ[19];B[dd];W[pp])")
    with pytest.raises(NotImplementedError, match="VideoWriter"):
        filecheck.check("synth:3:real", None, device="cpu")
    with pytest.raises(NotImplementedError, match="VideoWriter"):
        filecheck.check("synth:19:gauntlet", None, device="cpu")
    with pytest.raises(NotImplementedError, match="cv2"):
        filecheck.check(str(tmp_path / "game.mp4"), str(sgf), device="cpu")
    for oracle in ("cv2", "both"):
        with pytest.raises(NotImplementedError, match="oracle_cv2"):
            filecheck.check("synth:3", None, oracle=oracle, device="cpu")
    with pytest.raises(NotImplementedError, match="cv2"):
        filecheck.iter_video_frames("game.mp4")


@pytest.mark.parametrize("use_meta", [True, False])
def test_check_matches_the_reference(use_meta):
    """``synth:3`` at 720p with the ground-truth corners: every move read
    (agreement 1.0), and the same report as the reference's check on the
    same spec — through the vote scan, and through per-frame clustering
    (``run_pipeline(use_meta=False)``, ``read_board_batch``)."""
    ours = filecheck.check("synth:3", None, use_meta=use_meta, device="cpu")
    want = jfilecheck.check("synth:3", None, use_meta=use_meta)
    assert ours["agreement"] == 1.0
    assert _without_clock(ours) == _without_clock(want)


def test_run_pipeline_takes_device_tensors_and_numpy_frames():
    """The same game as (H, W, 3) tensors, stacked on their device, and as
    numpy arrays: the same moves and frame count, and ``progress`` called
    after every batch."""
    moves = synth.sample_moves(2, seed=6)
    frames = [f for f, _ in synth.render_game(
        moves, frames_per_move=3, frame_hw=(360, 640), seed=6,
        empty_leadin=3, device="cpu")]
    corners = synth.default_corners((360, 640))
    seen = []
    runs = [filecheck.run_pipeline(iter(fs), corners, batch=4,
                                   use_meta=False, progress=seen.append,
                                   device="cpu")
            for fs in (frames, [f.numpy() for f in frames])]
    (ex, stats), (ex_np, stats_np) = runs
    assert [(m.color, m.row, m.col) for m in ex.moves] == \
        [(m.color, m.row, m.col) for m in ex_np.moves] == \
        [(m.color, m.row, m.col) for m in moves]
    assert stats["frames"] == stats_np["frames"] == 9
    assert seen == [4, 8, 9] * 2


def test_batched_pads_tensors_on_their_device():
    frames = [torch.full((2, 3, 3), i, dtype=torch.uint8) for i in range(5)]
    got = list(filecheck.batched(iter(frames), 4))
    assert [n for _, n in got] == [4, 1]
    assert all(isinstance(b, torch.Tensor) for b, _ in got)
    assert torch.equal(got[1][0][:, 0, 0, 0], torch.tensor([4, 4, 4, 4],
                                                            dtype=torch.uint8))


def test_neural_checkpoint_load_is_strict(tmp_path, monkeypatch):
    """No checkpoint: the pipeline reads without the voter. A checkpoint
    that does not load raises, where the reference's bare ``except``
    would read on without it."""
    monkeypatch.setenv("HOME", str(tmp_path))
    frames = [np.full((64, 96, 3), 120, np.uint8)] * 2
    corners = np.array([[10, 10], [80, 10], [80, 55], [10, 55]], np.float32)
    ex, stats = filecheck.run_pipeline(iter(frames), corners, batch=2,
                                       device="cpu")
    assert stats["frames"] == 2 and ex.moves == []
    ckpt = tmp_path / ".camkifu_tpu_torch" / "sf_neural.npz"
    ckpt.parent.mkdir()
    np.savez(ckpt, **{"params/Conv_0/kernel": np.zeros((1,), np.float32)})
    with pytest.raises(ValueError, match="not a PatchNet parameter tree"):
        filecheck.run_pipeline(iter(frames), corners, batch=2, device="cpu")
    ex, _ = filecheck.run_pipeline(iter(frames), corners, batch=2,
                                   use_neural=False, device="cpu")
    assert ex.moves == []


def test_main_prints_the_report_and_passes(capsys):
    """``python -m camkifu_tpu_torch.filecheck synth:1:5 --no-meta`` on the
    CPU: the JSON report and the PASS line, exit code 0."""
    assert filecheck.main(["synth:1:5", "--no-meta", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert '"agreement": 1.0' in out
    assert "PASS: 1/1 moves agree (100.0%), 0 wrong, 0 missing, 0 extra" \
        in out
