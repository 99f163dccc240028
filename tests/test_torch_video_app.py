"""The application layer on a recorded video, the port against the reference
on the CPU: ``ckmain --nogui -v game.mp4`` and ``filecheck.main game.mp4
game.sgf`` in both packages on the same file write the same SGF and print
the same report (tests/test_torch_video_runtime.py reads video with the
port alone).

The video is written to ``tmp_path`` with cv2 and decoded by both packages
on this machine. Corners are passed where auto-detection is not the point:
the reference's detection costs a long JAX compile.
"""

import json

import pytest
import torch

from camkifu_tpu import ckmain as jckmain
from camkifu_tpu import filecheck as jfilecheck
from camkifu_tpu.gamemodel.kifu import Kifu as JKifu
from camkifu_tpu.utils import synth as jsynth
from camkifu_tpu_torch import ckmain, filecheck
from camkifu_tpu_torch.gamemodel.kifu import Kifu

torch.set_num_threads(1)

HW = (360, 640)

#: The report keys that are the host clock's, not the reading's.
CLOCK = ("seconds", "fps", "cv2_fps")


@pytest.fixture(autouse=True)
def _own_home(monkeypatch, tmp_path):
    """The manual finder stores corners under ``~``: keep it in tmp."""
    monkeypatch.setenv("HOME", str(tmp_path))


@pytest.fixture(scope="module")
def game(tmp_path_factory):
    """A 5-move 360 × 640 game written to mp4v, and its SGF."""
    import cv2

    d = tmp_path_factory.mktemp("game")
    moves = jsynth.sample_moves(5, seed=17)
    video = str(d / "game.mp4")
    vw = cv2.VideoWriter(video, cv2.VideoWriter_fourcc(*"mp4v"), 25,
                         (HW[1], HW[0]))
    n = 0
    for f, _ in jsynth.render_game(moves, frames_per_move=6, frame_hw=HW,
                                   empty_leadin=3, seed=17):
        vw.write(f[:, :, ::-1])
        n += 1
    vw.release()
    sgf = str(d / "game.sgf")
    kifu = JKifu.new(sgf)
    for m in moves:
        kifu.append(m)
    kifu.save()
    corners = ",".join(repr(float(v)) for v in
                       jsynth.default_corners(HW).reshape(-1))
    return {"video": video, "sgf": sgf, "moves": moves, "frames": n,
            "corners": corners}


def _moves(kifu):
    return [(m.color, m.row, m.col) for m in kifu.moves()]


@pytest.mark.parametrize("decoders", ["1", "3"])
def test_ckmain_reads_a_video_like_the_reference(game, tmp_path, capsys,
                                                 decoders):
    """``ckmain --nogui -v game.mp4 --corners ... --sf clustering
    --decoders N --sgf out.sgf`` in both packages: the same printed lines,
    the same saved SGF text, the truth's moves."""
    out, text = {}, {}
    for name, module, extra in (("reference", jckmain, []),
                                ("port", ckmain, ["--device", "cpu"])):
        sgf = str(tmp_path / f"{name}.sgf")
        assert module.main(["-v", game["video"], "--nogui", "--corners",
                            game["corners"], "--sf", "clustering",
                            "--batch", "8", "--decoders", decoders,
                            "--sgf", sgf] + extra) == 0
        out[name] = capsys.readouterr().out.replace(sgf, "out.sgf")
        with open(sgf) as fh:
            text[name] = fh.read()
    assert out["port"] == out["reference"]
    assert out["port"].startswith(f"detected 5 moves ({game['frames']} "
                                  f"frames)\n")
    assert text["port"] == text["reference"]
    assert _moves(Kifu.load(str(tmp_path / "port.sgf"))) == \
        [(m.color, m.row, m.col) for m in game["moves"]]


@pytest.mark.parametrize("argv", [
    ["--no-meta", "--batch", "8"],
    ["--no-meta", "--batch", "8", "--decoders", "2", "--oracle", "both"],
], ids=["tpu", "both"])
def test_filecheck_main_reads_a_video_like_the_reference(game, capsys, argv):
    """``filecheck.main game.mp4 game.sgf --corners ...`` in both packages:
    the same report (the host clock's keys aside) and the same PASS line
    up to its rate; with ``--oracle both``, the cv2 oracle's agreement and
    the cross-agreement too."""
    common = [game["video"], game["sgf"], "--corners", game["corners"]]
    reports, verdicts = [], []
    for module, extra in ((jfilecheck, []), (filecheck, ["--device", "cpu"])):
        assert module.main(common + argv + extra) == 0
        text = capsys.readouterr().out
        body, verdict = text.rsplit("\n\n", 1)
        reports.append({k: v for k, v in json.loads(body).items()
                        if k not in CLOCK})
        verdicts.append(verdict.rsplit(" @ ", 1)[0])
    assert reports[1] == reports[0] and verdicts[1] == verdicts[0]
    assert reports[1]["agreement"] == 1.0
    assert reports[1]["frames"] == game["frames"]
    if "both" in argv:
        assert reports[1]["tpu_vs_cv2_agreement"] == 1.0
        assert reports[1]["cv2_agreement_vs_ref"] == 1.0
