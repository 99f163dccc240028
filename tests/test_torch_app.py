"""The port's application layer (``ckmain``, ``glmain``) against the
reference, on the CPU.

``ckmain`` reads frames that a caller hands it as ``args.video``, a video
file or a camera (through cv2, as the reference). The GUI entry points run
on Tk's widget layer patched as tests/test_gui_headless.py patches it (the
fakes are this file's own).
"""

from __future__ import annotations

import sys
import time
import tkinter as tk

import numpy as np
import pytest
import torch

from camkifu_tpu import ckmain as jckmain
from camkifu_tpu.utils import synth as jsynth
from camkifu_tpu_torch import ckmain, glmain
from camkifu_tpu_torch.gamemodel.kifu import Kifu
from camkifu_tpu_torch.gamemodel.move import B, W, Move

torch.set_num_threads(1)

HW = (360, 640)


@pytest.fixture(autouse=True)
def _own_home(monkeypatch, tmp_path):
    """The manual finder stores corners under ``~``: keep it in tmp."""
    monkeypatch.setenv("HOME", str(tmp_path))


def _frames(moves, gsize=19, per_move=6, leadin=3, seed=13):
    return np.stack([f for f, _ in jsynth.render_game(
        moves, frames_per_move=per_move, frame_hw=HW, empty_leadin=leadin,
        gsize=gsize, seed=seed)])


def _corner_arg() -> str:
    corners = jsynth.default_corners(HW)
    return ",".join(str(round(float(v), 1)) for v in corners.reshape(-1))


def _with_frames(module, monkeypatch, frames):
    """``module.main`` parses its argv, then reads ``frames`` as its
    video: the way a caller hands frames to either package."""
    real = module.get_argparser

    def parser():
        ap = real()
        parse = ap.parse_args

        def parse_args(argv=None):
            args = parse(argv)
            args.video = frames
            return args

        ap.parse_args = parse_args
        return ap

    monkeypatch.setattr(module, "get_argparser", parser)


def _kifu_moves(kifu):
    return [(m.color, m.row, m.col) for m in kifu.moves()]


def test_main_headless_matches_the_reference(monkeypatch, capsys):
    """The same 360 × 640 game through both packages' ``ckmain.main
    --nogui --corners ... --sf clustering --batch 8``: the same printed
    lines and SGF text, and the truth's moves."""
    moves = jsynth.sample_moves(5, seed=13)
    frames = _frames(moves)
    argv = ["--nogui", "--corners", _corner_arg(), "--sf", "clustering",
            "--batch", "8"]
    out = {}
    for name, module, extra in (("reference", jckmain, []),
                                ("port", ckmain, ["--device", "cpu"])):
        _with_frames(module, monkeypatch, frames)
        assert module.main(argv + extra) == 0
        out[name] = capsys.readouterr().out
    assert out["port"] == out["reference"]
    assert out["port"].startswith(f"detected {len(moves)} moves "
                                  f"({len(frames)} frames)\n")
    want = "".join(f";{m.color}[{m.sgf}]\n" for m in moves)
    assert want in out["port"]


def test_gsize_auto_plumbing(monkeypatch, tmp_path, capsys):
    """``--gsize auto`` resolves before the game model is built: the probe
    frame reaches ``infer_gsize`` as a tensor on ``--device``, and the size
    it returns (pinned to 13 here) reaches the controller, the finders and
    the SGF's SZ (tests/test_board_sizes.py:119's check of the
    reference)."""
    from camkifu_tpu_torch.board import bf_auto

    moves = jsynth.sample_moves(3, gsize=13, seed=9)
    frames = _frames(moves, gsize=13, per_move=2, leadin=1, seed=9)
    seen = {}

    def fake_infer(frame, *a, **kw):
        seen["frame"] = frame
        return 13, {13: 0.5}

    monkeypatch.setattr(bf_auto, "infer_gsize", fake_infer)
    _with_frames(ckmain, monkeypatch, frames)
    sgf_path = str(tmp_path / "ga.sgf")
    rc = ckmain.main(["-v", "ignored", "--sgf", sgf_path, "--nogui",
                      "--sf", "clustering", "--corners", _corner_arg(),
                      "--gsize", "auto", "--batch", "8", "--device", "cpu"])
    assert rc == 0
    probe = seen["frame"]
    assert isinstance(probe, torch.Tensor) and probe.device.type == "cpu"
    assert tuple(probe.shape) == HW + (3,)
    assert np.array_equal(probe.numpy(), frames[len(frames[:8]) // 2])
    assert "gsize auto: 13" in capsys.readouterr().out
    k = Kifu.load(sgf_path)
    assert k.gsize == 13
    assert _kifu_moves(k) == [(m.color, m.row, m.col) for m in moves]


def test_board_finder_auto_path_reads_the_truth(monkeypatch, tmp_path):
    """``ckmain`` with its default finders (``BoardFinderAuto``, then
    ``SfMeta``) reads a 360 × 640 game exactly. The first anchor's lens
    calibration is pinned to a pinhole (the game is rendered without a
    lens; the calibration has its own tests)."""
    from camkifu_tpu_torch.board import bf_auto
    from camkifu_tpu_torch.utils import synth

    monkeypatch.setattr(bf_auto, "estimate_lens_k1",
                        lambda *a, **kw: (0.0, 0.0))
    moves = synth.sample_moves(4, seed=13)
    frames = [f.numpy() for f, _ in synth.render_game(
        moves, frames_per_move=8, frame_hw=HW, empty_leadin=4, seed=13,
        device="cpu")]
    _with_frames(ckmain, monkeypatch, frames)
    sgf_path = str(tmp_path / "auto.sgf")
    assert ckmain.main(["--nogui", "--sgf", sgf_path, "--batch", "16",
                        "--device", "cpu"]) == 0
    assert _kifu_moves(Kifu.load(sgf_path)) == \
        [(m.color, m.row, m.col) for m in moves]


class _Camera:
    """Stands in for ``cv2.VideoCapture(index)``: the given RGB frames as
    BGR, then nothing."""

    def __init__(self, frames):
        self.frames, self.i = frames, 0

    def isOpened(self):
        return True

    def read(self):
        if self.i >= len(self.frames):
            time.sleep(0.002)
            return False, None
        self.i += 1
        return True, self.frames[self.i - 1][:, :, ::-1]

    def release(self):
        pass


@pytest.mark.parametrize("video", ["game.mp4", "0"])
def test_a_path_or_camera_raises_naming_cv2(video, monkeypatch, tmp_path,
                                            capsys):
    """Without cv2, a video path or a camera index raises ``ImportError``
    (with ``--gsize auto`` at the probe) rather than read an empty stream.
    With it, both packages read the same: a recorded game through
    ``--nogui --corners --sf clustering`` with one and two decoders, the
    same printed SGF; a camera's probe frame for ``--gsize auto`` (the
    size inference pinned), the same frame."""
    import cv2

    from camkifu_tpu.board import bf_auto as jbf_auto
    from camkifu_tpu_torch.board import bf_auto

    with monkeypatch.context() as blocked:
        blocked.setitem(sys.modules, "cv2", None)
        for extra in ([], ["--gsize", "auto"]):
            with pytest.raises(ImportError, match="cv2"):
                ckmain.main(["-v", str(tmp_path / video), "--nogui",
                             "--device", "cpu"] + extra)
    moves = jsynth.sample_moves(4, seed=13)
    frames = list(_frames(moves))
    if video == "0":
        seen = []

        def infer(frame, *a, **kw):
            seen.append(np.asarray(frame))
            return 13, {13: 0.5}

        for module, bfm, extra in ((jckmain, jbf_auto, []),
                                   (ckmain, bf_auto, ["--device", "cpu"])):
            # Eight frames, the probe's batch: the ring keeps the latest.
            monkeypatch.setattr(cv2, "VideoCapture",
                                lambda index: _Camera(frames[:8]))
            monkeypatch.setattr(bfm, "infer_gsize", infer)
            args = module.get_argparser().parse_args(
                ["-v", video, "--gsize", "auto"] + extra)
            assert module._infer_gsize(args) == 13
        assert len(seen) == 2 and np.array_equal(seen[1], seen[0])
        assert np.array_equal(seen[1], frames[4])
        return
    path = str(tmp_path / video)
    vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 10,
                         (HW[1], HW[0]))
    for f in frames:
        vw.write(f[:, :, ::-1])
    vw.release()
    argv = ["-v", path, "--nogui", "--corners", _corner_arg(), "--sf",
            "clustering", "--batch", "8"]
    for decoders in ("1", "2"):
        out = {}
        for name, module, extra in (("reference", jckmain, []),
                                    ("port", ckmain, ["--device", "cpu"])):
            assert module.main(argv + ["--decoders", decoders] + extra) == 0
            out[name] = capsys.readouterr().out
        assert out["port"] == out["reference"]
        assert out["port"].startswith(f"detected {len(moves)} moves "
                                      f"({len(frames)} frames)\n")


def _options(parser) -> dict:
    return {a.option_strings[0] if a.option_strings else a.dest:
            (tuple(a.option_strings), a.default, a.nargs, a.type,
             a.choices, a.metavar)
            for a in parser._actions}


def test_argparser_flags_match_the_reference():
    """The reference's flags with their defaults (``--decoders``,
    ``--live-wait`` among them), plus ``--device`` (default the card)."""
    ours, ref = _options(ckmain.get_argparser()), \
        _options(jckmain.get_argparser())
    device = ours.pop("--device")
    assert ours == ref
    assert device[1] == "cuda"
    assert ckmain.get_argparser().prog == jckmain.get_argparser().prog


# ---------------------------------------------------------------------------
# The GUI entry points on a fake Tk.
# ---------------------------------------------------------------------------


class _Recorder:
    def __init__(self):
        self.items: dict[int, tuple] = {}
        self._next = 0

    def create(self, kind, args, kwargs):
        self._next += 1
        self.items[self._next] = (kind, args, kwargs)
        return self._next

    def delete(self, target):
        if target == "all":
            self.items.clear()
        else:
            self.items.pop(target, None)

    def fills(self):
        return [k.get("fill") for kind, a, k in self.items.values()
                if kind == "oval"]


class _FakeVar:
    def __init__(self, master=None, value=None):
        self._v = value

    def get(self):
        return self._v

    def set(self, v):
        self._v = v


class _FakeMenu:
    def __init__(self, master=None, tearoff=0):
        self.commands: dict[str, object] = {}
        self.cascades: dict[str, "_FakeMenu"] = {}

    def add_command(self, label=None, command=None, **kw):
        self.commands[label] = command

    add_radiobutton = add_command

    def add_separator(self):
        pass

    def add_cascade(self, label=None, menu=None, **kw):
        self.cascades[label] = menu


class _FakeWidget:
    def __init__(self, master=None, **kw):
        pass

    def grid(self, **kw):
        pass


class _FakeRoot:
    """Stands in for ``tk.Tk()``: runs the after()-scheduled callbacks as a
    small event loop until ``stop_when()`` holds, then drains once more."""

    stop_when = staticmethod(lambda: True)
    last = None

    def __init__(self):
        self.bindings: dict[str, object] = {}
        self.after_calls: list = []
        self.menu = None
        _FakeRoot.last = self

    def bind(self, seq, fn):
        self.bindings[seq] = fn

    def config(self, menu=None, **kw):
        self.menu = menu

    def after(self, ms, fn):
        self.after_calls.append((ms, fn))

    def destroy(self):
        pass

    def title(self, t):
        self._title = t

    def mainloop(self, n: int = 0):
        import time

        deadline = time.time() + 60
        while time.time() < deadline and not _FakeRoot.stop_when():
            pending, self.after_calls = self.after_calls, []
            for _ms, fn in pending:
                fn()
            time.sleep(0.02)
        pending, self.after_calls = self.after_calls, []
        for _ms, fn in pending:
            fn()


@pytest.fixture
def fake_tk(monkeypatch):
    rec = _Recorder()
    monkeypatch.setattr(tk.Canvas, "__init__",
                        lambda self, master=None, **kw: None)
    monkeypatch.setattr(tk.Canvas, "create_line",
                        lambda self, *a, **k: rec.create("line", a, k))
    monkeypatch.setattr(tk.Canvas, "create_oval",
                        lambda self, *a, **k: rec.create("oval", a, k))
    monkeypatch.setattr(tk.Canvas, "delete",
                        lambda self, target: rec.delete(target))
    monkeypatch.setattr(tk.Canvas, "bind", lambda self, seq, fn: None)
    monkeypatch.setattr(tk.Canvas, "grid", lambda self, **kw: None)
    monkeypatch.setattr(tk.Frame, "__init__",
                        lambda self, master=None, **kw: None)
    monkeypatch.setattr(tk.Frame, "pack", lambda self, **kw: None)
    monkeypatch.setattr(tk, "Menu", _FakeMenu)
    monkeypatch.setattr(tk, "StringVar", _FakeVar)
    monkeypatch.setattr(tk, "DoubleVar", _FakeVar)
    monkeypatch.setattr(tk, "Label", _FakeWidget)
    monkeypatch.setattr(tk, "Button", _FakeWidget)
    monkeypatch.setattr(tk, "Scale", _FakeWidget)
    monkeypatch.setattr(tk, "Tk", _FakeRoot)
    return rec


def test_main_gui_end_to_end(fake_tk, monkeypatch):
    """``ckmain.main_gui``: ``ControllerV``, the threaded ``VManager`` on
    ``--device`` and ``VUI``; vision_on reads the film, the pipe drains on
    the (fake) Tk loop, the stones reach the canvas, teardown autosaves."""
    import camkifu_tpu_torch.gui.vui as vui_mod
    from camkifu_tpu_torch.board.bf_manual import BoardFinderManual
    from camkifu_tpu_torch.stone.sf_clustering import SfClustering

    moves = jsynth.sample_moves(3, seed=13)
    frames = _frames(moves, per_move=2, leadin=1)
    built: list = []

    class CapturingVUI(vui_mod.VUI):
        def __init__(self, master, controller, vmanager):
            super().__init__(master, controller, vmanager)
            built.append(self)

    monkeypatch.setattr(vui_mod, "VUI", CapturingVUI)
    _FakeRoot.stop_when = staticmethod(
        lambda: bool(built) and not built[0].vmanager.is_running())
    args = ckmain.get_argparser().parse_args(
        ["-v", "ignored", "--batch", "8", "--device", "cpu"])
    args.video = frames
    rc = ckmain.main_gui(args, BoardFinderManual, SfClustering,
                         corners=jsynth.default_corners(HW))
    assert rc == 0
    vui = built[0]
    assert vui.vmanager.device == torch.device("cpu")
    assert _FakeRoot.last._title == "camkifu-tpu"
    assert _kifu_moves(vui.controller.kifu) == \
        [(m.color, m.row, m.col) for m in moves]
    assert {"#111", "#f4f4f4"} <= set(fake_tk.fills())


def test_glmain_opens_edits_and_saves(fake_tk, monkeypatch, tmp_path):
    """``glmain.main`` opens an SGF on the port's ``Controller`` and
    ``UI``, draws it, and saves the edited game on exit."""
    import camkifu_tpu_torch.gui.ui as ui_mod

    path = str(tmp_path / "edit.sgf")
    k = Kifu()
    k.append(Move("np", (B, 3, 3)))
    k.save(path)
    built: list = []

    class CapturingUI(ui_mod.UI):
        def __init__(self, master, controller):
            super().__init__(master, controller)
            built.append(self)

    def edit_once():
        if built and len(built[0].controller.kifu) == 1:
            built[0].controller.append(Move("np", (W, 15, 15)))
        return True

    monkeypatch.setattr(ui_mod, "UI", CapturingUI)
    _FakeRoot.stop_when = staticmethod(edit_once)
    assert glmain.main([path]) == 0
    assert _FakeRoot.last._title.startswith("glmain")
    assert "#111" in fake_tk.fills()
    assert _kifu_moves(Kifu.load(path)) == [(B, 3, 3), (W, 15, 15)]


def test_glmain_without_tkinter_returns_2(monkeypatch, capsys):
    import sys

    monkeypatch.setitem(sys.modules, "tkinter", None)
    assert glmain.main([]) == 2
    assert "tkinter unavailable" in capsys.readouterr().err
