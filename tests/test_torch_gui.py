"""The port's GUI (``gui/goban``, ``ui``, ``vui``, ``video_window``) and its
overlays (``core/imgutil``'s drawing) against the reference, headless on
the CPU.

No display exists here, so Tk's widget layer is patched, as
tests/test_gui_headless.py patches it (the fakes are this file's own): the
canvas primitives record their calls, menus record their entries, and the
genuine ``Goban`` / ``UI`` / ``VUI`` / ``VideoWindow`` code of both
packages runs on top. Both packages import the same ``tkinter``, so one
patch serves both. The overlays are held to cv2's drawing calls (which
the reference makes) with each tolerance measured and stated.
"""

from __future__ import annotations

import tkinter as tk

import numpy as np
import pytest
import torch

from camkifu_tpu.core import controllerv as jcontrollerv
from camkifu_tpu.core import imgutil as jimgutil
from camkifu_tpu.gamemodel import move as jmove
from camkifu_tpu_torch.config import cvconf
from camkifu_tpu_torch.core import controllerv, imgutil
from camkifu_tpu_torch.gamemodel import move

torch.set_num_threads(1)


class _Event:
    def __init__(self, x: float, y: float):
        self.x = x
        self.y = y


class _Recorder:
    """One canvas's call log: its live items by id and its bindings."""

    def __init__(self):
        self.items: dict[int, tuple] = {}
        self.bound: dict[str, object] = {}
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

    def ovals(self):
        return [(a, k) for kind, a, k in self.items.values() if kind == "oval"]


def _patch_canvas(monkeypatch):
    """Every canvas records into its own ``_rec``."""
    def init(self, master=None, **kw):
        self._rec = _Recorder()

    monkeypatch.setattr(tk.Canvas, "__init__", init)
    monkeypatch.setattr(tk.Canvas, "create_line",
                        lambda self, *a, **k: self._rec.create("line", a, k))
    monkeypatch.setattr(tk.Canvas, "create_oval",
                        lambda self, *a, **k: self._rec.create("oval", a, k))
    monkeypatch.setattr(tk.Canvas, "delete",
                        lambda self, target: self._rec.delete(target))
    monkeypatch.setattr(
        tk.Canvas, "coords",
        lambda self, i, *a: self._rec.items.__setitem__(
            i, (self._rec.items[i][0], tuple(a), self._rec.items[i][2])))
    monkeypatch.setattr(tk.Canvas, "bind",
                        lambda self, seq, fn: self._rec.bound.__setitem__(
                            seq, fn))
    monkeypatch.setattr(tk.Canvas, "grid", lambda self, **kw: None)


def _goban_pair(monkeypatch):
    """(reference, port) of (widget, controller, corrections) on the same
    recorder scheme."""
    _patch_canvas(monkeypatch)
    from camkifu_tpu.gui.goban import Goban as JGoban
    from camkifu_tpu_torch.gui.goban import Goban

    out = []
    for cls, cmod in ((JGoban, jcontrollerv), (Goban, controllerv)):
        controller = cmod.ControllerVSeq()
        corrections: list = []
        controller.stones_finder = type(
            "SF", (), {"corrected": lambda self, e, x, log=corrections:
                       log.append((e, x))})()
        out.append((cls(None, controller, size=380), controller,
                    corrections))
    return out


def _center(widget, r, c):
    s = widget.scale
    return (c + 0.5) * s, (r + 0.5) * s


def _put(controller, mmod, color, r, c):
    controller.pipe("append", mmod.Move("np", (color, r, c)))


def _gesture(name, widget, controller, mmod):
    rec = widget._rec
    if name == "redraw":
        _put(controller, mmod, "B", 3, 3)
        _put(controller, mmod, "W", 15, 15)
        widget.redraw()
    elif name == "click_put":
        for r, c in ((5, 7), (2, 2)):
            rec.bound["<ButtonPress-1>"](_Event(*_center(widget, r, c)))
            rec.bound["<ButtonRelease-1>"](_Event(*_center(widget, r, c)))
    elif name == "drag_relocate":
        _put(controller, mmod, "B", 3, 3)
        widget.redraw()
        x0, y0 = _center(widget, 3, 3)
        rec.bound["<ButtonPress-1>"](_Event(x0, y0))
        rec.bound["<B1-Motion>"](_Event(x0 + 13, y0 + 5))
        rec.bound["<ButtonRelease-1>"](_Event(*_center(widget, 8, 11)))
    elif name == "drag_occupied":
        _put(controller, mmod, "B", 3, 3)
        _put(controller, mmod, "W", 9, 9)
        rec.bound["<ButtonPress-1>"](_Event(*_center(widget, 3, 3)))
        rec.bound["<ButtonRelease-1>"](_Event(*_center(widget, 9, 9)))
    elif name == "right_delete":
        _put(controller, mmod, "B", 4, 4)
        widget.redraw()
        rec.bound["<Button-3>"](_Event(*_center(widget, 4, 4)))
        rec.bound["<Button-3>"](_Event(*_center(widget, 10, 10)))


def _moves(controller):
    return [(m.color, m.row, m.col) for m in controller.kifu.moves()]


def _fixes(corrections):
    return [tuple(None if m is None else (m.color, m.row, m.col)
                  for m in pair) for pair in corrections]


@pytest.mark.parametrize("gesture", ["redraw", "click_put", "drag_relocate",
                                     "drag_occupied", "right_delete"])
def test_goban_records_the_references_canvas_items(monkeypatch, gesture):
    """The same game and gesture on both packages' ``Goban``: equal canvas
    items (every ``create_line`` / ``create_oval`` with its arguments),
    bindings, kifus, stones, corrections and the next manual colour."""
    (jw, jc, jfix), (w, c, fix) = _goban_pair(monkeypatch)
    assert w._rec.items == jw._rec.items          # the first redraw
    _gesture(gesture, jw, jc, jmove)
    _gesture(gesture, w, c, move)
    assert set(w._rec.bound) == set(jw._rec.bound) == {
        "<ButtonPress-1>", "<B1-Motion>", "<ButtonRelease-1>", "<Button-3>"}
    assert w._rec.items == jw._rec.items
    assert _moves(c) == _moves(jc)
    assert np.array_equal(c.stones(), jc.stones())
    assert _fixes(fix) == _fixes(jfix)
    assert w.select_color == jw.select_color
    assert w._ghost is None and jw._ghost is None


def test_resolve_press_release_matches_the_reference():
    from camkifu_tpu.gui.goban import resolve_press_release as jresolve
    from camkifu_tpu_torch.gui.goban import resolve_press_release

    stones = np.zeros((19, 19), np.int8)
    stones[3, 3], stones[9, 9] = 1, 2
    cases = [((5, 5), (5, 5)), ((3, 3), (3, 3)), ((3, 3), (8, 11)),
             ((9, 9), (0, 0)), ((3, 3), (9, 9)), ((5, 5), (6, 6)),
             ((3, 3), (19, 4)), ((-1, 0), (-1, 0))]
    for press, release in cases:
        assert resolve_press_release(stones, press, release, 19) == \
            jresolve(stones, press, release, 19)


# ---------------------------------------------------------------------------
# The UI / VUI shell on a fake widget layer.
# ---------------------------------------------------------------------------


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
        self.radios: list[str] = []

    def add_command(self, label=None, command=None, **kw):
        self.commands[label] = command

    def add_radiobutton(self, label=None, command=None, **kw):
        self.commands[label] = command
        self.radios.append(label)

    def add_separator(self):
        pass

    def add_cascade(self, label=None, menu=None, **kw):
        self.cascades[label] = menu


class _FakeWidget:
    def __init__(self, master=None, **kw):
        self.kw = kw

    def grid(self, **kw):
        pass


class _FakeMaster:
    def __init__(self):
        self.bindings: dict[str, object] = {}
        self.after_calls: list = []
        self.menu = None

    def bind(self, seq, fn):
        self.bindings[seq] = fn

    def config(self, menu=None, **kw):
        self.menu = menu

    def after(self, ms, fn):
        self.after_calls.append((ms, fn))

    def destroy(self):
        pass


@pytest.fixture
def fake_tk(monkeypatch):
    _patch_canvas(monkeypatch)
    monkeypatch.setattr(tk.Frame, "__init__",
                        lambda self, master=None, **kw: None)
    monkeypatch.setattr(tk.Frame, "pack", lambda self, **kw: None)
    monkeypatch.setattr(tk, "Menu", _FakeMenu)
    monkeypatch.setattr(tk, "StringVar", _FakeVar)
    monkeypatch.setattr(tk, "DoubleVar", _FakeVar)
    monkeypatch.setattr(tk, "Label", _FakeWidget)
    monkeypatch.setattr(tk, "Button", _FakeWidget)
    monkeypatch.setattr(tk, "Scale", _FakeWidget)


def _vui_stack(port: bool):
    if port:
        from camkifu_tpu_torch.board.bf_manual import BoardFinderManual
        from camkifu_tpu_torch.core.capture import ArrayCapture
        from camkifu_tpu_torch.core.vmanager import VManagerSeq
        from camkifu_tpu_torch.gui.vui import VUI
        from camkifu_tpu_torch.stone.sf_clustering import SfClustering
        kw = {"device": "cpu"}
        controller = controllerv.ControllerVSeq()
    else:
        from camkifu_tpu.board.bf_manual import BoardFinderManual
        from camkifu_tpu.core.capture import ArrayCapture
        from camkifu_tpu.core.vmanager import VManagerSeq
        from camkifu_tpu.gui.vui import VUI
        from camkifu_tpu.stone.sf_clustering import SfClustering
        kw = {}
        controller = jcontrollerv.ControllerVSeq()
    vm = VManagerSeq(controller, video=None, bf_class=BoardFinderManual,
                     sf_class=SfClustering, batch=8, **kw)
    vm.capture = ArrayCapture(np.zeros((10, 8, 8, 3), np.uint8))
    master = _FakeMaster()
    return VUI(master, controller, vm), controller, vm, master


def _menu_tree(menu):
    return {"commands": sorted(menu.commands), "radios": menu.radios,
            "cascades": {k: _menu_tree(v) for k, v in menu.cascades.items()}}


def test_vui_menus_radios_and_keys_match_the_reference(fake_tk):
    """The same menu labels and cascades, the same finder radios in the
    same order with the same defaults, the same key bindings, the same
    drain period."""
    jvui, _, _, jmaster = _vui_stack(port=False)
    vui, _, _, master = _vui_stack(port=True)
    assert master.menu is vui.menubar
    assert _menu_tree(vui.menubar) == _menu_tree(jvui.menubar)
    video = vui.menubar.cascades["Video"]
    assert video.cascades["Board finder"].radios == \
        [c.label for c in cvconf.bfinders()]
    assert video.cascades["Stones finder"].radios == \
        [c.label for c in cvconf.sfinders()]
    assert vui._bf_var.get() == jvui._bf_var.get()
    assert vui._sf_var.get() == jvui._sf_var.get()
    assert set(master.bindings) == set(jmaster.bindings) == {
        "<Left>", "<Right>", "<Home>", "<End>"}
    assert [ms for ms, _ in master.after_calls] == \
        [ms for ms, _ in jmaster.after_calls] == [50]


def test_vui_commands_drive_the_port_runtime(fake_tk):
    from camkifu_tpu_torch.stone.sf_meta import SfMeta

    vui, controller, vm, master = _vui_stack(port=True)
    video = vui.menubar.cascades["Video"]
    video.cascades["Stones finder"].commands[SfMeta.label]()
    assert isinstance(vm.stones_finder, SfMeta)
    assert controller.stones_finder is vm.stones_finder
    video.commands["Pause"]()
    assert vm.stones_finder.paused
    video.commands["Resume"]()
    assert not vm.stones_finder.paused
    controller.api["vidpos"](0.5)
    assert vm.capture.pos == 5


def test_vui_drain_pipe_redraws_status_and_slider(fake_tk):
    vui, controller, vm, master = _vui_stack(port=True)
    vm.instantiate_finders()
    vm.stones_finder.metadata["fps"] = 42
    vm.capture.set_position(0.3)
    controller.pipe("append", move.Move("np", (move.B, 6, 6)))
    vui._drain_pipe()
    assert controller.stones()[6, 6] == 1
    assert [k for a, k in vui.goban._rec.ovals() if k.get("fill") == "#111"]
    assert "fps=42" in vui.status.get()
    assert abs(vui.position.get() - 0.3) < 1e-9
    assert master.after_calls[-1][0] == 50
    # Keyboard navigation and status events, as in the reference.
    controller.pipe("append", move.Move("np", (move.W, 9, 9)))
    controller.process_pipe()
    master.bindings["<Left>"](None)
    assert controller.nav.position == 1
    master.bindings["<End>"](None)
    assert (controller.stones() != 0).sum() == 2
    controller._notify("error", "boom")
    assert vui.status.get() == "error: boom"


def test_ui_save_and_open_round_trip(fake_tk, tmp_path, monkeypatch):
    from tkinter import filedialog

    vui, controller, vm, master = _vui_stack(port=True)
    controller.pipe("append", move.Move("np", (move.B, 3, 3)))
    controller.process_pipe()
    path = str(tmp_path / "game.sgf")
    monkeypatch.setattr(filedialog, "asksaveasfilename", lambda **kw: path)
    vui.menubar.cascades["File"].commands["Save As…"]()
    assert "B[dd]" in open(path).read()
    vui2, c2, _, _ = _vui_stack(port=True)
    monkeypatch.setattr(filedialog, "askopenfilename", lambda **kw: path)
    vui2.menubar.cascades["File"].commands["Open SGF…"]()
    assert _moves(c2) == [(move.B, 3, 3)]
    assert c2.stones()[3, 3] == 1


# ---------------------------------------------------------------------------
# The preview window.
# ---------------------------------------------------------------------------


class _FakePhoto:
    last = None

    def __init__(self, data=None, format=None):
        self.data = data
        self.format = format
        _FakePhoto.last = self


@pytest.fixture
def fake_toplevel(monkeypatch):
    after_calls: list = []
    monkeypatch.setattr(tk.Toplevel, "__init__",
                        lambda self, master=None, **kw: None)
    monkeypatch.setattr(tk.Toplevel, "title", lambda self, t: None)
    monkeypatch.setattr(tk.Toplevel, "protocol",
                        lambda self, name, fn: None)
    monkeypatch.setattr(tk.Toplevel, "after",
                        lambda self, ms, fn: after_calls.append((ms, fn)))
    monkeypatch.setattr(tk, "PhotoImage", _FakePhoto)

    class _FakeLabel:
        def __init__(self, master=None, **kw):
            self.bound = {}
            self.image = None

        def pack(self, **kw):
            pass

        def bind(self, seq, fn):
            self.bound[seq] = fn

        def configure(self, image=None, **kw):
            self.image = image

    monkeypatch.setattr(tk, "Label", _FakeLabel)
    return after_calls


def test_video_window_renders_overlay_and_scales_clicks(fake_toplevel):
    from camkifu_tpu_torch.gui.video_window import MAX_W, REFRESH_MS, \
        VideoWindow

    clicks: list = []
    bf = type("BF", (), {
        "corners_array": np.array([[100.0, 50.0], [200.0, 50.0],
                                   [200.0, 150.0], [100.0, 150.0]]),
        "metadata": {"detect": "0.9"},
        "onclick": lambda self, x, y: clicks.append((x, y)),
    })()
    vm = type("VM", (), {})()
    vm.board_finder = bf
    vm.device = torch.device("cpu")
    vm.last_frame = np.zeros((240, 320, 3), np.uint8)

    win = VideoWindow(None, vm)
    assert win.label.image is _FakePhoto.last
    assert _FakePhoto.last.format == "PPM"
    head = b"P6 320 240 255 "
    assert _FakePhoto.last.data.startswith(head)
    annotated = np.frombuffer(_FakePhoto.last.data[len(head):],
                              np.uint8).reshape(240, 320, 3)
    # A red (255, 40, 40) stroke touches each corner's ring.
    for x, y in bf.corners_array.astype(int):
        patch = annotated[y - 8:y + 8, x - 8:x + 8]
        assert (patch[..., 0] == 255).any()
    assert win.scale == 1.0
    assert not vm.last_frame.any()           # the frame itself is untouched
    win._on_click(_Event(150, 100))
    assert clicks[-1] == (150.0, 100.0)
    # Wide frames stride for display; clicks scale back to frame pixels.
    vm.last_frame = np.zeros((540, 1920, 3), np.uint8)
    win._tick()
    step = int(np.ceil(1920 / MAX_W))
    assert win.scale == 1.0 / step
    assert _FakePhoto.last.data.startswith(
        f"P6 {1920 // step} {540 // step} 255 ".encode())
    win._on_click(_Event(100, 60))
    assert clicks[-1] == (100.0 * step, 60.0 * step)
    assert fake_toplevel and all(ms == REFRESH_MS == 100
                                 for ms, _ in fake_toplevel)


# ---------------------------------------------------------------------------
# core/imgutil's drawing against cv2's.
# ---------------------------------------------------------------------------

#: Measured over these draws (seeded): rings of radius 2–40 and the
#: reference's lines differ from cv2's by at most 23 / 22 DN at a pixel
#: (at a polygon's joints and a line's ends) and by at most 2.9 / 3.6 DN on
#: average over the pixels either touches; the preview's overlay by 17 and
#: 0.27. The atlas's text is within 1 DN of ``cv2.putText``.
RING_MAX, RING_MEAN = 24, 3.0
LINE_MAX, LINE_MEAN = 24, 4.0
TEXT_MAX = 1


def _touched(ours, ref, bg):
    d = np.abs(ours.astype(int) - ref.astype(int))
    m = (ref != bg).any(-1) | (ours != bg).any(-1)
    return d.max(), (d[m].mean() if m.any() else 0.0)


@pytest.mark.parametrize("radius", [2, 3, 5, 8, 12, 20, 40])
def test_draw_circles_matches_cv2(radius):
    rng = np.random.default_rng(radius)
    for _ in range(6):
        bg = rng.integers(0, 256, (120, 160, 3)).astype(np.uint8)
        c = (float(rng.uniform(-10, 170)), float(rng.uniform(-10, 130)))
        ref = jimgutil.draw_circles(bg.copy(), [c], radius=radius,
                                    color=(255, 40, 40))
        img = torch.from_numpy(bg.copy())
        out = imgutil.draw_circles(img, [c], radius=radius,
                                   color=(255, 40, 40))
        assert out is img                        # drawn in place
        worst, mean = _touched(out.numpy(), ref, bg)
        assert worst <= RING_MAX and mean <= RING_MEAN, (c, worst, mean)


def test_draw_lines_matches_cv2():
    rng = np.random.default_rng(1)
    for _ in range(60):
        bg = rng.integers(0, 256, (120, 160, 3)).astype(np.uint8)
        p = rng.uniform(-20, 180, 4)
        segs = [jimgutil.Segment((p[0], p[1] * 0.75), (p[2], p[3] * 0.75))]
        ref = jimgutil.draw_lines(bg.copy(), segs)
        out = imgutil.draw_lines(
            torch.from_numpy(bg.copy()),
            [imgutil.Segment(s.p1, s.p2) for s in segs]).numpy()
        worst, mean = _touched(out, ref, bg)
        assert worst <= LINE_MAX and mean <= LINE_MEAN, (p, worst, mean)


def test_a_primitive_touches_only_its_box():
    """Outside a ring's box (radius + 3 around its centre) and outside a
    string's glyph window, no pixel changes."""
    bg = np.random.default_rng(0).integers(0, 256, (200, 300, 3),
                                           ).astype(np.uint8)
    out = imgutil.draw_circles(torch.from_numpy(bg.copy()), [(150, 100)],
                               radius=8).numpy()
    changed = np.nonzero((out != bg).any(-1))
    assert changed[0].min() >= 100 - 11 and changed[0].max() <= 100 + 11
    assert changed[1].min() >= 150 - 11 and changed[1].max() <= 150 + 11
    out = imgutil.draw_str(torch.from_numpy(bg.copy()), "ab",
                           origin=(40, 60)).numpy()
    rows = np.nonzero((out != bg).any(-1))[0]
    assert rows.min() >= 60 - 14 and rows.max() <= 60 + 4


@pytest.mark.parametrize("text", ["fps: 12.5", "track_trip: None",
                                  "corners: [[100.0, 50.0], [200.0, 50.0]]",
                                  "".join(chr(c) for c in range(32, 80)),
                                  "".join(chr(c) for c in range(80, 127)),
                                  "tab\there, bell\x07"])
def test_draw_str_matches_cv2_put_text(text):
    """Every printable ASCII glyph, on a flat and a random background,
    near the image's edges too; a control character is cv2's '?'."""
    rng = np.random.default_rng(len(text))
    for bg in (np.full((40, 420, 3), 120, np.uint8),
               rng.integers(0, 256, (40, 420, 3)).astype(np.uint8)):
        for origin in ((10, 20), (-3, 9), (300, 38)):
            ref = jimgutil.draw_str(bg.copy(), text, origin=origin,
                                    color=(30, 200, 90))
            out = imgutil.draw_str(torch.from_numpy(bg.copy()), text,
                                   origin=origin, color=(30, 200, 90))
            assert np.abs(out.numpy().astype(int) - ref).max() <= TEXT_MAX


def test_draw_metadata_matches_cv2_rows_18_px_apart():
    meta = {"fps": 12.5, "frame": 42, "track_trip": None,
            "corners": [[100.0, 50.0], [200.0, 50.0]], "lens_k1": 0.0}
    bg = np.random.default_rng(3).integers(0, 256, (140, 400, 3)
                                           ).astype(np.uint8)
    ref = jimgutil.draw_metadata(bg.copy(), meta)
    out = imgutil.draw_metadata(torch.from_numpy(bg.copy()), meta).numpy()
    assert np.abs(out.astype(int) - ref).max() <= TEXT_MAX
    # Line k is draw_str's at y = 20 + 18 k.
    by_hand = torch.from_numpy(bg.copy())
    for k, (key, value) in enumerate(sorted(meta.items())):
        imgutil.draw_str(by_hand, f"{key}: {value}", origin=(10, 20 + 18 * k))
    assert np.array_equal(by_hand.numpy(), out)


def test_annotate_preview_matches_the_references_overlay():
    """The preview's pixels: the reference's ``VideoWindow._annotate``
    (cv2 rings, then the metadata) against ``annotate_preview`` on the
    CPU, at 1080p."""
    rng = np.random.default_rng(5)
    frame = rng.integers(0, 256, (1080, 1920, 3)).astype(np.uint8)
    corners = np.array([[312.4, 201.7], [1601.2, 188.9], [1688.0, 930.5],
                        [240.6, 951.3]], np.float32)
    meta = {"detect": 0.93, "frame": 1234, "lens_k1": 0.0,
            "track_trip": None}
    ref = jimgutil.draw_metadata(jimgutil.draw_circles(
        frame.copy(), [(x, y) for x, y in corners], radius=8,
        color=(255, 40, 40)), meta)
    out = imgutil.annotate_preview(frame, corners, meta, "cpu")
    assert out.device.type == "cpu" and out.dtype == torch.uint8
    worst, mean = _touched(out.numpy(), ref, frame)
    assert worst <= RING_MAX and mean <= RING_MEAN
    assert not np.array_equal(out.numpy(), frame)
    assert np.array_equal(imgutil.annotate_preview(frame, None, {}, "cpu")
                          .numpy(), frame)


def test_a_missing_glyph_atlas_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(imgutil, "ATLAS_PATH", str(tmp_path / "none.npz"))
    imgutil._atlas_host.cache_clear()
    imgutil._atlas_on.cache_clear()
    try:
        with pytest.raises(FileNotFoundError, match="atlas"):
            imgutil.draw_str(torch.zeros(30, 60, 3, dtype=torch.uint8), "x")
        with pytest.raises(FileNotFoundError, match="atlas"):
            imgutil.draw_circles(torch.zeros(30, 60, 3, dtype=torch.uint8),
                                 [(10, 10)])
    finally:
        imgutil._atlas_host.cache_clear()
        imgutil._atlas_on.cache_clear()
