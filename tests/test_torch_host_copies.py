"""The port's copies of the reference's host code against the reference, on
the CPU: the vision constants, the rules engine, the move extractor, the
SGF format and the kifu, the controller, the finder registries, and the
entry points' default device."""

import dataclasses
import inspect
import re

import numpy as np
import pytest
import torch

from camkifu_tpu.config import cvconf as jcvconf
from camkifu_tpu.config import guiconf as jguiconf
from camkifu_tpu.core import controllerv as jcontrollerv
from camkifu_tpu.core import gamesync as jgamesync
from camkifu_tpu.gamemodel import kifu as jkifu
from camkifu_tpu.gamemodel import move as jmove
from camkifu_tpu.gamemodel import rules as jrules
from camkifu_tpu.gamemodel import sgf as jsgf
from camkifu_tpu.core import capture as jcapture
from camkifu_tpu.core import video as jvideo
from camkifu_tpu.core import vmanager as jvmanager
from camkifu_tpu.utils import board_to_ascii as jboard_to_ascii
from camkifu_tpu.utils import synth
from camkifu_tpu_torch import filecheck
from camkifu_tpu_torch.config import cvconf, guiconf
from camkifu_tpu_torch.core import capture, controllerv, gamesync, video
from camkifu_tpu_torch.core.vmanager import VManagerBase, VManagerSeq
from camkifu_tpu_torch.gamemodel import kifu, move, rules, sgf
from camkifu_tpu_torch.stone import sf_meta
from camkifu_tpu_torch.utils import board_to_ascii

CONSTANTS = ["zone_size", "canonical_size", "frame_batch", "vote_window",
             "vote_threshold", "vote_min_conf", "agitation_threshold",
             "background_ema", "bf_period", "bf_resolution", "hough_thetas",
             "hough_rhos", "hough_topk"]

#: A game with a one-stone capture (move 3) and a two-stone capture (the
#: last move), in turn throughout.
CAPTURES = [("B", 0, 1), ("W", 0, 0), ("B", 1, 0), ("W", 5, 5), ("B", 4, 5),
            ("W", 5, 6), ("B", 4, 6), ("W", 10, 10), ("B", 6, 5),
            ("W", 10, 11), ("B", 6, 6), ("W", 10, 12), ("B", 5, 4),
            ("W", 10, 13), ("B", 5, 7)]


@pytest.mark.parametrize("name", CONSTANTS)
def test_cvconf_constant_matches_the_reference(name):
    assert getattr(cvconf, name) == getattr(jcvconf, name)


def test_vision_config_matches_the_reference():
    ours = dataclasses.asdict(cvconf.VisionConfig())
    ref = dataclasses.asdict(jcvconf.VisionConfig())
    assert ours == ref
    assert dataclasses.asdict(cvconf.DEFAULT) == ref
    assert cvconf.DEFAULT.canonical_size == jcvconf.DEFAULT.canonical_size
    assert guiconf.gsize == jguiconf.gsize


def test_move_coordinates_match_the_reference():
    for kind, value in (("sgf", ("B", "pd")), ("np", ("W", 3, 15)),
                        ("sgf", ("W", "tt")), ("sgf", ("B", ""))):
        ours, ref = move.Move(kind, value), jmove.Move(kind, value)
        assert (ours.color, ours.row, ours.col, ours.sgf, ours.is_pass) == \
            (ref.color, ref.row, ref.col, ref.sgf, ref.is_pass)
    assert move.opposite(move.B) == jmove.opposite(jmove.B)


def _play(rule_mod, move_mod, seq):
    """Put and confirm each (color, row, col) of ``seq``; return the
    captures of each move as tuples and the final labels."""
    rule = rule_mod.RuleUnsafe()
    caps = []
    for color, r, c in seq:
        got = rule.put(move_mod.Move("np", (color, r, c)))
        rule.confirm()
        caps.append(sorted((m.color, m.row, m.col) for m in got))
    return caps, rule.as_labels(), rule


def test_rules_captures_match_the_reference():
    caps, labels, rule = _play(rules, move, CAPTURES)
    jcaps, jlabels, jrule = _play(jrules, jmove, CAPTURES)
    assert caps == jcaps
    assert caps[2] == [("W", 0, 0)]
    assert caps[-1] == [("W", 5, 5), ("W", 5, 6)]
    assert np.array_equal(labels, jlabels)
    # The same refusals: an occupied point and a suicide.
    for color, r, c in (("W", 0, 1), ("W", 0, 0)):
        with pytest.raises(rules.IllegalMove):
            rule.put(move.Move("np", (color, r, c)))
        with pytest.raises(jrules.IllegalMove):
            jrule.put(jmove.Move("np", (color, r, c)))


def _readings(seq, lag: bool):
    """Label grids after each move of ``seq`` (reference rules), each
    shown twice; with ``lag``, a capture's first reading still shows the
    captured stones, as when a player has not yet lifted them."""
    rule = jrules.RuleUnsafe()
    out = []
    for color, r, c in seq:
        before = rule.as_labels()
        got = rule.put(jmove.Move("np", (color, r, c)))
        rule.confirm()
        after = rule.as_labels()
        if lag and got:
            shown = after.copy()
            for m in got:
                shown[m.row, m.col] = before[m.row, m.col]
            out.append(shown)
        out += [after, after]
    return out


def _extract(mod, readings):
    ex = mod.MoveExtractor()
    for reading in readings:
        ex.advance(reading)
    return ([(m.color, m.row, m.col, m.number) for m in ex.moves],
            ex.rejected, ex.state())


@pytest.mark.parametrize("game", ["sampled", "captures"])
def test_move_extractor_matches_the_reference(game):
    if game == "sampled":
        seq = [(m.color, m.row, m.col)
               for m in synth.sample_moves(40, seed=7)]
    else:
        seq = CAPTURES
    readings = _readings(seq, lag=True)
    ours = _extract(gamesync, readings)
    ref = _extract(jgamesync, readings)
    assert ours[0] == ref[0]
    assert [m[:3] for m in ours[0]] == seq
    assert ours[1] == ref[1]
    assert np.array_equal(ours[2], ref[2])


def test_score_moves_matches_the_reference():
    seq = [(m.color, m.row, m.col) for m in synth.sample_moves(12, seed=5)]
    detected = seq[:4] + seq[5:] + [("B", 18, 18)]
    for a, b in ((detected, seq), (seq, seq), ([], seq)):
        ours = gamesync.score_moves([move.Move("np", m) for m in a],
                                    [move.Move("np", m) for m in b],
                                    with_ops=True)
        ref = jgamesync.score_moves([jmove.Move("np", m) for m in a],
                                    [jmove.Move("np", m) for m in b],
                                    with_ops=True)
        assert ours == ref


@pytest.mark.parametrize("fn", [filecheck.run_pipeline, sf_meta.init_state,
                                sf_meta.meta_state_from_numpy,
                                filecheck.run_runtime, VManagerBase])
def test_entry_point_defaults_to_the_card(fn):
    """The default device is CUDA as written in the signature, not chosen
    from the machine when the module is imported."""
    assert inspect.signature(fn).parameters["device"].default == "cuda"


def test_init_state_does_not_fall_back_to_the_cpu():
    if torch.cuda.is_available():
        assert sf_meta.init_state().votes.is_cuda
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            sf_meta.init_state()
    assert sf_meta.init_state(device="cpu").votes.device.type == "cpu"


def test_runtime_does_not_fall_back_to_the_cpu():
    """Without a card the runtime raises unless the caller asks for the
    CPU."""
    frames = [np.zeros((32, 32, 3), np.uint8)] * 2
    if not torch.cuda.is_available():
        with pytest.raises((AssertionError, RuntimeError)):
            filecheck.run_runtime(frames, batch=2)
    moves, stats = filecheck.run_runtime(frames, batch=2, device="cpu")
    assert moves == [] and stats["frames"] == 2


SGF_TEXTS = [
    "(;FF[4]GM[1]SZ[19]PB[Hon.]PW[Go S.]KM[0];B[pd];W[dp];B[qp]\n"
    "(;W[dd];B[oq])(;W[cd]))",
    r"(;FF[4]C[bracket \] and backslash \\ here];B[aa])",
    "(;FF[3]SZ[9]AB[cc][gg]AW[cg]ae[cc];W[ee];B[];W[tt])\n(;B[aa])",
    "\ufeff  (;GM[1]SZ[13];B[ab];W[ba]) (;SZ[9];B[ee])",
]


@pytest.mark.parametrize("text", SGF_TEXTS)
def test_sgf_round_trip_matches_the_reference(text):
    ours, ref = sgf.parse(text), jsgf.parse(text)
    assert sgf.serialize(ours) == jsgf.serialize(ref)
    assert sgf.serialize(sgf.parse(sgf.serialize(ours))) == \
        sgf.serialize(ours)
    assert [repr(n) for n in ours[0].mainline()] == \
        [repr(n) for n in ref[0].mainline()]


@pytest.mark.parametrize("text", ["not sgf at all", "(;B[aa", "(;B)", "()"])
def test_sgf_errors_match_the_reference(text):
    with pytest.raises(sgf.SgfError):
        sgf.parse(text)
    with pytest.raises(jsgf.SgfError):
        jsgf.parse(text)


def _kifu_session(kmod, mmod, path):
    """append / insert / relocate / delete / mark / info, saved and loaded
    back; → (SGF text, the loaded kifu's moves, setup stones)."""
    k = kmod.Kifu.new(path)
    for m in synth.sample_moves(8, seed=4):
        k.append(mmod.Move("np", (m.color, m.row, m.col)))
    k.insert(mmod.Move("np", ("B", 9, 9)), 3)
    k.insert(mmod.Move("np", ("W", 18, 18)), 99)
    err = k.moves()[5]
    k.relocate(err, mmod.Move("np", (err.color, 0, 18)))
    k.delete(k.moves()[1])
    k.mark(k.moves()[0])
    k.set_info("PB", "vision")
    k.save()
    with open(path, encoding="utf-8") as f:
        text = f.read()
    loaded = kmod.Kifu.load(path)
    return (text, [(m.color, m.row, m.col, m.number) for m in loaded.moves()],
            loaded.gsize, loaded.modified, len(loaded), loaded.next_color())


def test_kifu_matches_the_reference(tmp_path):
    """The same moves and the same SGF text, but for the date (``DT``)."""
    ours = _kifu_session(kifu, move, str(tmp_path / "a.sgf"))
    ref = _kifu_session(jkifu, jmove, str(tmp_path / "b.sgf"))
    strip = lambda t: re.sub(r"DT\[[^]]*\]", "", t)   # noqa: E731
    assert strip(ours[0]) == strip(ref[0])
    assert "DT[" in ours[0]
    assert ours[1:] == ref[1:]
    setup = "(;FF[4]SZ[9]AB[cc][gg]AW[cg]AE[cc];B[ee];W[ff])"
    (tmp_path / "s.sgf").write_text(setup)
    ours = kifu.Kifu.load(str(tmp_path / "s.sgf")).setup_stones()
    ref = jkifu.Kifu.load(str(tmp_path / "s.sgf")).setup_stones()
    assert [(m.color, m.row, m.col) for m in ours] == \
        [(m.color, m.row, m.col) for m in ref]


def _navigate(cmod, mmod):
    """tests/test_runtime.py's controller commands: appends through the
    pipe, browsing back and forth; → the board and cursor at each step."""
    c = cmod.ControllerVSeq()
    seen = []
    for m in synth.sample_moves(6, seed=13):
        c.pipe("append", mmod.Move("np", (m.color, m.row, m.col)))
    for cmd in ("backward", "backward", "forward", "end", "beginning",
                "end"):
        c.pipe(cmd)
        seen.append((c.nav.position, c.stones().tolist()))
    return seen


def test_controller_navigation_matches_the_reference():
    assert _navigate(controllerv, move) == _navigate(jcontrollerv, jmove)


def _deferred(cmod, mmod):
    """Vision appends and a bulk correction while the user browses: both
    wait for the cursor to return (tests/test_runtime.py:197,
    tests/test_bulk_correction.py:95)."""
    c = cmod.ControllerVSeq()
    events = []
    c.listeners.append(lambda e, *a: events.append(e))
    c.pipe("append", mmod.Move("np", ("B", 3, 3)))
    c.pipe("append", mmod.Move("np", ("W", 9, 9)))
    c.pipe("append", mmod.Move("np", ("B", 5, 5)))
    c.pipe("backward")
    c.pipe("append", mmod.Move("np", ("W", 15, 15)))
    c.pipe("bulk", [(None, mmod.Move("np", ("B", 9, 10))),
                    (mmod.Move("np", ("B", 3, 3)),
                     mmod.Move("np", ("B", 3, 4))),
                    (mmod.Move("np", ("W", 1, 1)), None)])
    before = (len(c.kifu), c.nav.position)
    c.pipe("end")
    return (before, len(c.kifu), c.nav.position, events,
            [(m.color, m.row, m.col) for m in c.kifu.moves()],
            c.rules.copystones().tolist())


def test_controller_deferred_updates_match_the_reference():
    ours = _deferred(controllerv, move)
    assert ours == _deferred(jcontrollerv, jmove)
    assert ours[0] == (3, 2) and ours[1] == 5


def test_finder_registries_match_the_reference():
    """The reference's registries, every finder, in its order."""
    for ours, ref in ((cvconf.bfinders(), jcvconf.bfinders()),
                      (cvconf.sfinders(), jcvconf.sfinders())):
        want = [(c.__name__, c.label) for c in ref]
        assert [(c.__name__, c.label) for c in ours] == want
        assert all(c.__module__.startswith("camkifu_tpu_torch.")
                   for c in ours)


@pytest.mark.parametrize("gsize,zone", [(9, 16), (13, 16), (19, 16), (19, 8)])
def test_canonical_size_for_matches_the_reference(gsize, zone):
    assert cvconf.canonical_size_for(gsize, zone) \
        == jcvconf.canonical_size_for(gsize, zone)
    assert cvconf.canonical_size_for(gsize) == jcvconf.canonical_size_for(
        gsize)


def test_board_to_ascii_matches_the_reference():
    labels = np.random.default_rng(8).integers(0, 3, (19, 19)).astype(
        np.int8)
    assert board_to_ascii(labels) == jboard_to_ascii(labels)
    assert board_to_ascii(labels[:9, :9]).count("\n") == 8


def _processed(video_mod, manager, frames, fail_at=None):
    """A VidProcessor of ``video_mod`` over ``manager`` reading ``frames``
    from an ArrayCapture in batches of 2 through its own ``execute``: the
    (frames, n) of every batch, the frame count, the last error."""

    class Recorder(video_mod.VidProcessor):
        def __init__(self, vm):
            super().__init__(vm)
            self.seen = []

        def _doframe(self, batch, n=None):
            self.seen.append((np.asarray(batch).copy(), n))
            if len(self.seen) == fail_at:
                raise ValueError("batch rejected")

    proc = Recorder(manager)
    proc.execute()
    return proc.seen, proc.total_frames, proc.metadata["frame"], \
        proc.last_error


@pytest.mark.parametrize("fail_at", [None, 2])
def test_read_batch_and_execute_match_the_reference(fail_at):
    """``VManagerBase.read_batch`` over an ArrayCapture and
    ``VidProcessor.execute`` on it, against the reference's: the same
    padded batches and valid counts, frames counted, an error in a batch
    recorded and the loop going on. The port's batch comes on the
    manager's device (here the CPU), copied once."""
    frames = np.random.default_rng(9).integers(0, 256, (5, 12, 16, 3),
                                               dtype=np.uint8)
    vm = VManagerSeq(None, video=None, batch=2, device="cpu")
    vm.capture = capture.ArrayCapture(frames)
    jvm = jvmanager.VManagerSeq(None, video=None, batch=2)
    jvm.capture = jcapture.ArrayCapture(frames)
    first = vm.read_batch()
    assert isinstance(first[0], torch.Tensor) and first[0].device.type == "cpu"
    ref_first = jvm.read_batch()
    assert np.array_equal(first[0].numpy(), ref_first[0])
    assert first[1:] == ref_first[1:]
    ours = _processed(video, vm, frames, fail_at)
    ref = _processed(jvideo, jvm, frames, fail_at)
    assert [n for _, n in ours[0]] == [n for _, n in ref[0]] == [2, 1]
    assert all(np.array_equal(a, b) for (a, _), (b, _) in zip(ours[0],
                                                              ref[0]))
    assert ours[1:] == ref[1:]
    assert ours[3] == (None if fail_at is None
                       else "ValueError: batch rejected")


def test_gui_constants_match_the_reference():
    for name in ("gsize", "canvas_size", "stone_ratio", "background"):
        assert getattr(guiconf, name) == getattr(jguiconf, name)


SEGMENTS = [((0, 0), (10, 0)), ((5, -5), (5, 5)), ((1.5, 2.25), (-7, 11)),
            ((3, 3), (3, 3)), ((0, 1), (10, 1)), ((-4.0, 8.5), (12.0, -1.0))]


@pytest.mark.parametrize("a", range(len(SEGMENTS)))
def test_segment_matches_the_reference(a):
    from camkifu_tpu.core import imgutil as jimgutil
    from camkifu_tpu_torch.core import imgutil

    ours, ref = imgutil.Segment(*SEGMENTS[a]), jimgutil.Segment(*SEGMENTS[a])
    assert (ours.p1, ours.p2, ours.norm, ours.angle, repr(ours)) == \
        (ref.p1, ref.p2, ref.norm, ref.angle, repr(ref))
    for pt in ((3, 4), (0, 0), (-2.5, 7.25)):
        assert ours.distance_to(pt) == ref.distance_to(pt)
    for other in SEGMENTS:
        assert ours.intersection(imgutil.Segment(*other)) == \
            ref.intersection(jimgutil.Segment(*other))


def test_around_cyclic_buffer_and_order_corners_match_the_reference():
    from camkifu_tpu.core import imgutil as jimgutil
    from camkifu_tpu_torch.core import imgutil

    for args in ((0, 0), (9, 9, 2), (18, 0, 1, 19, True), (4, 8, 3, 9),
                 (12, 12, 1, 13, True)):
        assert list(imgutil.around(*args)) == list(jimgutil.around(*args))
    ours, ref = imgutil.CyclicBuffer((2,), 3), jimgutil.CyclicBuffer((2,), 3)
    for i in range(5):
        assert np.array_equal(ours.view(), ref.view()) \
            and len(ours) == len(ref)
        ours.append([i, -i])
        ref.append([i, -i])
    assert np.array_equal(ours.view(), ref.view())
    assert ours.view().dtype == ref.view().dtype
    pts = np.array([[100, 100], [10, 90], [95, 5], [12, 8]], np.float32)
    for perm in ([0, 1, 2, 3], [3, 2, 1, 0], [1, 3, 0, 2], [2, 0, 3, 1]):
        assert np.array_equal(imgutil.order_corners(pts[perm]),
                              jimgutil.order_corners(pts[perm]))


def test_oracle_cv2_is_the_reference_on_the_port_s_host_code():
    """``oracle_cv2`` is the reference's module, function for function,
    with its host imports (config, ``MoveExtractor``, ``order_corners``)
    taken from the port; tests/test_torch_oracle_cv2.py holds its
    answers to the reference's."""
    from camkifu_tpu import oracle_cv2 as joracle
    from camkifu_tpu.board import boardfinder as jboardfinder
    from camkifu_tpu_torch import oracle_cv2
    from camkifu_tpu_torch.board import boardfinder

    names = [n for n, f in vars(joracle).items()
             if inspect.isfunction(f) and f.__module__ == joracle.__name__]
    assert len(names) == 9
    for name in names:
        ours = inspect.getsource(getattr(oracle_cv2, name))
        ref = inspect.getsource(getattr(joracle, name))
        assert ours.replace("camkifu_tpu_torch.", "camkifu_tpu.") == ref, \
            name
    assert oracle_cv2.MoveExtractor is gamesync.MoveExtractor
    assert oracle_cv2.cvconf is cvconf and oracle_cv2.guiconf is guiconf
    assert "camkifu_tpu_torch.board.boardfinder import order_corners" in \
        inspect.getsource(oracle_cv2.detect_corners_cv2)
    pts = np.array([[100, 100], [10, 90], [95, 5], [12, 8]], np.float32)
    assert np.array_equal(boardfinder.order_corners(pts),
                          jboardfinder.order_corners(pts))
