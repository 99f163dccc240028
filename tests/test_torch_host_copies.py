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
from camkifu_tpu.utils import synth
from camkifu_tpu_torch import filecheck
from camkifu_tpu_torch.config import cvconf, guiconf
from camkifu_tpu_torch.core import controllerv, gamesync
from camkifu_tpu_torch.core.vmanager import VManagerBase
from camkifu_tpu_torch.gamemodel import kifu, move, rules, sgf
from camkifu_tpu_torch.stone import sf_meta

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
    """The reference's registries in its order, without the finders the
    port has not ported (SfBgSub, SfNeural: ROADMAP Queue A item 8)."""
    unported = {"SfBgSub", "SfNeural"}
    for ours, ref in ((cvconf.bfinders(), jcvconf.bfinders()),
                      (cvconf.sfinders(), jcvconf.sfinders())):
        want = [(c.__name__, c.label) for c in ref
                if c.__name__ not in unported]
        assert [(c.__name__, c.label) for c in ours] == want
        assert all(c.__module__.startswith("camkifu_tpu_torch.")
                   for c in ours)
