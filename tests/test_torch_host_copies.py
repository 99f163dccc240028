"""The port's copies of the reference's host code against the reference, on
the CPU: the vision constants, the rules engine, the move extractor, and
the entry points' default device."""

import dataclasses
import inspect

import numpy as np
import pytest
import torch

from camkifu_tpu.config import cvconf as jcvconf
from camkifu_tpu.config import guiconf as jguiconf
from camkifu_tpu.core import gamesync as jgamesync
from camkifu_tpu.gamemodel import move as jmove
from camkifu_tpu.gamemodel import rules as jrules
from camkifu_tpu.utils import synth
from camkifu_tpu_torch import filecheck
from camkifu_tpu_torch.config import cvconf, guiconf
from camkifu_tpu_torch.core import gamesync
from camkifu_tpu_torch.gamemodel import move, rules
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
                                sf_meta.meta_state_from_numpy])
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
