"""The port's handheld path against the JAX reference on the CPU, whole:
the two tracking engines (``track_corners_batch``, ``rectify_track_batch``)
under a drifting, a rotating and a zooming camera, then the slice
(``sf_meta.track_read_batch``, and ``read_batch`` / ``read_board_batch``
with per-frame corners) on a seeded handheld game, the vote state carried
across packages; and, the port alone, a game drawn by its own renderer read
to its kifu. The JAX side runs jitted, as ``tests/test_tracking.py`` runs it;
the port runs the plain warp (CPU tensors)."""

import functools

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from camkifu_tpu.board import bf_auto as jbf
from camkifu_tpu.config import cvconf
from camkifu_tpu.stone import sf_meta as jmeta
from camkifu_tpu.utils import synth
from camkifu_tpu import pipeline as jpipeline
from camkifu_tpu_torch import pipeline
from camkifu_tpu_torch.board import bf_auto
from camkifu_tpu_torch.core.gamesync import MoveExtractor, score_moves
from camkifu_tpu_torch.stone import sf_meta
from camkifu_tpu_torch.utils import still

torch.set_num_threads(1)

HW = (480, 854)
G = 19
#: Corners, in frame px (the reference's own tests allow 0.15 cell ≈ 3 px).
TOL_PX = 0.02
#: Sharpness and alignment, relative to the larger of |reference| and 1
#: (the alignment of an empty board's frames can be exactly 0).
TOL_REL = 1e-3
#: Canonical images in [0, 1]. The two packages' corners differ by up to
#: 1e-3 px and their source coordinates in the last bits; across a grid
#: line's edge (0.6 of the range a pixel) that shows as a few 1e-4.
TOL_CANON = 5e-4
TOL_CANON_MEAN = 1e-5

#: Camera motions at 480×854 (tests/test_tracking.py's, scaled from 720p).
MOTIONS = {
    "drift": dict(drift=(8.0, 6.0), periods=(5.0, 6.0)),
    "rotate": dict(drift=(4.0, 2.7), periods=(5.0, 6.0), rate_deg=0.15),
    "zoom": dict(drift=(4.0, 2.7), periods=(5.0, 6.0), scale_rate=0.002),
}


def _t(a):
    return torch.from_numpy(np.array(a))


@functools.lru_cache(maxsize=3)
def _moving(motion: str):
    """32 frames of a midgame board under one camera motion, and the true
    corners of each."""
    labels = np.zeros((G, G), np.int8)
    idx = np.random.default_rng(1).choice(G * G, 80, replace=False)
    labels.flat[idx[:40]] = 1
    labels.flat[idx[40:]] = 2
    corners = still.handheld_corners(32, HW, **MOTIONS[motion])
    frames = np.stack([synth.render_frame(labels, c, HW, seed=21)[0]
                       for c in corners])
    return frames, corners


def _cell(corners) -> float:
    return float(np.linalg.norm(corners[0][1] - corners[0][0]) / (G - 1))


def _close(got, ref, tol, rel=False, what=""):
    got, ref = np.asarray(got), np.asarray(ref)
    err = np.abs(got - ref) / (np.maximum(np.abs(ref), 1.0) if rel else 1.0)
    assert err.max() <= tol, (what, float(err.max()))


def _same_canon(got, ref):
    err = np.abs(np.asarray(got) - np.asarray(ref))
    assert err.max() <= TOL_CANON, float(err.max())
    assert err.mean() <= TOL_CANON_MEAN, float(err.mean())


@pytest.mark.parametrize("motion", sorted(MOTIONS))
def test_track_corners_batch_matches_jax(motion):
    """Two batches of 16 frames, chunk 8, the second seeded with the
    first's ``new_seed`` in each package."""
    frames, truth = _moving(motion)
    seed_j, seed_t = jnp.asarray(truth[0]), _t(truth[0])
    for lo in (0, 16):
        fb = frames[lo:lo + 16]
        cs_j, sharp_j, align_j, seed_j = jbf.track_corners_batch(
            jnp.asarray(fb), seed_j, chunk=8, res=320)
        cs_t, sharp_t, align_t, seed_t = bf_auto.track_corners_batch(
            _t(fb), seed_t, chunk=8, res=320)
        assert cs_t.shape == (16, 4, 2) and cs_t.dtype == torch.float32
        _close(cs_t, cs_j, TOL_PX, what="corners")
        _close(seed_t, seed_j, TOL_PX, what="new_seed")
        _close(sharp_t, sharp_j, TOL_REL, rel=True, what="sharp")
        _close(align_t, align_j, TOL_REL, rel=True, what="align")
        assert torch.equal(seed_t, cs_t[-1])
        assert np.abs(cs_t.numpy() - truth[lo:lo + 16]).max() \
            < 0.15 * _cell(truth)
        assert (sharp_t >= bf_auto.TRACK_MIN_SHARPNESS).all()


@pytest.mark.parametrize("motion", sorted(MOTIONS))
def test_rectify_track_batch_matches_jax(motion):
    frames, truth = _moving(motion)
    seed_j, seed_t = jnp.asarray(truth[0]), _t(truth[0])
    for lo in (0, 16):
        fb = frames[lo:lo + 16]
        canon_j, cs_j, sharp_j, align_j, seed_j = jbf.rectify_track_batch(
            jnp.asarray(fb), seed_j, chunk=8)
        canon_t, cs_t, sharp_t, align_t, seed_t = \
            bf_auto.rectify_track_batch(_t(fb), seed_t, chunk=8)
        assert canon_t.shape == (16, 304, 304, 3)
        _same_canon(canon_t, canon_j)
        _close(cs_t, cs_j, TOL_PX, what="corners")
        _close(seed_t, seed_j, TOL_PX, what="new_seed")
        _close(sharp_t, sharp_j, TOL_REL, rel=True, what="sharp")
        _close(align_t, align_j, TOL_REL, rel=True, what="align")
        assert np.abs(cs_t.numpy() - truth[lo:lo + 16]).max() \
            < 0.15 * _cell(truth)


@pytest.mark.parametrize("engine", ["track_corners_batch",
                                    "rectify_track_batch"])
def test_engines_pad_the_last_chunk(engine):
    """B = 20, chunk 8: the last chunk holds 4 frames and 4 repeats of the
    last; outputs are cut back to 20 and ``new_seed`` is the last frame's
    corners."""
    frames, truth = _moving("drift")
    out_j = getattr(jbf, engine)(jnp.asarray(frames[:20]),
                                 jnp.asarray(truth[0]), chunk=8)
    out_t = getattr(bf_auto, engine)(_t(frames[:20]), _t(truth[0]), chunk=8)
    cs_t, cs_j = out_t[-4], out_j[-4]
    assert cs_t.shape == (20, 4, 2) and out_t[-3].shape == (20,)
    _close(cs_t, cs_j, TOL_PX, what="corners")
    _close(out_t[-1], out_j[-1], TOL_PX, what="new_seed")
    _close(out_t[-1], cs_t[-1], 1e-6, what="new_seed is the last frame's")
    if engine == "rectify_track_batch":
        assert out_t[0].shape == (20, 304, 304, 3)
        _same_canon(out_t[0], out_j[0])


def test_a_bad_seed_moves_the_crop_not_the_clamp_order():
    """A seed 0.6 cell off: the lattice lock pushes dx past the crop's
    integer headroom, where the two clamps' order decides the crop. Both
    packages give the same canonical images and corners."""
    frames, truth = _moving("drift")
    cell = _cell(truth)
    seed = truth[0] + np.array([0.6 * cell, -0.5 * cell], np.float32)
    out_j = jbf.rectify_track_batch(jnp.asarray(frames[:16]),
                                    jnp.asarray(seed), chunk=8)
    out_t = bf_auto.rectify_track_batch(_t(frames[:16]), _t(seed), chunk=8)
    _same_canon(out_t[0], out_j[0])
    _close(out_t[1], out_j[1], TOL_PX, what="corners")
    _close(out_t[2], out_j[2], TOL_REL, rel=True, what="sharp")


# -- the slice whole --------------------------------------------------------------

@functools.lru_cache(maxsize=1)
def _handheld_game():
    """The first 32 frames of a seeded handheld game (6 frames of the empty
    board, then 11 a move), drawn by the reference's renderer under the
    drifting camera of tests/test_tracking.py, at 480×854."""
    moves = synth.sample_moves(3, seed=5)
    fpm = cvconf.vote_window + 3
    corners = still.handheld_corners(6 + 3 * fpm, HW, drift=(8.0, 6.0))
    frames = [synth.render_frame(lab, corners[t], HW, seed=5 + t)[0]
              for t, (_, lab) in enumerate(synth.render_game(
                  moves, frames_per_move=fpm, frame_hw=HW, seed=5,
                  empty_leadin=6))]
    return np.stack(frames[:32]), corners[:32]


def _same_state(ours: sf_meta.MetaState, ref, atol=1e-4):
    ref = {k: np.asarray(v) for k, v in ref._asdict().items()}
    got = sf_meta.meta_state_to_numpy(ours)
    assert np.array_equal(got["stable"], ref["stable"])
    assert int(got["frame_count"]) == int(ref["frame_count"])
    for k in ("votes", "bg", "prev", "trust"):
        np.testing.assert_allclose(got[k], ref[k], atol=atol, err_msg=k)


def test_track_read_batch_two_batches_match_jax():
    """Batch 1 from fresh states in both packages; batch 2, padded after
    13 frames, continues in the port from JAX's state and seed: labels and
    the stable board equal, the rest within the tolerances above."""
    frames, truth = _handheld_game()
    fb1 = frames[:16]
    fb2 = np.concatenate([frames[16:29], np.repeat(frames[28:29], 3, 0)])
    out_j = jmeta.track_read_batch(jmeta.init_state(), jnp.asarray(fb1),
                                   jnp.asarray(truth[0]))
    out_t = sf_meta.track_read_batch(sf_meta.init_state(device="cpu"),
                                     _t(fb1), _t(truth[0]))
    out_j2 = jmeta.track_read_batch(out_j[0], jnp.asarray(fb2), out_j[7],
                                    valid_count=jnp.int32(13))
    out_t2 = sf_meta.track_read_batch(
        sf_meta.meta_state_from_numpy(out_j[0], "cpu"), _t(fb2),
        _t(out_j[7]), valid_count=13)
    for (st_t, lab_t, conf_t, agit_t, cs_t, sharp_t, align_t, seed_t), \
            (st_j, lab_j, conf_j, agit_j, cs_j, sharp_j, align_j, seed_j) \
            in ((out_t, out_j), (out_t2, out_j2)):
        assert lab_t.dtype == torch.int8
        assert np.array_equal(lab_t.numpy(), np.asarray(lab_j))
        _close(conf_t, conf_j, 1e-4, what="conf")
        _close(agit_t, agit_j, 1e-5, what="agitation")
        _close(cs_t, cs_j, TOL_PX, what="corners")
        _close(seed_t, seed_j, TOL_PX, what="new_seed")
        _close(sharp_t, sharp_j, TOL_REL, rel=True, what="sharp")
        _close(align_t, align_j, TOL_REL, rel=True, what="align")
        _same_state(st_t, st_j)
    assert int(out_t2[0].frame_count) == 29
    assert out_t2[1].numpy()[-1].any()          # a stone was committed


def test_read_batch_with_per_frame_corners_matches_jax():
    """The unfused pair: ``track_corners_batch``'s corners into
    ``read_batch``'s chunked warp, in each package."""
    frames, truth = _handheld_game()
    fb = frames[16:32]
    cs_j, _, _, _ = jbf.track_corners_batch(jnp.asarray(fb),
                                            jnp.asarray(truth[16]), res=320)
    cs_t, _, _, _ = bf_auto.track_corners_batch(_t(fb), _t(truth[16]),
                                                res=320)
    st_j, lab_j, conf_j, agit_j = jmeta.read_batch(
        jmeta.init_state(), jnp.asarray(fb), cs_j)
    st_t, lab_t, conf_t, agit_t = sf_meta.read_batch(
        sf_meta.init_state(device="cpu"), _t(fb), cs_t)
    assert np.array_equal(lab_t.numpy(), np.asarray(lab_j))
    _close(conf_t, conf_j, 1e-4, what="conf")
    _close(agit_t, agit_j, 1e-5, what="agitation")
    _same_state(st_t, st_j)


def test_read_board_batch_with_per_frame_corners_matches_jax():
    """Labels equal, confidence within the fixed-camera test's 5e-3 (k-means
    on a board of three stones: a frame whose canonical image differs by
    6e-5 can settle 2e-2 apart, as frame 18 of this game does)."""
    frames, truth = _handheld_game()
    fb, cs = frames[22:32], truth[22:32]        # B = 10: a padded chunk
    lab_j, conf_j = jpipeline.read_board_batch(jnp.asarray(fb),
                                               jnp.asarray(cs))
    lab_t, conf_t = pipeline.read_board_batch(_t(fb), _t(cs))
    assert lab_t.shape == (10, G, G)
    assert np.array_equal(lab_t.numpy(), np.asarray(lab_j))
    _close(conf_t, conf_j, 5e-3, what="conf")


@pytest.mark.parametrize("entry", ["track_corners_batch",
                                   "rectify_track_batch", "track_read_batch",
                                   "read_batch", "read_board_batch"])
def test_entry_points_refuse_a_lens(entry):
    """A ``lens`` that is not an ``ops.lens.Lens`` raises TypeError (the
    lens model is in tests/test_torch_lens*.py)."""
    frames = torch.zeros((2, 32, 32, 3), dtype=torch.uint8)
    seed = torch.zeros((4, 2))
    state = sf_meta.init_state(device="cpu")
    calls = {
        "track_corners_batch": lambda: bf_auto.track_corners_batch(
            frames, seed, lens=object()),
        "rectify_track_batch": lambda: bf_auto.rectify_track_batch(
            frames, seed, lens=object()),
        "track_read_batch": lambda: sf_meta.track_read_batch(
            state, frames, seed, lens=object()),
        "read_batch": lambda: sf_meta.read_batch(state, frames, seed,
                                                 lens=object()),
        "read_board_batch": lambda: pipeline.read_board_batch(
            frames, seed, lens=object()),
    }
    with pytest.raises(TypeError, match="Lens"):
        calls[entry]()


def test_handheld_game_reads_to_its_kifu():
    """The port alone, on a game drawn by its own renderer under a drifting
    camera (tests/test_tracking.py's handheld game, at 360×640): one
    detection, then ``track_read_batch`` in batches of 16 → every move,
    every frame's corners within 0.15 cell of the truth. (At this size
    one batch's correlation peaks are blunt, sharpness 1.4–1.8, and two of
    its frames hold their neighbours' measurement.)"""
    hw = (360, 640)
    moves = still.sample_moves(10, seed=5)
    fpm = cvconf.vote_window + 3
    truth = still.handheld_corners(6 + 10 * fpm, hw, drift=(6.0, 4.5))
    frames, _ = still.render_game(moves, fpm, frame_hw=hw, seed=5,
                                  empty_leadin=6, corners=truth)
    assert frames.shape == (6 + 10 * fpm,) + hw + (3,)
    seed, score = bf_auto.detect_corners(_t(frames[0]))
    assert float(score) > 0.1
    state = sf_meta.init_state(device="cpu")
    ex = MoveExtractor()
    tracked, sharps = [], []
    for lo in range(0, len(frames), 16):
        fb = frames[lo:lo + 16]
        n = fb.shape[0]
        if n < 16:
            fb = np.concatenate([fb, np.repeat(fb[-1:], 16 - n, 0)])
        state, labels, _, _, cs, sharp, _, seed = sf_meta.track_read_batch(
            state, _t(fb), seed, valid_count=n)
        tracked.append(cs[:n].numpy())
        sharps.append(sharp[:n].numpy())
        for lab in labels[:n].numpy():
            ex.advance(lab)
    assert score_moves(ex.moves, moves)["agreement"] == 1.0
    cell = float(np.linalg.norm(truth[0][1] - truth[0][0]) / (G - 1))
    assert np.abs(np.concatenate(tracked) - truth).max() < 0.15 * cell
    sharps = np.concatenate(sharps)
    assert (sharps >= bf_auto.TRACK_MIN_SHARPNESS).mean() > 0.95
    assert int(state.frame_count) == len(frames)
