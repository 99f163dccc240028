"""Board sizes off 19 in the port's handheld tracker and size inference:
``bf_auto.rectify_track_batch`` at gsize 13 (a 240² canvas, a 208²
canonical image) against the JAX reference on the CPU under a drifting
camera, and, the port alone, ``infer_gsize`` on 9×9, 13×13 and 19×19
boards (the true size with a margin; each candidate's quality equal to a
separate ``_gsize_probe``'s, though stage 1 runs once; 0 where no
candidate finds a board)."""

import functools

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from camkifu_tpu.board import bf_auto as jbf
from camkifu_tpu_torch.board import bf_auto
from camkifu_tpu_torch.utils import still

torch.set_num_threads(1)

HW = (480, 854)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, ref, tol, rel=False, what=""):
    got, ref = np.asarray(got), np.asarray(ref)
    err = np.abs(got - ref) / (np.maximum(np.abs(ref), 1.0) if rel else 1.0)
    assert err.max() <= tol, (what, float(err.max()))


def test_rectify_track_batch_at_13_matches_jax():
    """16 frames of a 13×13 midgame board under
    tests/test_torch_track_engines.py's drifting camera, chunk 8, two
    batches: corners within 1e-3 px, the sharpness gates equal, sharpness
    and alignment within 1e-3, canonical images within 5e-4; corners
    within 0.15 cell of the truth."""
    g = 13
    labels = np.zeros((g, g), np.int8)
    idx = np.random.default_rng(4).choice(g * g, 40, replace=False)
    labels.flat[idx[:20]] = 1
    labels.flat[idx[20:]] = 2
    truth = still.handheld_corners(32, HW, drift=(8.0, 6.0),
                                   periods=(5.0, 6.0))
    frames = np.stack([still.render_still(labels, HW, seed=t, corners=c)[0]
                       for t, c in enumerate(truth)])
    cell = float(np.linalg.norm(truth[0][1] - truth[0][0])) / (g - 1)
    seed_j, seed_t = jnp.asarray(truth[0]), _t(truth[0])
    for lo in (0, 16):
        fb = frames[lo:lo + 16]
        canon_j, cs_j, sharp_j, align_j, seed_j = jbf.rectify_track_batch(
            jnp.asarray(fb), seed_j, gsize=g, chunk=8)
        canon_t, cs_t, sharp_t, align_t, seed_t = \
            bf_auto.rectify_track_batch(_t(fb), seed_t, gsize=g, chunk=8)
        assert canon_t.shape == (16, 208, 208, 3)
        _close(canon_t, canon_j, 5e-4, what="canon")
        _close(cs_t, cs_j, 1e-3, what="corners")
        _close(seed_t, seed_j, 1e-3, what="new_seed")
        gate = bf_auto.TRACK_MIN_SHARPNESS
        assert np.array_equal(sharp_t.numpy() >= gate,
                              np.asarray(sharp_j) >= gate)
        _close(sharp_t, sharp_j, 1e-3, rel=True, what="sharp")
        _close(align_t, align_j, 1e-3, rel=True, what="align")
        assert np.abs(cs_t.numpy() - truth[lo:lo + 16]).max() < 0.15 * cell


@functools.lru_cache(maxsize=3)
def _inferred(true_g: int):
    """tests/test_board_sizes.py's board of two stones at ``true_g``, and
    the port's ``infer_gsize`` of it."""
    labels = np.zeros((true_g, true_g), np.int8)
    labels[2, 2] = 1
    labels[true_g - 3, true_g - 3] = 2
    frame, _ = still.render_still(labels, frame_hw=HW, seed=true_g)
    return _t(frame), bf_auto.infer_gsize(_t(frame))


@pytest.mark.parametrize("true_g", [9, 13, 19])
def test_infer_gsize_picks_the_true_size(true_g):
    """tests/test_board_sizes.py's inference gate on the port: the true
    size wins with a 1.1× margin over the best wrong one."""
    g, quals = _inferred(true_g)[1]
    assert g == true_g, quals
    others = [q for k, q in quals.items() if k != true_g]
    assert quals[true_g] > 1.1 * max(others), quals


def test_infer_gsize_equals_three_separate_probes():
    """Stage 1 runs once inside ``infer_gsize``; every candidate's quality
    is still exactly what its own ``_gsize_probe`` reads."""
    frame, (g, quals) = _inferred(13)
    assert sorted(quals) == [9, 13, 19]
    for cand, q in quals.items():
        _, score, q_probe = bf_auto._gsize_probe(frame, gsize=cand)
        assert float(score) >= 0.1
        assert q == float(q_probe), (cand, q, float(q_probe))


def test_infer_gsize_reports_no_board():
    """A flat 720p frame, where stage 1 finds nothing (score 0): every
    candidate fails (−1.0), the answer is 0. The reference finds a phantom
    board in the resize's rounding dust here, a recorded departure
    (tests/test_torch_board_free.py)."""
    frame = torch.full((720, 1280, 3), 90, dtype=torch.uint8)
    g, quals = bf_auto.infer_gsize(frame)
    assert g == 0
    assert quals == {9: -1.0, 13: -1.0, 19: -1.0}
