"""Board sizes 9 and 13 in the port's reading paths against the JAX
reference on the CPU: ``pipeline.read_board_batch`` at 9 and 13 and
``sf_meta.read_batch`` over a short 9×9 game (the canonical image is 144²
and 208², the background grid 36² and 52², the 3×3 trust regions split an
odd lattice); and, the port alone, a 9×9 game through
``filecheck.run_pipeline`` with automatic detection to its moves. Inputs
come from the port's numpy renderer; the JAX side runs jitted."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from camkifu_tpu import pipeline as jpipeline
from camkifu_tpu.stone import sf_meta as jmeta
from camkifu_tpu_torch import filecheck, pipeline
from camkifu_tpu_torch.config import cvconf
from camkifu_tpu_torch.core.gamesync import score_moves
from camkifu_tpu_torch.stone import sf_meta
from camkifu_tpu_torch.utils import still

torch.set_num_threads(1)

HW = (360, 640)


def _t(a):
    return torch.from_numpy(np.array(a))


def _stones(g: int, n: int, seed: int) -> np.ndarray:
    labels = np.zeros((g, g), np.int8)
    idx = np.random.default_rng(seed).choice(g * g, n, replace=False)
    labels.flat[idx[::2]] = 1
    labels.flat[idx[1::2]] = 2
    return labels


@pytest.mark.parametrize("g", [9, 13])
def test_read_board_batch_matches_jax(g):
    """Two noisy frames of a board with stones on every edge region:
    labels equal (and equal to the truth), confidence within 1e-4."""
    labels = _stones(g, 2 * g, seed=g)
    frames, corners = [], None
    for seed in (1, 2):
        f, corners = still.render_still(labels, frame_hw=(480, 854),
                                        seed=seed)
        frames.append(f)
    frames = np.stack(frames)
    lab_j, conf_j = jpipeline.read_board_batch(
        jnp.asarray(frames), jnp.asarray(corners), gsize=g)
    lab_t, conf_t = pipeline.read_board_batch(_t(frames), _t(corners),
                                              gsize=g)
    assert lab_t.shape == (2, g, g) and lab_t.dtype == torch.int8
    assert np.array_equal(lab_t.numpy(), np.asarray(lab_j))
    assert np.array_equal(lab_t.numpy()[0], labels)
    assert np.abs(conf_t.numpy() - np.asarray(conf_j)).max() < 1e-4


def _game9():
    """A seeded 4-move 9×9 game from a fixed camera: 4 frames of the empty
    board, then ``vote_window + 2`` frames a move."""
    moves = still.sample_moves(4, gsize=9, seed=2)
    frames, corners = still.render_game(
        moves, cvconf.vote_window + 2, frame_hw=HW, gsize=9, seed=3,
        empty_leadin=4)
    return moves, frames, corners


def test_read_batch_9x9_game_matches_jax():
    """The vote scan at gsize 9 over two batches, the second padded:
    labels and the stable board equal, votes and the rest of the state
    within 1e-4."""
    _, frames, corners = _game9()
    fb1 = frames[:16]
    fb2 = np.concatenate([frames[16:28], np.repeat(frames[27:28], 4, 0)])
    st_j = jmeta.init_state(gsize=9)
    st_t = sf_meta.init_state(gsize=9, device="cpu")
    assert st_t.bg.shape == (36, 36)
    for fb, vc in ((fb1, None), (fb2, 12)):
        st_j, lab_j, conf_j, agit_j = jmeta.read_batch(
            st_j, jnp.asarray(fb), jnp.asarray(corners), gsize=9,
            valid_count=None if vc is None else jnp.int32(vc))
        st_t, lab_t, conf_t, agit_t = sf_meta.read_batch(
            st_t, _t(fb), _t(corners), gsize=9, valid_count=vc)
        assert lab_t.shape == (16, 9, 9)
        assert np.array_equal(lab_t.numpy(), np.asarray(lab_j))
        assert np.abs(conf_t.numpy() - np.asarray(conf_j)).max() < 1e-4
        assert np.abs(agit_t.numpy() - np.asarray(agit_j)).max() < 1e-5
        got = sf_meta.meta_state_to_numpy(st_t)
        assert np.array_equal(got["stable"], np.asarray(st_j.stable))
        assert int(got["frame_count"]) == int(st_j.frame_count)
        for k in ("votes", "bg", "prev", "trust"):
            np.testing.assert_allclose(got[k], np.asarray(getattr(st_j, k)),
                                       atol=1e-4, err_msg=k)
    assert int(st_t.frame_count) == 28
    assert st_t.stable.ne(0).any()              # a stone was committed


def test_run_pipeline_reads_a_9x9_game():
    """The recorded-video path at gsize 9, detection included, on the CPU:
    every move, and the detected corners within 0.2 cell of the truth
    (batches of 4: detection runs on the first batch, and its stage 1
    costs seconds a frame on one CPU thread)."""
    moves, frames, corners = _game9()
    ex, stats = filecheck.run_pipeline(iter(frames), corners=None, batch=4,
                                       gsize=9, device="cpu")
    assert score_moves(ex.moves, moves)["agreement"] == 1.0
    cell = float(np.linalg.norm(corners[1] - corners[0])) / 8
    assert np.abs(np.asarray(stats["corners"]) - corners).max() < 0.2 * cell
