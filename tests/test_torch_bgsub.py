"""The port's background-subtraction finder (``stone.sf_bgsub``) against
the JAX reference on the CPU: a recorded game batch by batch, the
exposure shift, a padded tail, vote invalidation, the even-count disc
median, and the finder registry."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from camkifu_tpu.config import cvconf as jcvconf
from camkifu_tpu.core.gamesync import MoveExtractor, score_moves
from camkifu_tpu.ops.warp import warp_to_canonical
from camkifu_tpu.stone import sf_bgsub as jbgsub
from camkifu_tpu.utils import synth
from camkifu_tpu_torch.config import cvconf
from camkifu_tpu_torch.stone import sf_bgsub

torch.set_num_threads(1)

HW = (360, 640)
BATCH = 16

#: bg, prev, conf and agitation against the reference's from the same
#: canonical images: the exposure gain is a bin center that XLA rounds by
#: an ulp either way (tests/test_torch_film.py), and every later EMA step
#: carries it.
ATOL = 1e-6

#: The same from the same frames: the two packages' warps sample up to
#: 5e-5 apart (their homography solves round differently), as in
#: tests/test_torch_film.py.
WARP_ATOL = 1e-4


@jax.jit
def _jscan(state, canon, valid):
    """The reference's scan of ``sf_bgsub.read_batch`` after its warp."""
    def body(carry, x):
        canonical, v = x
        new_carry, outs = jbgsub.step_frame(carry, canonical)
        return jax.tree.map(lambda n, o: jnp.where(v, n, o), new_carry,
                            carry), outs

    state, outs = jax.lax.scan(body, state, (canon, valid))
    return (state,) + outs


_jwarp = jax.jit(jax.vmap(
    lambda f, c: warp_to_canonical(f, c) * (1.0 / 255.0), in_axes=(0, None)))


def _torch_state(state_j):
    return sf_bgsub.BgSubState(*(torch.from_numpy(np.array(x))
                                 for x in state_j))


def _same(ours, ref, atol=ATOL):
    """States equal: votes, stable and frame_count exactly; bg and prev
    within ``atol``."""
    for name in ("votes", "stable", "frame_count"):
        assert np.array_equal(getattr(ours, name).numpy(),
                              np.asarray(getattr(ref, name))), name
    for name in ("bg", "prev"):
        np.testing.assert_allclose(getattr(ours, name).numpy(),
                                   np.asarray(getattr(ref, name)),
                                   atol=atol, rtol=0, err_msg=name)


def _same_outs(out_t, out_j, atol):
    _same(out_t[0], out_j[0], atol)
    assert np.array_equal(out_t[1].numpy(), np.asarray(out_j[1]))
    for k in (2, 3):
        np.testing.assert_allclose(out_t[k].numpy(), np.asarray(out_j[k]),
                                   atol=atol, rtol=0)


def _read_both(state_t, state_j, frames, corners, valid_count=None):
    """Both packages' ``read_batch`` on the same frames, each from its own
    state, and the port's scan on the reference's canonical images from the
    reference's state, held to the reference."""
    b = len(frames)
    vc = b if valid_count is None else valid_count
    out_j = jbgsub.read_batch(state_j, jnp.asarray(frames),
                              jnp.asarray(corners),
                              valid_count=None if valid_count is None
                              else jnp.int32(valid_count))
    canon = _jwarp(jnp.asarray(frames), jnp.asarray(corners))
    scan_j = _jscan(state_j, canon, jnp.arange(b) < vc)
    scan_t = sf_bgsub._scan_canonical(_torch_state(state_j), torch.from_numpy(
        np.array(canon)), 19, 16, valid_count)
    _same_outs(scan_t, scan_j, ATOL)
    out_t = sf_bgsub.read_batch(state_t, torch.from_numpy(frames),
                                torch.from_numpy(corners),
                                valid_count=valid_count)
    _same_outs(out_t, out_j, WARP_ATOL)
    return out_t, out_j


@pytest.fixture(scope="module")
def game():
    """tests/test_sf_bgsub.py's game: 8 moves (seed 12), vote_window + 3
    frames a move after 5 empty ones, fixed camera."""
    moves = synth.sample_moves(8, seed=12)
    frames = [f for f, _ in synth.render_game(
        moves, frames_per_move=jcvconf.vote_window + 3, frame_hw=HW,
        empty_leadin=5)]
    return moves, np.stack(frames), synth.default_corners(HW)


def test_read_batch_matches_jax_over_the_game(game):
    """Batch by batch, the last one padded, as the reference's test feeds
    it: every state field, label, confidence and agitation equal, and the
    game read exactly."""
    moves, frames, corners = game
    state_t = sf_bgsub.init_state(device="cpu")
    state_j = jbgsub.init_state()
    ex = MoveExtractor()
    for i in range(0, len(frames), BATCH):
        chunk = frames[i:i + BATCH]
        n = len(chunk)
        if n < BATCH:
            chunk = np.concatenate([chunk, np.repeat(chunk[-1:], BATCH - n,
                                                     0)])
        (state_t, labels, _, _), (state_j, *_) = _read_both(
            state_t, state_j, chunk, corners)
        for j in range(n):
            ex.advance(labels[j].numpy())
    assert score_moves(ex.moves, moves)["agreement"] == 1.0


def test_padded_tail_leaves_the_carry_untouched(game):
    """valid_count: the padded frames read against the last real frame's
    carry, which they leave as it is (frame_count included), as the
    reference's ``jnp.where`` over the whole carry; 0 real frames too."""
    _, frames, corners = game
    state_t = sf_bgsub.init_state(device="cpu")
    state_j = jbgsub.init_state()
    (state_t, *_), (state_j, *_) = _read_both(state_t, state_j,
                                              frames[:BATCH], corners)
    chunk = frames[BATCH + 40:2 * BATCH + 40]
    for vc in (5, 0):
        (st, *_), _ = _read_both(state_t, state_j, chunk, corners,
                                 valid_count=vc)
        assert int(st.frame_count) == BATCH + vc
    # The padding changes nothing: 5 real frames and 11 repeats of frames
    # past them leave the state 5 real frames alone leave.
    alone = sf_bgsub.read_batch(state_t, torch.from_numpy(chunk[:5]),
                                torch.from_numpy(corners))[0]
    padded = sf_bgsub.read_batch(state_t, torch.from_numpy(chunk),
                                 torch.from_numpy(corners), valid_count=5)[0]
    for a, b in zip(alone, padded):
        assert torch.equal(a, b)


def test_exposure_shift_reads_no_phantom_stones():
    """tests/test_sf_meta.py's exposure shift: the empty board learned,
    two stones placed, then every frame dimmed 28%: both packages read the
    stones and nothing else, equal step by step."""
    empty = np.zeros((19, 19), np.int8)
    labels = empty.copy()
    labels[3, 3] = 1
    labels[15, 15] = 2
    corners = synth.default_corners(HW)

    def batch(lab, n, seed0=0):
        return np.stack([synth.render_frame(lab, corners=corners,
                                            frame_hw=HW, seed=seed0 + i)[0]
                         for i in range(n)])

    state_t = sf_bgsub.init_state(device="cpu")
    state_j = jbgsub.init_state()
    (state_t, *_), (state_j, *_) = _read_both(state_t, state_j,
                                              batch(empty, 8), corners)
    frames = batch(labels, jcvconf.vote_window + 4)
    (state_t, out, *_), (state_j, *_) = _read_both(state_t, state_j, frames,
                                                   corners)
    assert np.array_equal(out[-1].numpy(), labels)
    dimmed = np.clip(frames.astype(np.float32) * 0.72, 0, 255) \
        .astype(np.uint8)
    (_, out2, *_), _ = _read_both(state_t, state_j, dimmed, corners)
    assert np.array_equal(out2[-1].numpy(), labels)


def test_reset_votes_matches_jax(game):
    _, frames, corners = game
    state_t, *_ = sf_bgsub.read_batch(sf_bgsub.init_state(device="cpu"),
                                      torch.from_numpy(frames[60:76]),
                                      torch.from_numpy(corners))
    state_j = jbgsub.BgSubState(*(jnp.asarray(x.numpy()) for x in state_t))
    assert state_t.stable.numpy().any()
    pos = [(int(r), int(c)) for r, c in np.argwhere(state_t.stable.numpy())]
    pos = pos[:2] + [(0, 18)]
    _same(sf_bgsub.reset_votes(state_t, pos),
          jbgsub.reset_votes(state_j, pos), atol=0)
    assert not sf_bgsub.reset_votes(state_t, pos).stable[pos[0]].any()


def test_disc_median_takes_the_two_middle_values():
    """148 disc pixels (zone 16): the median averages the 74th and 75th
    values as ``jnp.median`` does, (a + b) · 0.5; ``torch.median`` returns
    the lower one, and would flip a stone on |med| > 0.13."""
    rng = np.random.default_rng(4)
    x = np.concatenate([np.arange(148, dtype=np.float32)[None],
                        rng.normal(0, 0.2, (64, 148)).astype(np.float32)])
    ours = sf_bgsub.disc_median(torch.from_numpy(x)).numpy()
    ref = np.asarray(jnp.median(jnp.asarray(x), axis=-1))
    assert np.array_equal(ours, ref)
    assert ours[0] == 73.5
    lower = torch.median(torch.from_numpy(x), dim=-1).values.numpy()
    assert lower[0] == 73.0 and (lower != ref).sum() == len(x)
    odd = rng.random((3, 9), np.float32)
    assert np.array_equal(sf_bgsub.disc_median(torch.from_numpy(odd)),
                          np.median(odd, axis=-1))


def test_finder_registry_holds_the_references_order():
    """cvconf.sfinders(): the reference's six finders in its order, the
    default first."""
    from camkifu_tpu.config import cvconf as ref

    assert [(c.__name__, c.label) for c in cvconf.sfinders()] == \
        [(c.__name__, c.label) for c in ref.sfinders()]
    assert [c.label for c in cvconf.sfinders()] == \
        ["meta", "clustering", "contours", "bgsub", "neural", "tutorial"]
