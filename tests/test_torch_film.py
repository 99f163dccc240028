"""The port's film mode against the JAX reference on the CPU: the
background model, the vote machinery, the contours classifier, and
``sf_meta.read_batch`` over consecutive batches (padding included), a JAX
scan continued in the port, and a recorded game through the port's
``run_pipeline`` to its kifu."""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from camkifu_tpu.config import cvconf
from camkifu_tpu.core.gamesync import MoveExtractor, score_moves
from camkifu_tpu.gamemodel.move import Move
from camkifu_tpu.ops import background as jbg
from camkifu_tpu.ops.color import to_float
from camkifu_tpu.ops.warp import warp_to_canonical
from camkifu_tpu.stone import sf_contours as jcont
from camkifu_tpu.stone import sf_meta as jmeta
from camkifu_tpu.stone import votes as jvotes
from camkifu_tpu.utils import synth
from camkifu_tpu_torch import filecheck
from camkifu_tpu_torch.core import gamesync
from camkifu_tpu_torch.ops import background
from camkifu_tpu_torch.stone import sf_contours, sf_meta, votes
from camkifu_tpu_torch.utils import still

torch.set_num_threads(1)

HW = (360, 640)


def _t(a):
    return torch.from_numpy(np.array(a))


def _lumas(n=3, seed=0):
    """(n, 76, 76) luma grids in [0, 1]: smooth texture, each frame a
    gain and a local patch away from the first."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:76, 0:76] / 76.0
    base = 0.4 + 0.2 * np.sin(6 * xx + 3 * yy) + 0.02 * rng.random((76, 76))
    out = []
    for i in range(n):
        f = base * (1.0 + 0.07 * i)
        f[10 + 8 * i:30 + 8 * i, 20:44] += 0.3 * (i % 2)
        out.append(f)
    return np.clip(np.stack(out), 0, 1).astype(np.float32)


#: The reference as its jitted scan runs it: eager ``jnp.linspace`` rounds
#: the histogram edges with fused multiply-adds, traced it does not
#: (28 of 129 edges differ by an ulp), and the port follows the scan.
_jgain = jax.jit(jbg.robust_gain)

#: The gain is a bin center; XLA rounds the center by an ulp either way
#: depending on how it fuses the gather around it (14 of 128 centers move
#: under jit), so gains agree to 1e-6 relative, far inside the 0.0055-wide
#: bins: the same bin is chosen.
GAIN_REL = 1e-6


def test_background_matches_jax():
    x = _lumas()
    ours = background.downsample_luma(_t(np.repeat(np.repeat(x, 4, 1), 4, 2)))
    np.testing.assert_allclose(ours.numpy(), x, atol=1e-6)
    ref = np.asarray(jbg.downsample_luma(jnp.asarray(x[0]), 4))
    np.testing.assert_allclose(background.downsample_luma(_t(x[0])).numpy(),
                               ref, atol=1e-6)
    for i in range(3):
        g = background.robust_gain(_t(x[i]), _t(x[0]))
        assert float(g) == pytest.approx(float(_jgain(x[i], x[0])),
                                         rel=GAIN_REL)
        agit = background.agitation_score(_t(x[i]), _t(x[0]))
        assert abs(float(agit) - float(jbg.agitation_score(x[i], x[0]))) \
            < 1e-6
        for a in (0.0, 0.5):
            np.testing.assert_allclose(
                background.update_background(_t(x[0]), _t(x[i]),
                                             torch.tensor(a)).numpy(),
                np.asarray(jbg.update_background(x[0], x[i], jnp.asarray(a))),
                atol=1e-6)
    # Batched: one gain per frame.
    gains = background.robust_gain(_t(x), _t(x[:1]).expand(3, 76, 76))
    assert gains.tolist() == pytest.approx(
        [float(_jgain(f, x[0])) for f in x], rel=GAIN_REL)


@pytest.mark.parametrize("case", ["exact_hi", "exact_lo", "half_on_edge"])
def test_robust_gain_boundaries_match_jax(case):
    """Ratios clipped to exactly ``hi`` count into the last bin (the
    histogram's < test drops them), ratios clipped to ``lo`` into the
    first; the median bin is the first whose cumulative count reaches half
    (an argmax over a bool mask, which torch.argmax refuses)."""
    ref = np.full((40, 40), 0.5, np.float32)
    x = ref.copy()
    if case == "exact_hi":
        x[:25] = 0.9               # ratio 1.8 → clipped to 1.4 (62% of px)
    elif case == "exact_lo":
        x[:25] = 0.1               # ratio 0.2 → clipped to 0.7
    else:
        x[:20] = 0.5 * np.float32(1.05)   # half the pixels on one ratio
        x[20:] = 0.5 * np.float32(1.2)
    ours = float(background.robust_gain(_t(x), _t(ref)))
    assert ours == pytest.approx(
        float(_jgain(jnp.asarray(x), jnp.asarray(ref))), rel=GAIN_REL)
    if case == "exact_hi":
        edges = np.linspace(0.7, 1.4, 129, dtype=np.float32)
        assert ours == pytest.approx(0.5 * (edges[-2] + edges[-1]))
    # The bin edges are the traced jnp.linspace's, not torch.linspace's.
    np.testing.assert_array_equal(
        background._gain_edges(0.7, 1.4, 128, torch.device("cpu")).numpy(),
        np.asarray(jax.jit(lambda: jnp.linspace(0.7, 1.4, 129,
                                                dtype=jnp.float32))()))


def test_vote_update_matches_jax():
    rng = np.random.default_rng(1)
    g = 19
    v_t, s_t = torch.zeros((g, g, 3)), torch.zeros((g, g), dtype=torch.int8)
    v_j, s_j = jnp.zeros((g, g, 3)), jnp.zeros((g, g), jnp.int8)
    truth = rng.integers(0, 3, (g, g)).astype(np.int8)
    for step in range(12):
        labels = np.where(rng.random((g, g)) < 0.8, truth,
                          rng.integers(0, 3, (g, g))).astype(np.int8)
        conf = rng.random((g, g)).astype(np.float32)
        calm = (rng.random((g, g)) < 0.9).astype(np.float32)
        v_t, s_t, c_t = votes.vote_update(v_t, s_t, _t(labels), _t(conf),
                                          _t(calm))
        v_j, s_j, c_j = jvotes.vote_update(v_j, s_j, jnp.asarray(labels),
                                           jnp.asarray(conf),
                                           jnp.asarray(calm))
        np.testing.assert_allclose(v_t.numpy(), np.asarray(v_j), atol=1e-5)
        assert np.array_equal(s_t.numpy(), np.asarray(s_j))
        np.testing.assert_allclose(c_t.numpy(), np.asarray(c_j), atol=1e-6)
    assert s_t.dtype == torch.int8 and (s_t.numpy() == truth).mean() > 0.5


def test_vote_update_ties_keep_first_label():
    v = torch.zeros((1, 1, 3))
    v[0, 0] = torch.tensor([5.0, 5.0, 0.0])
    s = torch.zeros((1, 1), dtype=torch.int8)
    calm = torch.zeros((1, 1))
    nv, ns, _ = votes.vote_update(v, s, torch.zeros((1, 1), dtype=torch.int8),
                                  torch.zeros((1, 1)), calm)
    jv, js, _ = jvotes.vote_update(jnp.asarray(v.numpy()),
                                   jnp.asarray(s.numpy()),
                                   jnp.zeros((1, 1), jnp.int8),
                                   jnp.zeros((1, 1)), jnp.zeros((1, 1)))
    assert ns.tolist() == np.asarray(js).tolist() == [[0]]


def test_zone_motion_gate_matches_jax_per_frame():
    x = _lumas(4, seed=2)
    prev = np.concatenate([x[:1], x[:-1]])
    calm_t, agit_t = votes.zone_motion_gate(_t(x), _t(prev), 19)
    assert calm_t.shape == (4, 19, 19) and agit_t.shape == (4,)
    for i in range(4):
        calm_j, agit_j = jvotes.zone_motion_gate(jnp.asarray(x[i]),
                                                 jnp.asarray(prev[i]), 19)
        assert np.array_equal(calm_t[i].numpy(), np.asarray(calm_j))
        assert abs(float(agit_t[i]) - float(agit_j)) < 1e-6
    assert float(agit_t[0]) == 0.0 and float(agit_t.max()) > 0.0


@functools.lru_cache(maxsize=1)
def _canonicals():
    """Two canonical images of rendered boards (the JAX warp)."""
    out = []
    for nstones, seed in ((30, 4), (120, 6)):
        labels = np.zeros((19, 19), np.int8)
        idx = np.random.default_rng(seed).choice(361, nstones, replace=False)
        labels.flat[idx[::2]] = 1
        labels.flat[idx[1::2]] = 2
        frame, corners = synth.render_frame(labels, frame_hw=(480, 854),
                                            seed=seed)
        out.append((np.asarray(warp_to_canonical(
            to_float(jnp.asarray(frame)), jnp.asarray(corners))), labels))
    return out


def test_sf_contours_matches_jax():
    cans = _canonicals()
    canon = np.stack([c for c, _ in cans])
    lab_t, conf_t = sf_contours.classify_canonical(_t(canon))
    assert lab_t.dtype == torch.int8 and lab_t.shape == (2, 19, 19)
    for i, (c, labels) in enumerate(cans):
        lab_j, conf_j = jcont.classify_canonical(jnp.asarray(c))
        assert np.array_equal(lab_t[i].numpy(), np.asarray(lab_j))
        np.testing.assert_allclose(conf_t[i].numpy(), np.asarray(conf_j),
                                   atol=1e-5)
        assert (lab_t[i].numpy() == labels).mean() > 0.97


def _as_jax(moves):
    """The port's moves as the reference's (the two Move classes never
    compare equal)."""
    return [Move("np", (m.color, m.row, m.col)) for m in moves]


@functools.lru_cache(maxsize=1)
def _game():
    """A 12-move synthetic game (tests/test_sf_meta.py's), 360×640."""
    moves = synth.sample_moves(12, seed=5)
    frames = np.stack([f for f, _ in synth.render_game(
        moves, frames_per_move=cvconf.vote_window + 2, frame_hw=HW,
        empty_leadin=6)])
    return moves, frames, synth.default_corners(HW)


@functools.lru_cache(maxsize=1)
def _read_batch_jit():
    return jax.jit(jmeta.read_batch, static_argnames=("gsize", "zone"))


def _jax_batches(state, frames, corners, batches):
    """Run JAX read_batch over (start, n_valid) batches of 8 frames, each
    padded after n_valid by repeating its last real frame; yield (batch,
    n_valid, and JAX's outputs)."""
    rb = _read_batch_jit()
    for lo, n in batches:
        fb = frames[lo:lo + n]
        fb = np.concatenate([fb, np.repeat(fb[-1:], 8 - n, axis=0)])
        state, labels, conf, agit = rb(state, jnp.asarray(fb),
                                       jnp.asarray(corners),
                                       valid_count=jnp.int32(n))
        yield fb, n, state, labels, conf, agit


def _same_state(ours: sf_meta.MetaState, ref, atol=1e-4):
    ref = {k: np.asarray(v) for k, v in ref._asdict().items()}
    got = sf_meta.meta_state_to_numpy(ours)
    assert np.array_equal(got["stable"], ref["stable"])
    assert int(got["frame_count"]) == int(ref["frame_count"])
    for k in ("votes", "bg", "prev", "trust"):
        np.testing.assert_allclose(got[k], ref[k], atol=atol, err_msg=k)


def test_read_batch_two_batches_match_jax():
    """Frames 32–47 of the game (stones appearing), as a full batch then a
    batch padded after 5 frames: labels and stable equal, votes, bg and
    conf within 1e-4."""
    _, frames, corners = _game()
    state_t = sf_meta.init_state(device="cpu")
    for fb, n, state_j, lab_j, conf_j, agit_j in _jax_batches(
            jmeta.init_state(), frames, corners, [(32, 8), (40, 5)]):
        state_t, lab_t, conf_t, agit_t = sf_meta.read_batch(
            state_t, _t(fb), _t(corners), valid_count=n if n < 8 else None)
        assert np.array_equal(lab_t.numpy(), np.asarray(lab_j))
        np.testing.assert_allclose(conf_t.numpy(), np.asarray(conf_j),
                                   atol=1e-4)
        np.testing.assert_allclose(agit_t.numpy(), np.asarray(agit_j),
                                   atol=1e-6)
        _same_state(state_t, state_j)
    assert int(state_t.frame_count) == 13
    assert lab_t.numpy()[-1].any()


def test_jax_state_continues_in_the_port():
    """A JAX scan stopped mid-game, carried into the port as numpy arrays,
    gives the same next batch as JAX's own continuation."""
    _, frames, corners = _game()
    runs = list(_jax_batches(jmeta.init_state(), frames, corners,
                             [(48, 8), (56, 8)]))
    state_t = sf_meta.meta_state_from_numpy(runs[0][2], "cpu")
    _same_state(state_t, runs[0][2], atol=0)
    fb, _, state_j, lab_j, conf_j, _ = runs[1]
    state_t, lab_t, conf_t, _ = sf_meta.read_batch(state_t, _t(fb),
                                                   _t(corners))
    assert np.array_equal(lab_t.numpy(), np.asarray(lab_j))
    np.testing.assert_allclose(conf_t.numpy(), np.asarray(conf_j), atol=1e-4)
    _same_state(state_t, state_j)
    # And back: the port's state as the reference's.
    back = jmeta.MetaState(**{k: jnp.asarray(v) for k, v in
                              sf_meta.meta_state_to_numpy(state_t).items()})
    assert np.array_equal(np.asarray(back.stable), np.asarray(state_j.stable))


def test_state_surgery_matches_jax():
    rng = np.random.default_rng(3)
    state_j = jmeta.init_state()._replace(
        votes=jnp.asarray(rng.random((19, 19, 3), np.float32)),
        stable=jnp.asarray(rng.integers(0, 3, (19, 19)).astype(np.int8)))
    state_t = sf_meta.meta_state_from_numpy(state_j._asdict(), "cpu")
    _same_state(sf_meta.reset_votes(state_t, [(3, 3), (0, 18)]),
                jmeta.reset_votes(state_j, [(3, 3), (0, 18)]), atol=0)
    board = rng.integers(0, 3, (19, 19)).astype(np.int8)
    _same_state(sf_meta.set_stable(state_t, board),
                jmeta.set_stable(state_j, board), atol=0)
    assert int(state_t.stable[3, 3]) == int(state_j.stable[3, 3])


def test_read_batch_refuses_what_is_not_ported():
    state = sf_meta.init_state(device="cpu")
    frames = torch.zeros((2, 32, 32, 3), dtype=torch.uint8)
    with pytest.raises(TypeError, match="Lens"):
        sf_meta.read_batch(state, frames, torch.zeros((4, 2)), lens=object())
    with pytest.raises(TypeError, match="PatchNet"):
        sf_meta.read_batch(state, frames, torch.zeros((4, 2)),
                           neural_params={})


def test_run_pipeline_reads_the_game():
    """tests/test_sf_meta.py's 12-move game through the port's recorded-
    video path, with automatic board detection: agreement 1.0."""
    moves, frames, corners = _game()
    ex, stats = filecheck.run_pipeline(iter(frames), corners=None, batch=16,
                                       device="cpu")
    assert isinstance(ex, gamesync.MoveExtractor)
    assert score_moves(_as_jax(ex.moves), moves)["agreement"] == 1.0
    assert stats["frames"] == len(frames)
    assert np.abs(np.array(stats["corners"]) - corners).max() < 5.5


def test_numpy_game_renderer_reads_through_jax():
    """The smoke run's numpy-only game: its sampler is the reference's,
    and the JAX package reads the rendered game to the same kifu."""
    moves = still.sample_moves(10, seed=5)
    assert _as_jax(moves) == synth.sample_moves(10, seed=5)
    states = list(still.game_states(moves))
    assert np.array_equal(states[-1], list(synth.game_states(moves))[-1][0])
    frames, corners = still.render_game(moves, cvconf.vote_window + 2,
                                        frame_hw=HW, empty_leadin=6)
    assert frames.shape == (6 + 10 * 9,) + HW + (3,)
    state = jmeta.init_state()
    ex = MoveExtractor()
    rb = _read_batch_jit()
    for lo in range(0, len(frames), 8):
        fb = frames[lo:lo + 8]
        state, labels, _, _ = rb(state, jnp.asarray(fb), jnp.asarray(corners),
                                 valid_count=jnp.int32(8))
        for lab in np.asarray(labels):
            ex.advance(lab)
    assert score_moves(ex.moves, _as_jax(moves))["agreement"] == 1.0
