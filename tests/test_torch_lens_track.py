"""The port's lens-aware handheld engines against the JAX reference on the
CPU, at 360×640 through a k1 = 0.06 lens: ``track_corners_batch``,
``rectify_track_batch`` and the fused ``sf_meta.track_read_batch``, at
``tests/test_torch_track_engines.py``'s tolerances; and
``multistream_track_read`` with a lens a stream, each stream equal to the
single-stream call on it. The readers are in ``test_torch_lens_read.py``."""

import functools

import numpy as np
import jax.numpy as jnp
import torch

from camkifu_tpu.board import bf_auto as jbf
from camkifu_tpu.ops import lens as JL
from camkifu_tpu.stone import sf_meta as jmeta
from camkifu_tpu.utils import synth
from camkifu_tpu_torch.board import bf_auto
from camkifu_tpu_torch.ops import lens as L
from camkifu_tpu_torch.ops.cuda import warp_kernel
from camkifu_tpu_torch.parallel import mesh
from camkifu_tpu_torch.stone import sf_meta
from camkifu_tpu_torch.utils import still

torch.set_num_threads(1)

HW = (360, 640)
G = 19
K1 = 0.06
#: tests/test_torch_track_engines.py's tolerances: corners in frame px,
#: sharpness and alignment relative, canonical images in [0, 1].
TOL_PX = 0.02
TOL_REL = 1e-3
TOL_CANON = 5e-4
TOL_CANON_MEAN = 1e-5


def _t(a):
    return torch.from_numpy(np.array(a))


@functools.lru_cache(maxsize=1)
def _lens_frames():
    """16 frames of a midgame board under a drifting camera through a
    k1 = 0.06 lens (the reference's renderer), and their raw corners."""
    labels = np.zeros((G, G), np.int8)
    idx = np.random.default_rng(1).choice(G * G, 80, replace=False)
    labels.flat[idx[:40]] = 1
    labels.flat[idx[40:]] = 2
    pin = still.handheld_corners(16, HW, drift=(6.0, 4.5),
                                 periods=(5.0, 6.0))
    out = [synth.render_frame(labels, c, HW, seed=21, lens_k1=K1)
           for c in pin]
    return np.stack([f for f, _ in out]), np.stack([c for _, c in out])


def _close(got, ref, tol, rel=False, what=""):
    got, ref = np.asarray(got), np.asarray(ref)
    err = np.abs(got - ref) / (np.maximum(np.abs(ref), 1.0) if rel else 1.0)
    assert err.max() <= tol, (what, float(err.max()))


def _cell(corners) -> float:
    return float(np.linalg.norm(corners[0][1] - corners[0][0]) / (G - 1))


def test_track_corners_batch_with_a_lens_matches_jax():
    frames, truth = _lens_frames()
    lens_j, lens_t = JL.make_lens(K1, HW), L.make_lens(K1, HW)
    cs_j, sharp_j, align_j, seed_j = jbf.track_corners_batch(
        jnp.asarray(frames), jnp.asarray(truth[0]), chunk=8, res=320,
        lens=lens_j)
    cs_t, sharp_t, align_t, seed_t = bf_auto.track_corners_batch(
        _t(frames), _t(truth[0]), chunk=8, res=320, lens=lens_t)
    _close(cs_t, cs_j, TOL_PX, what="corners")
    _close(seed_t, seed_j, TOL_PX, what="new_seed")
    _close(sharp_t, sharp_j, TOL_REL, rel=True, what="sharp")
    _close(align_t, align_j, TOL_REL, rel=True, what="align")
    assert np.abs(cs_t.numpy() - truth).max() < 0.15 * _cell(truth)


def test_rectify_and_track_read_with_a_lens_match_jax():
    """The fused engine, alone (two calls of 8 frames, chunk 8, both
    packages' second call seeded with the port's ``new_seed``: seeded with
    its own, 1e-4 px away, the reference's second chunk reads a few pixels
    of one grid line up to 0.05 darker than the port does at either seed)
    and inside ``track_read_batch`` (16 frames, one chunk): canonical
    images, corners, labels and the vote state."""
    frames, truth = _lens_frames()
    lens_j, lens_t = JL.make_lens(K1, HW), L.make_lens(K1, HW)
    seed = truth[0]
    for lo in (0, 8):
        fb = frames[lo:lo + 8]
        canon_j, cs_j, sharp_j, align_j, seed_j = jbf.rectify_track_batch(
            jnp.asarray(fb), jnp.asarray(seed), chunk=8, lens=lens_j)
        canon_t, cs_t, sharp_t, align_t, seed_t = \
            bf_auto.rectify_track_batch(_t(fb), _t(seed), chunk=8,
                                        lens=lens_t)
        err = np.abs(canon_t.numpy() - np.asarray(canon_j))
        assert err.max() <= TOL_CANON and err.mean() <= TOL_CANON_MEAN, \
            (float(err.max()), float(err.mean()))
        _close(cs_t, cs_j, TOL_PX, what="corners")
        _close(seed_t, seed_j, TOL_PX, what="new_seed")
        _close(sharp_t, sharp_j, TOL_REL, rel=True, what="sharp")
        _close(align_t, align_j, TOL_REL, rel=True, what="align")
        assert np.abs(cs_t.numpy() - truth[lo:lo + 8]).max() \
            < 0.15 * _cell(truth)
        seed = seed_t.numpy()

    out_j = jmeta.track_read_batch(jmeta.init_state(), jnp.asarray(frames),
                                   jnp.asarray(truth[0]), lens=lens_j)
    out_t = sf_meta.track_read_batch(sf_meta.init_state(device="cpu"),
                                     _t(frames), _t(truth[0]), lens=lens_t)
    assert np.array_equal(out_t[1].numpy(), np.asarray(out_j[1]))
    _close(out_t[2], out_j[2], 1e-4, what="conf")
    _close(out_t[4], out_j[4], TOL_PX, what="corners")
    _close(out_t[7], out_j[7], TOL_PX, what="new_seed")
    got = sf_meta.meta_state_to_numpy(out_t[0])
    assert np.array_equal(got["stable"], np.asarray(out_j[0].stable))
    for k in ("votes", "bg", "prev", "trust"):
        _close(got[k], getattr(out_j[0], k), 1e-4, what=k)
    # Read without the lens, the same frames' corners fall off the truth.
    plain = bf_auto.rectify_track_batch(_t(frames), _t(truth[0]))
    assert np.abs(plain[1].numpy() - truth).max() \
        > np.abs(out_t[4].numpy() - truth).max()


def test_multistream_track_read_with_a_lens_a_stream(monkeypatch):
    """Two streams, each its own board and camera (k1 = 0.06 and −0.04),
    through one stacked lens: one warp launch a chunk for both, each
    stream's labels equal, corners within 1e-4 px and state within 1e-5
    of the single-stream engine with that stream's lens, over two
    calls."""
    n, b = 2, 8
    k1s = (0.06, -0.04)
    frames, truth = [], []
    for s in range(n):
        labels = np.zeros((G, G), np.int8)
        idx = np.random.default_rng(30 + s).choice(G * G, 30, replace=False)
        labels.flat[idx[::2]] = 1
        labels.flat[idx[1::2]] = 2
        pin = still.handheld_corners(2 * b, HW, drift=(3.0 + s, 2.0),
                                     periods=(3.0, 4.0)) \
            + np.array([6.0 * s - 3.0, 2.0 - 4.0 * s], np.float32)
        fs, cs = zip(*(still.render_still(labels, HW, seed=40 + t,
                                          corners=c, lens_k1=k1s[s])
                       for t, c in enumerate(pin)))
        frames.append(np.stack(fs))
        truth.append(np.stack(cs))
    frames, truth = np.stack(frames), np.stack(truth)
    lenses = [L.make_lens(k, HW) for k in k1s]
    stacked = L.stack_lenses(lenses, "cpu")
    calls = []
    plain = warp_kernel.warp_homography_ref

    def counted(fr, hmats, out_hw, scale=1.0, lens=None):
        calls.append((fr.shape[0], None if lens is None else
                      tuple(lens.shape) if isinstance(lens, torch.Tensor)
                      else "shared"))
        return plain(fr, hmats, out_hw, scale, lens)

    monkeypatch.setattr(warp_kernel, "warp_homography_ref", counted)
    st = mesh.multistream_init_states(n, device="cpu")
    seeds = _t(truth[:, 0])
    singles = [(sf_meta.init_state(device="cpu"), _t(truth[s, 0]))
               for s in range(n)]
    cell = _cell(truth[0])
    for lo in (0, b):
        f = frames[:, lo:lo + b]
        st, lab, _, _, cs, sharp, _, seeds = mesh.multistream_track_read(
            st, _t(f), seeds, lenses=stacked)
        assert calls == [(n * 16, (n * 16, 5))]   # one chunk of 16, padded
        del calls[:]
        assert np.abs(cs.numpy() - truth[:, lo:lo + b]).max() < 0.15 * cell
        for s in range(n):
            st_s, lab_s, _, _, cs_s, sharp_s, _, seed_s = \
                sf_meta.track_read_batch(singles[s][0], _t(f[s]),
                                         singles[s][1], lens=lenses[s])
            singles[s] = (st_s, seed_s)
            assert calls[-1] == (16, "shared")
            assert torch.equal(lab[s], lab_s), s
            _close(cs[s], cs_s, 1e-4, what=f"corners {s}")
            _close(seeds[s], seed_s, 1e-4, what=f"seed {s}")
            _close(sharp[s], sharp_s, 1e-5, what=f"sharp {s}")
            got = sf_meta.meta_state_to_numpy(
                sf_meta.MetaState(*(x[s] for x in st)))
            want = sf_meta.meta_state_to_numpy(st_s)
            assert np.array_equal(got["stable"], want["stable"])
            for k in ("votes", "bg", "prev", "trust"):
                _close(got[k], want[k], 1e-5, what=f"{k} {s}")
        del calls[:]
