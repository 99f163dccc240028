"""The port's multi-stream entry points (``camkifu_tpu_torch.parallel.mesh``,
BASELINE config 5) on the CPU: against the JAX reference's on a CPU mesh of
two devices (built as tests/test_parallel.py builds it), and every stream
of a stream-batched call against the port's single-stream call on that
stream alone — the test that catches streams mixing. Each stream has its
own board, corners and drift, at 360×640. Inputs come from the port's
numpy renderer."""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import Mesh

from camkifu_tpu.parallel import mesh as jmesh
from camkifu_tpu_torch import pipeline
from camkifu_tpu_torch.config import cvconf
from camkifu_tpu_torch.ops.cuda import warp_kernel
from camkifu_tpu_torch.parallel import mesh
from camkifu_tpu_torch.stone import sf_meta
from camkifu_tpu_torch.utils import still

torch.set_num_threads(1)

HW = (360, 640)
G = 19
#: Streams against JAX (one a mesh device), and in the stream-vs-single
#: checks.
N_JAX, N_PORT = 2, 3
#: Frames a call; two calls carry the state.
B = 8


def _t(a):
    return torch.from_numpy(np.array(a))


def _offset(s: int) -> np.ndarray:
    """Stream s's camera: ``default_corners`` moved by a few px."""
    return np.array([7.0 * s - 5.0, 4.0 - 5.0 * s], np.float32)


@functools.lru_cache(maxsize=1)
def _fixed_streams():
    """(frames (N_PORT, 2B, H, W, 3), corners (N_PORT, 4, 2), moves per
    stream): a seeded 2-move game per stream from its own fixed camera."""
    frames, corners, moves = [], [], []
    for s in range(N_PORT):
        c = still.default_corners(HW) + _offset(s)
        mv = still.sample_moves(2, seed=10 + s)
        f, _ = still.render_game(mv, cvconf.vote_window + 2, frame_hw=HW,
                                 seed=s, empty_leadin=2, corners=c)
        frames.append(f[:2 * B])
        corners.append(c)
        moves.append(mv)
    return np.stack(frames), np.stack(corners), moves


@functools.lru_cache(maxsize=1)
def _handheld_streams():
    """(frames (N_PORT, 2B, H, W, 3), true corners (N_PORT, 2B, 4, 2)):
    a board of its own per stream under its own drifting camera."""
    frames, truth = [], []
    for s in range(N_PORT):
        labels = np.zeros((G, G), np.int8)
        idx = np.random.default_rng(20 + s).choice(G * G, 24 + 8 * s,
                                                   replace=False)
        labels.flat[idx[::2]] = 1
        labels.flat[idx[1::2]] = 2
        cs = still.handheld_corners(2 * B, HW, drift=(3.0 + s, 2.0),
                                    periods=(3.0, 4.0)) + _offset(s)
        frames.append(np.stack([
            still.render_still(labels, HW, seed=20 + 10 * s + t,
                               corners=c)[0]
            for t, c in enumerate(cs)]))
        truth.append(cs)
    return np.stack(frames), np.stack(truth)


def _mesh(n: int):
    return Mesh(np.array(jax.devices()[:n]), axis_names=("stream",))


def _close(got, ref, tol, what=""):
    err = np.abs(np.asarray(got, np.float64) - np.asarray(ref, np.float64))
    assert err.max() <= tol, (what, float(err.max()))


def _same_states(got: sf_meta.MetaState, ref, atol: float):
    """A port state (numpy fields by name) against a reference one, field
    by field: the stable board and the frame count exactly."""
    got = sf_meta.meta_state_to_numpy(got)
    ref = {k: np.asarray(getattr(ref, k)) for k in got}
    assert np.array_equal(got["stable"], ref["stable"])
    assert np.array_equal(got["frame_count"], ref["frame_count"])
    for k in ("votes", "bg", "prev", "trust"):
        _close(got[k], ref[k], atol, what=k)


# -- against the JAX reference -------------------------------------------------

def test_multistream_read_matches_jax():
    frames, corners, _ = _fixed_streams()
    f, c = frames[:N_JAX, :B], corners[:N_JAX]
    lab_j, conf_j = jmesh.multistream_read(_mesh(N_JAX), jnp.asarray(f),
                                           jnp.asarray(c))
    lab_t, conf_t = mesh.multistream_read(_t(f), _t(c))
    assert lab_t.shape == (N_JAX, B, G, G) and lab_t.dtype == torch.int8
    assert np.array_equal(lab_t.numpy(), np.asarray(lab_j))
    _close(conf_t, conf_j, 1e-3, "conf")


def test_multistream_read_meta_matches_jax():
    """Two calls of B frames each, the state carried in each package."""
    frames, corners, _ = _fixed_streams()
    m = _mesh(N_JAX)
    st_j = jmesh.multistream_init_states(N_JAX)
    st_t = mesh.multistream_init_states(N_JAX, device="cpu")
    c = corners[:N_JAX]
    for lo in (0, B):
        f = frames[:N_JAX, lo:lo + B]
        st_j, lab_j, conf_j, agit_j = jmesh.multistream_read_meta(
            m, st_j, jnp.asarray(f), jnp.asarray(c))
        st_t, lab_t, conf_t, agit_t = mesh.multistream_read_meta(
            st_t, _t(f), _t(c))
        assert lab_t.shape == (N_JAX, B, G, G)
        assert np.array_equal(lab_t.numpy(), np.asarray(lab_j))
        _close(conf_t, conf_j, 1e-3, "conf")
        _close(agit_t, agit_j, 1e-4, "agitation")
        _same_states(st_t, st_j, 1e-4)
    assert st_t.frame_count.tolist() == [2 * B] * N_JAX


def test_multistream_track_read_matches_jax():
    """Two calls of B frames each, seeds and states carried: labels
    equal; corners, seeds and confidence within 1e-3; states within
    1e-4."""
    frames, truth = _handheld_streams()
    m = _mesh(N_JAX)
    st_j = jmesh.multistream_init_states(N_JAX)
    st_t = mesh.multistream_init_states(N_JAX, device="cpu")
    seeds_j = jnp.asarray(truth[:N_JAX, 0])
    seeds_t = _t(truth[:N_JAX, 0])
    for lo in (0, B):
        f = frames[:N_JAX, lo:lo + B]
        out_j = jmesh.multistream_track_read(m, st_j, jnp.asarray(f),
                                             seeds_j)
        out_t = mesh.multistream_track_read(st_t, _t(f), seeds_t)
        st_j, lab_j, conf_j, _, cs_j, _, _, seeds_j = out_j
        st_t, lab_t, conf_t, _, cs_t, sharp_t, _, seeds_t = out_t
        assert cs_t.shape == (N_JAX, B, 4, 2) and seeds_t.shape == (N_JAX,
                                                                    4, 2)
        assert np.array_equal(lab_t.numpy(), np.asarray(lab_j))
        _close(cs_t, cs_j, 1e-3, "corners")
        _close(seeds_t, seeds_j, 1e-3, "seeds")
        _close(conf_t, conf_j, 1e-3, "conf")
        _same_states(st_t, st_j, 1e-4)
        cell = float(np.linalg.norm(truth[0, 0, 1] - truth[0, 0, 0])) / 18
        assert np.abs(cs_t.numpy() - truth[:N_JAX, lo:lo + B]).max() \
            < 0.15 * cell


# -- each stream against the single-stream call ---------------------------------

def _count_warps(monkeypatch) -> list:
    """Count the warp's launches on the CPU (its plain version)."""
    calls = []
    plain = warp_kernel.warp_homography_ref

    def counted(frames, hmats, out_hw, scale=1.0):
        calls.append(frames.shape[0])
        return plain(frames, hmats, out_hw, scale)

    monkeypatch.setattr(warp_kernel, "warp_homography_ref", counted)
    return calls


def test_multistream_read_per_stream_equals_single(monkeypatch):
    """One warp for all n·B frames; each stream's labels equal
    ``read_board_batch`` on that stream alone, and its truth."""
    frames, corners, _ = _fixed_streams()
    f = frames[:, :B]
    calls = _count_warps(monkeypatch)
    lab, conf = mesh.multistream_read(_t(f), _t(corners))
    assert calls == [N_PORT * B]
    for s in range(N_PORT):
        lab_s, conf_s = pipeline.read_board_batch(_t(f[s]), _t(corners[s]))
        assert torch.equal(lab[s], lab_s), s
        _close(conf[s], conf_s, 1e-5, f"conf {s}")


def test_multistream_read_meta_per_stream_equals_single(monkeypatch):
    frames, corners, _ = _fixed_streams()
    st = mesh.multistream_init_states(N_PORT, device="cpu")
    singles = [sf_meta.init_state(device="cpu") for _ in range(N_PORT)]
    calls = _count_warps(monkeypatch)
    for lo in (0, B):
        f = frames[:, lo:lo + B]
        st, lab, conf, agit = mesh.multistream_read_meta(st, _t(f),
                                                         _t(corners))
        for s in range(N_PORT):
            singles[s], lab_s, conf_s, agit_s = sf_meta.read_batch(
                singles[s], _t(f[s]), _t(corners[s]))
            assert torch.equal(lab[s], lab_s), s
            _close(conf[s], conf_s, 1e-5, f"conf {s}")
            _close(agit[s], agit_s, 1e-5, f"agitation {s}")
            _same_states(sf_meta.MetaState(*(x[s] for x in st)), singles[s],
                         1e-5)
    assert calls[0] == N_PORT * B and len(calls) == 2 * (1 + N_PORT)


def test_multistream_track_read_per_stream_equals_single(monkeypatch):
    """One warp a chunk for every stream; labels equal, corners within
    1e-4 px and every state field within 1e-5 of the single-stream engine
    on each stream, over two calls."""
    frames, truth = _handheld_streams()
    st = mesh.multistream_init_states(N_PORT, device="cpu")
    seeds = _t(truth[:, 0])
    singles = [(sf_meta.init_state(device="cpu"), _t(truth[s, 0]))
               for s in range(N_PORT)]
    calls = _count_warps(monkeypatch)
    for lo in (0, B):
        f = frames[:, lo:lo + B]
        st, lab, _, _, cs, sharp, align, seeds = mesh.multistream_track_read(
            st, _t(f), seeds)
        assert calls == [N_PORT * 16]           # one chunk of 16, padded
        del calls[:]
        for s in range(N_PORT):
            st_s, lab_s, _, _, cs_s, sharp_s, align_s, seed_s = \
                sf_meta.track_read_batch(singles[s][0], _t(f[s]),
                                         singles[s][1])
            singles[s] = (st_s, seed_s)
            assert torch.equal(lab[s], lab_s), s
            _close(cs[s], cs_s, 1e-4, f"corners {s}")
            _close(seeds[s], seed_s, 1e-4, f"seed {s}")
            _close(sharp[s], sharp_s, 1e-5, f"sharp {s}")
            _close(align[s], align_s, 1e-5, f"align {s}")
            _same_states(sf_meta.MetaState(*(x[s] for x in st)), st_s, 1e-5)
        del calls[:]


def test_multistream_init_states():
    st = mesh.multistream_init_states(3, gsize=9, device="cpu")
    one = sf_meta.init_state(gsize=9, device="cpu")
    for name, x, y in zip(sf_meta.MetaState._fields, st, one):
        assert x.shape == (3,) + y.shape, name
        assert x.dtype == y.dtype and x.device == y.device, name
        assert torch.equal(x[2], y), name
    assert st.frame_count.shape == (3,) and st.bg.shape == (3, 36, 36)
    # Each stream's fields are its own memory, not a view of one.
    st.votes[0].add_(1.0)
    assert float(st.votes[1].abs().max()) == 0.0


def test_multistream_track_read_refuses_a_lens():
    frames = torch.zeros((2, 2, 32, 32, 3), dtype=torch.uint8)
    st = mesh.multistream_init_states(2, device="cpu")
    with pytest.raises(TypeError, match="Lens"):
        mesh.multistream_track_read(st, frames, torch.zeros((2, 4, 2)),
                                    lenses=object())
