"""Stream sharding over a mesh of devices (``camkifu_tpu_torch.parallel.mesh``
with ``mesh=``) on the CPU: the port's mesh of CPU devices against the JAX
reference's stream-sharded calls on its virtual CPU mesh
(tests/conftest.py), per stream: 4 and 2 devices with 2 streams a device,
per-stream lenses, and a stream count the mesh does not divide, which both
refuse. A one-device mesh is bitwise the call without one."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from camkifu_tpu.ops import lens as JL
from camkifu_tpu.parallel import mesh as jmesh
from camkifu_tpu_torch.config import cvconf
from camkifu_tpu_torch.ops import lens as L
from camkifu_tpu_torch.parallel import mesh
from camkifu_tpu_torch.stone import sf_meta
from camkifu_tpu_torch.utils import still

torch.set_num_threads(1)

HW = (360, 640)
G = 19
#: Frames a call; two calls carry the state.
B = 8
K1S = (0.0, 0.03, 0.06, -0.04)


def _t(a):
    return torch.from_numpy(np.array(a))


def _jax_mesh(n: int):
    return Mesh(np.array(jax.devices()[:n]), axis_names=("stream",))


def _cpu_mesh(n: int):
    return mesh.make_mesh(["cpu"] * n)


def _close(got, ref, tol, what=""):
    err = np.abs(np.asarray(got, np.float64) - np.asarray(ref, np.float64))
    assert err.max() <= tol, (what, float(err.max()))


def _same_states(got: sf_meta.MetaState, ref, atol: float):
    got = sf_meta.meta_state_to_numpy(got)
    ref = {k: np.asarray(getattr(ref, k)) for k in got}
    assert np.array_equal(got["stable"], ref["stable"])
    assert np.array_equal(got["frame_count"], ref["frame_count"])
    for k in ("votes", "bg", "prev", "trust"):
        _close(got[k], ref[k], atol, what=k)


def _labels(seed: int, n: int) -> np.ndarray:
    labels = np.zeros((G, G), np.int8)
    idx = np.random.default_rng(seed).choice(G * G, n, replace=False)
    labels.flat[idx[::2]] = 1
    labels.flat[idx[1::2]] = 2
    return labels


@functools.lru_cache(maxsize=1)
def _fixed_streams(n: int = 8):
    """(frames (n, 2B, H, W, 3), corners (n, 4, 2)): a seeded 2-move game
    per stream from its own fixed camera."""
    frames, corners = [], []
    for s in range(n):
        c = still.default_corners(HW) + np.array(
            [5.0 * s - 17.0, 11.0 - 3.0 * s], np.float32)
        f, _ = still.render_game(still.sample_moves(2, seed=50 + s),
                                 cvconf.vote_window + 2, frame_hw=HW,
                                 seed=s, empty_leadin=2, corners=c)
        frames.append(f[:2 * B])
        corners.append(c)
    return np.stack(frames), np.stack(corners)


@functools.lru_cache(maxsize=1)
def _lens_streams():
    """(frames (4, 2B, H, W, 3), true corners (4, 2B, 4, 2)): a board and
    a drifting camera a stream, each through its own lens ``K1S``."""
    frames, truth = [], []
    for s, k1 in enumerate(K1S):
        pin = still.handheld_corners(2 * B, HW, drift=(3.0 + s, 2.0),
                                     periods=(3.0, 4.0)) \
            + np.array([6.0 * s - 9.0, 5.0 - 4.0 * s], np.float32)
        fs, cs = zip(*(still.render_still(_labels(60 + s, 24 + 6 * s), HW,
                                          seed=70 + 10 * s + t, corners=c,
                                          lens_k1=k1)
                       for t, c in enumerate(pin)))
        frames.append(np.stack(fs))
        truth.append(np.stack(cs))
    return np.stack(frames), np.stack(truth)


# -- the mesh ----------------------------------------------------------------

def test_make_mesh_and_stream_sharding():
    m = _cpu_mesh(4)
    assert m == (torch.device("cpu"),) * 4
    assert mesh.stream_sharding(m, 8) == (slice(0, 2), slice(2, 4),
                                          slice(4, 6), slice(6, 8))
    assert mesh.stream_sharding(_cpu_mesh(2), 6) == (slice(0, 3),
                                                     slice(3, 6))
    if torch.cuda.device_count():
        assert all(d.type == "cuda" for d in mesh.make_mesh())
    else:
        with pytest.raises(ValueError, match="no card"):
            mesh.make_mesh()


@pytest.mark.parametrize("n_devices,n_streams,want", [
    (1, 4, 1), (2, 4, 2), (3, 4, 2), (4, 4, 4), (5, 4, 4), (8, 4, 4),
    (3, 6, 3), (4, 6, 3), (7, 1, 1)])
def test_fit_mesh_takes_the_longest_dividing_prefix(n_devices, n_streams,
                                                    want):
    full = _cpu_mesh(n_devices)
    m = mesh.fit_mesh(full, n_streams)
    assert m == full[:want]
    assert len(mesh.stream_sharding(m, n_streams)) == want


def test_four_streams_on_a_three_device_mesh_run_on_the_fitted_prefix():
    """What a three-card machine does with the multi-stream's four
    streams: the full mesh refuses them, its fitted two-device prefix
    reads them bitwise as the call without a mesh."""
    frames, corners = _fixed_streams()
    f, c = _t(frames[:4, :B]), _t(corners[:4])
    full = _cpu_mesh(3)
    with pytest.raises(ValueError, match="divisible"):
        mesh.multistream_read(f, c, mesh=full)
    m = mesh.fit_mesh(full, 4)
    st = mesh.multistream_init_states(4, mesh=m)
    got = mesh.multistream_read_meta(st, f, c, mesh=m)
    want = mesh.multistream_read_meta(
        mesh.multistream_init_states(4, device="cpu"), f, c)
    assert len(got[1]) == 2
    for a, b in zip(got, want):
        a = a.gather("cpu")
        if isinstance(b, tuple):
            assert all(torch.equal(x, y) for x, y in zip(a, b))
        else:
            assert torch.equal(a, b)


def test_uneven_stream_count_is_refused_as_the_reference_refuses():
    """Three streams over two devices: the reference's ``device_put`` onto
    ``P("stream")`` raises ValueError, and so does the port, before any
    work."""
    frames = np.zeros((3, 1, 32, 32, 3), np.uint8)
    corners = np.tile(np.float32([[4, 4], [28, 4], [28, 28], [4, 28]]),
                      (3, 1, 1))
    with pytest.raises(ValueError):
        jmesh.multistream_read(_jax_mesh(2), jnp.asarray(frames),
                               jnp.asarray(corners))
    m = _cpu_mesh(2)
    with pytest.raises(ValueError, match="divisible"):
        mesh.multistream_read(_t(frames), _t(corners), mesh=m)
    with pytest.raises(ValueError, match="divisible"):
        mesh.multistream_init_states(3, mesh=m)
    with pytest.raises(ValueError, match="divisible"):
        mesh.multistream_track_read(
            mesh.multistream_init_states(3, device="cpu"), _t(frames),
            _t(corners[:, :4]), mesh=m)


def test_sharded_states_stay_and_gather():
    """States made on a mesh are a ``Sharded`` of one state a shard, each
    its own memory; ``gather`` gives the stacked state; ``shard`` passes
    a ``Sharded`` through."""
    m = _cpu_mesh(2)
    st = mesh.multistream_init_states(4, gsize=9, mesh=m)
    assert isinstance(st, mesh.Sharded) and len(st) == 2
    assert all(isinstance(p, sf_meta.MetaState) and p.votes.shape[0] == 2
               for p in st)
    whole = mesh.multistream_init_states(4, gsize=9, device="cpu")
    for a, b in zip(st.gather("cpu"), whole):
        assert torch.equal(a, b)
    st[0].votes.add_(1.0)
    assert float(st[1].votes.abs().max()) == 0.0
    again = mesh.shard(st, m)
    assert all(a.votes.data_ptr() == b.votes.data_ptr()
               for a, b in zip(again, st))


# -- against the JAX reference's mesh ----------------------------------------

def test_multistream_read_on_four_devices_matches_jax():
    """Eight streams over four devices, two a device: each stream's labels
    equal the reference's sharded call's; the sharded call is bitwise the
    port's one-device call. Confidence within 0.02: one intersection of
    stream 1 (frame 5, row 0, column 16) reads 0.1823 against the
    reference's 0.1963, and the port's single-stream ``read_board_batch``
    gives the same there; every other value is within 1e-4."""
    frames, corners = _fixed_streams()
    f = frames[:, :B]
    lab_j, conf_j = jmesh.multistream_read(_jax_mesh(4), jnp.asarray(f),
                                           jnp.asarray(corners))
    lab_t, conf_t = mesh.multistream_read(_t(f), _t(corners),
                                          mesh=_cpu_mesh(4))
    assert isinstance(lab_t, mesh.Sharded) and len(lab_t) == 4
    assert all(p.shape == (2, B, G, G) for p in lab_t)
    assert np.array_equal(lab_t.gather().numpy(), np.asarray(lab_j))
    err = np.abs(conf_t.gather().numpy() - np.asarray(conf_j))
    assert err.max() < 0.02 and (err > 1e-4).sum() <= 1, err.max()
    lab_1, conf_1 = mesh.multistream_read(_t(f), _t(corners))
    assert torch.equal(lab_t.gather(), lab_1)
    assert torch.equal(conf_t.gather(), conf_1)


def test_multistream_read_meta_on_two_devices_matches_jax():
    """Four streams over two devices, two calls, the states staying on
    their shards between calls in the port and sharded in the reference."""
    frames, corners = _fixed_streams()
    f4, c4 = frames[:4], corners[:4]
    m = _cpu_mesh(2)
    st_j = jmesh.multistream_init_states(4)
    st_t = mesh.multistream_init_states(4, mesh=m)
    for lo in (0, B):
        f = f4[:, lo:lo + B]
        st_j, lab_j, conf_j, agit_j = jmesh.multistream_read_meta(
            _jax_mesh(2), st_j, jnp.asarray(f), jnp.asarray(c4))
        st_t, lab_t, conf_t, agit_t = mesh.multistream_read_meta(
            st_t, _t(f), _t(c4), mesh=m)
        assert isinstance(st_t, mesh.Sharded) and len(st_t) == 2
        assert np.array_equal(lab_t.gather().numpy(), np.asarray(lab_j))
        _close(conf_t.gather(), conf_j, 1e-3, "conf")
        _close(agit_t.gather(), agit_j, 1e-4, "agitation")
        _same_states(st_t.gather(), st_j, 1e-4)
    assert st_t.gather().frame_count.tolist() == [2 * B] * 4


def test_multistream_track_read_with_lenses_on_two_devices_matches_jax():
    """Four handheld streams, each its own lens, over two devices, two
    calls with seeds and states carried: labels equal, corners and seeds
    within 1e-3 px, states within 1e-4 of the reference's sharded call;
    the stacked lens sharded once and held."""
    frames, truth = _lens_streams()
    m = _cpu_mesh(2)
    lenses_j = JL.stack_lenses([JL.make_lens(k, HW) for k in K1S])
    lenses_t = mesh.shard(L.stack_lenses([L.make_lens(k, HW) for k in K1S],
                                         "cpu"), m)
    st_j = jmesh.multistream_init_states(4)
    st_t = mesh.multistream_init_states(4, mesh=m)
    seeds_j, seeds_t = jnp.asarray(truth[:, 0]), _t(truth[:, 0])
    for lo in (0, B):
        f = frames[:, lo:lo + B]
        st_j, lab_j, conf_j, _, cs_j, _, _, seeds_j = \
            jmesh.multistream_track_read(_jax_mesh(2), st_j, jnp.asarray(f),
                                         seeds_j, lenses=lenses_j)
        st_t, lab_t, conf_t, _, cs_t, _, _, seeds_t = \
            mesh.multistream_track_read(st_t, _t(f), seeds_t,
                                        lenses=lenses_t, mesh=m)
        assert np.array_equal(lab_t.gather().numpy(), np.asarray(lab_j))
        _close(cs_t.gather(), cs_j, 1e-3, "corners")
        _close(seeds_t.gather(), seeds_j, 1e-3, "seeds")
        _close(conf_t.gather(), conf_j, 1e-3, "conf")
        _same_states(st_t.gather(), st_j, 1e-4)


# -- a one-device mesh is the call without one -------------------------------

def _equal(sharded, whole):
    assert isinstance(sharded, mesh.Sharded) and len(sharded) == 1
    if isinstance(whole, tuple):
        assert all(torch.equal(a, b) for a, b in zip(sharded[0], whole))
    else:
        assert torch.equal(sharded[0], whole)


def test_one_device_mesh_is_bitwise_the_call_without_one():
    frames, corners = _fixed_streams()
    lens_frames, truth = _lens_streams()
    one = _cpu_mesh(1)
    f, c = _t(frames[:2, :B]), _t(corners[:2])
    for got, want in zip(mesh.multistream_read(f, c, mesh=one),
                         mesh.multistream_read(f, c)):
        _equal(got, want)
    st = mesh.multistream_init_states(2, device="cpu")
    for got, want in zip(
            mesh.multistream_read_meta(st, f, c, mesh=one),
            mesh.multistream_read_meta(st, f, c)):
        _equal(got, want)
    lenses = L.stack_lenses([L.make_lens(k, HW) for k in K1S[2:]], "cpu")
    f, seeds = _t(lens_frames[2:, :B]), _t(truth[2:, 0])
    for got, want in zip(
            mesh.multistream_track_read(st, f, seeds, lenses=lenses,
                                        mesh=one),
            mesh.multistream_track_read(st, f, seeds, lenses=lenses)):
        _equal(got, want)
