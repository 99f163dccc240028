"""The port's batched redetection against the JAX reference on the CPU:
the chunk-shared refine and its verdict on a drifting video batch, and
``detect_batch_stable``'s medians over an even frame count
(``test_torch_detect_merge.py`` has ``detect_batch`` with a failed
chunk)."""

import functools

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from camkifu_tpu.board import bf_auto as jbf
from camkifu_tpu.utils import synth
from camkifu_tpu_torch.board import bf_auto

torch.set_num_threads(1)

HW = (360, 640)
RES = 256
#: tests/test_bf_auto.py's 11 px at 720p, at 360p.
TOL_PX = 5.5


def _t(a):
    return torch.from_numpy(np.array(a))


def _labels(n, seed):
    labels = np.zeros((19, 19), np.int8)
    idx = np.random.default_rng(seed).choice(361, n, replace=False)
    labels.flat[idx[::2]] = 1
    labels.flat[idx[1::2]] = 2
    return labels


@functools.lru_cache(maxsize=1)
def _drift_batch(b=4, drift=3.0):
    """tests/test_detect_shared.py's handheld drift batch, at 360×640."""
    labels = _labels(40, 1)
    base = synth.default_corners(HW)
    frames, gts = [], []
    for i in range(b):
        c = base + np.array([drift * np.sin(i / 2.0),
                             drift * np.cos(i / 3.0)], np.float32)
        f, gt = synth.render_frame(labels, c, HW, seed=i)
        frames.append(f)
        gts.append(gt)
    return np.stack(frames), np.stack(gts)


def test_routed_refine_matches_jax_on_drift_batch():
    """The same JAX stage-1 outputs into both routers: every chunk on the
    shared route, corners within 1 px of JAX's."""
    frames, gts = _drift_batch()
    grays, quads, scores = jbf._detect_prepare_batch(jnp.asarray(frames),
                                                     RES)
    ref = jbf._detect_batch_routed(grays, quads, scores, 19)
    assert ref is not None
    g, q, s = _t(grays), _t(quads), _t(scores)
    corners, oks = bf_auto._chunked_route(g, q, s, 19, frames.shape[0])
    assert oks.shape == (1,) and bool(oks.all())
    ours = bf_auto._detect_batch_routed(g, q, s, 19)
    assert torch.equal(ours, corners)
    assert np.abs(ours.numpy() - np.asarray(ref)).max() < 1.0
    assert np.abs(ours.numpy() - gts).max() < TOL_PX


def test_shared_route_verdict_takes_even_median(monkeypatch):
    """The chunk median of 4 quads averages the two middle ones: a spread
    that is inside the gate around that median but not around the lower
    middle quad (torch.median) must validate."""
    frames, _ = _drift_batch()
    _, quads, scores = bf_auto._detect_prepare_batch(_t(frames), RES)
    med = torch.quantile(quads, 0.5, dim=0)
    cell = float(torch.linalg.vector_norm(med[1] - med[0])) / 18
    shift = torch.tensor([-1.0, -0.8, 0.8, 1.0])[:, None, None] * cell
    quads = quads[:1].expand(4, 4, 2) + shift
    gate = float((quads - torch.quantile(quads, 0.5, dim=0)).abs().max())
    lower = float((quads - torch.median(quads, dim=0).values).abs().max())
    monkeypatch.setattr(bf_auto, "SHARED_REFINE_SPREAD",
                        0.5 * (gate + lower) / cell)
    ok, _ = bf_auto._shared_gate(quads, scores.clamp(min=0.9), 19)
    assert bool(ok)


def _fake_detect(frames, res, gsize):
    """Corners that move by the frame's first pixel value; the score is
    low where its second pixel is set."""
    base = np.asarray(synth.default_corners(HW), np.float32)
    v = np.asarray(frames)[:, 0, 0, 0].astype(np.float32)
    low = np.asarray(frames)[:, 0, 1, 0] > 0
    corners = base[None] + v[:, None, None] * np.float32([1.0, -0.5])
    corners[:, 2] += v[:, None] ** 2            # a second ordering per corner
    return corners, np.where(low, 0.01, 0.9).astype(np.float32)


@pytest.mark.parametrize("values,low", [
    ((0, 1, 3, 7), ()),            # even count: the two middles average
    ((0, 1, 3, 7, 8, 9), (0,)),    # one frame not confident: 5 remain
    ((2, 4, 5, 9), (1, 3)),        # two remain: their mean
    ((2, 4, 5, 9), (0, 1, 2, 3)),  # none confident: the plain median
])
def test_detect_batch_stable_medians_match_jax(monkeypatch, values, low):
    frames = np.zeros((len(values), 1, 2, 3), np.uint8)
    frames[:, 0, 0, 0] = values
    frames[list(low), 0, 1, 0] = 1

    def port_fake(f, res, gsize):
        c, s = _fake_detect(f.numpy(), res, gsize)
        return torch.from_numpy(c), torch.from_numpy(s)

    monkeypatch.setattr(bf_auto, "detect_batch", port_fake)
    monkeypatch.setattr(jbf, "detect_batch", lambda f, r, g: tuple(
        jnp.asarray(a) for a in _fake_detect(f, r, g)))
    ours = bf_auto.detect_batch_stable(_t(frames)).numpy()
    ref = np.asarray(jbf.detect_batch_stable(jnp.asarray(frames)))
    np.testing.assert_allclose(ours, ref, atol=1e-5)
    if not low:
        c, _ = _fake_detect(frames, RES, 19)
        assert np.allclose(ours, 0.5 * (c[1] + c[2]))
        assert not np.allclose(ours, torch.median(_t(c), 0).values.numpy())


def test_detect_batch_stable_subsamples_like_jax(monkeypatch):
    """More frames than ``max_frames``: the same evenly spaced frames."""
    frames = np.zeros((20, 1, 2, 3), np.uint8)
    frames[:, 0, 0, 0] = (np.arange(20) * 7) % 23
    monkeypatch.setattr(bf_auto, "detect_batch", lambda f, r, g: tuple(
        torch.from_numpy(a) for a in _fake_detect(f.numpy(), r, g)))
    monkeypatch.setattr(jbf, "detect_batch", lambda f, r, g: tuple(
        jnp.asarray(a) for a in _fake_detect(f, r, g)))
    ours = bf_auto.detect_batch_stable(_t(frames)).numpy()
    ref = np.asarray(jbf.detect_batch_stable(jnp.asarray(frames)))
    np.testing.assert_allclose(ours, ref, atol=1e-5)


def test_detect_batch_stable_on_frames(monkeypatch):
    """End to end on the drift batch: the median of the per-frame corners,
    within tolerance of the mean truth (the frames drift ±3 px)."""
    frames, gts = _drift_batch()
    seen = []
    real = bf_auto.detect_batch
    monkeypatch.setattr(bf_auto, "detect_batch",
                        lambda *a: seen.append(real(*a)) or seen[-1])
    est = bf_auto.detect_batch_stable(_t(frames))
    corners, _ = seen[0]
    assert est.shape == (4, 2)
    assert torch.equal(est, torch.quantile(corners, 0.5, dim=0))
    assert np.abs(est.numpy() - gts.mean(axis=0)).max() < TOL_PX
