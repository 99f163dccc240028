"""The reference's device functions that no other ported path calls, each
against the JAX one on the CPU from the same seeded inputs: k-means with
its luminance init and sample weights, ``luminance_ordered_labels``,
``zone_features`` / ``classify_features``, ``warp_batch`` with and without
a lens, ``_angdiff`` / ``_line_intersection``; and a loop of
``sf_bgsub.step_frame`` against the port's batched scan, bitwise. The
detection helpers (``peak_lines`` / ``hough_lines``, ``_coarse_quad``,
``_refine_grid``) are in tests/test_torch_device_fns_detect.py."""

import functools
import importlib

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from camkifu_tpu.board import bf_auto as jbf
from camkifu_tpu.ops import lens as jlens
from camkifu_tpu.ops import warp as jwarp
from camkifu_tpu.ops import zones as jzones
from camkifu_tpu.stone import sf_clustering as jclust
from camkifu_tpu.utils import synth
from camkifu_tpu_torch import ops
from camkifu_tpu_torch.board import bf_auto
from camkifu_tpu_torch.ops import hough, lens, warp, zones
from camkifu_tpu_torch.stone import sf_bgsub, sf_clustering
from camkifu_tpu_torch.utils import still

# The packages re-export the function ``kmeans`` under its module's name.
jkmeans = importlib.import_module("camkifu_tpu.ops.kmeans")
kmeans_mod = importlib.import_module("camkifu_tpu_torch.ops.kmeans")

torch.set_num_threads(1)

LUMA = np.array([0.299, 0.587, 0.114], np.float32)

#: k-means: centroids and compactness, summed in another order.
KMEANS_ATOL = 1e-5

#: zone_features: the einsum sums round in their own order (values on the
#: [0, 1] scale; the medians are order statistics and agree exactly).
FEATURE_ATOL = 1e-5

#: The warp on the [0, 1] scale (tests/test_torch_ops.py's warp tolerance).
WARP_ATOL = 1e-3


def _t(a):
    return torch.from_numpy(np.array(a))


def _three_blobs(n=120, seed=3):
    """tests/test_kmeans_zones.py's data."""
    rng = np.random.default_rng(seed)
    centers = np.array([[0.1, 0.1, 0.1], [0.6, 0.5, 0.4], [0.9, 0.9, 0.9]])
    return np.concatenate([rng.normal(c, 0.03, (n // 3, 3))
                           for c in centers]).astype(np.float32)


def test_ops_package_exports_the_references_names():
    """``camkifu_tpu_torch.ops`` re-exports the names of
    ``camkifu_tpu.ops``; ``kmeans`` is the function there, as in the
    reference."""
    import camkifu_tpu.ops as jops

    assert sorted(ops.__all__) == sorted(jops.__all__)
    assert all(callable(getattr(ops, name)) for name in ops.__all__)
    assert ops.kmeans is kmeans_mod.kmeans
    assert ops.hough_lines is hough.hough_lines


@pytest.mark.parametrize("case", ["default", "weights", "luma"])
def test_kmeans_matches_jax(case):
    """The reference's signature and its three inits: the luminance init
    from the first column (default), with sample weights excluding the
    dark blob (k = 2, tests/test_kmeans_zones.py's case), and with a luma
    of its own; labels equal, centroids and compactness within
    KMEANS_ATOL. A batch of two problems solves each as alone."""
    x = _three_blobs()
    kw, jkw = {"k": 3, "iters": 12}, {"k": 3, "iters": 12}
    if case == "weights":
        w = np.ones(len(x), np.float32)
        w[:40] = 0.0
        kw.update(k=2, weights=_t(w))
        jkw.update(k=2, weights=jnp.asarray(w))
    elif case == "luma":
        luma = x @ LUMA[::-1]
        kw["luma"], jkw["luma"] = _t(luma), jnp.asarray(luma)
    c, lab, comp = kmeans_mod.kmeans(_t(x), **kw)
    cj, labj, compj = jkmeans.kmeans(jnp.asarray(x), **jkw)
    assert lab.dtype == torch.int32
    assert np.array_equal(lab.numpy(), np.asarray(labj))
    np.testing.assert_allclose(c.numpy(), np.asarray(cj), atol=KMEANS_ATOL)
    np.testing.assert_allclose(float(comp), float(compj), rtol=KMEANS_ATOL)
    if case == "weights":
        assert (c.numpy()[:, 0] > 0.3).all()
    xb = np.stack([x, x[::-1].copy()])
    kb = dict(kw)
    for key in ("weights", "luma"):
        if key in kb:
            kb[key] = torch.stack([kb[key], kb[key].flip(0)])
    cb, labb, _ = kmeans_mod.kmeans(_t(xb), **kb)
    assert torch.equal(labb[0], lab) and torch.equal(cb[0], c)


def test_luminance_ordered_labels_matches_jax():
    """tests/test_kmeans_zones.py's case, then random centroids and labels
    (ties included): equal to the reference's."""
    cents = np.array([[0.9, 0.9, 0.9], [0.1, 0.1, 0.1], [0.5, 0.5, 0.5]],
                     np.float32)
    labels = np.array([0, 1, 2, 0], np.int32)
    out = kmeans_mod.luminance_ordered_labels(_t(cents), _t(labels),
                                              _t(LUMA))
    assert out.dtype == torch.int32 and out.tolist() == [2, 0, 1, 2]
    rng = np.random.default_rng(4)
    for k in (3, 5):
        cents = rng.random((k, 3)).astype(np.float32)
        cents[1] = cents[0]                      # a tie in luminance
        labels = rng.integers(0, k, 50).astype(np.int32)
        ref = jkmeans.luminance_ordered_labels(
            jnp.asarray(cents), jnp.asarray(labels), jnp.asarray(LUMA))
        ours = kmeans_mod.luminance_ordered_labels(_t(cents), _t(labels),
                                                   _t(LUMA))
        assert np.array_equal(ours.numpy(), np.asarray(ref))


@functools.lru_cache(maxsize=1)
def _canonical_boards():
    """Two 1080p ``synth`` boards warped by the reference (80 and 200
    stones) → (canonical (2, 304, 304, 3) in [0, 1], truth labels)."""
    canon, truth = [], []
    for nstones, seed in ((80, 1), (200, 2)):
        labels = np.zeros((19, 19), np.int8)
        idx = np.random.default_rng(seed).choice(361, nstones, replace=False)
        labels.flat[idx[::2]] = 1
        labels.flat[idx[1::2]] = 2
        frame, corners = synth.render_frame(labels, frame_hw=(1080, 1920),
                                            seed=seed)
        canon.append(np.asarray(jwarp.warp_to_canonical(
            jnp.asarray(frame), jnp.asarray(corners))) / 255.0)
        truth.append(labels)
    return np.stack(canon).astype(np.float32), np.stack(truth)


def test_zone_features_and_classify_features_match_jax():
    """Two rendered boards' canonical images (the reference's warp) into
    both: features within FEATURE_ATOL, ``classify_features`` labels equal
    (and equal to the truth) with confidences within FEATURE_ATOL; the
    batch of both boards gives each board's labels, its features within
    FEATURE_ATOL (a batched einsum sums in another order)."""
    canon, truth = _canonical_boards()
    feats_b = zones.zone_features(_t(canon))
    labels_b, conf_b = sf_clustering.classify_features(feats_b)
    for i in range(len(canon)):
        ref = np.asarray(jzones.zone_features(jnp.asarray(canon[i])))
        feats = zones.zone_features(_t(canon[i]))
        assert feats.shape == (19, 19, 7)
        np.testing.assert_allclose(feats.numpy(), ref, atol=FEATURE_ATOL)
        lab_j, conf_j = jclust.classify_features(jnp.asarray(ref))
        lab, conf = sf_clustering.classify_features(_t(ref))
        assert lab.dtype == torch.int8
        assert np.array_equal(lab.numpy(), np.asarray(lab_j))
        assert np.array_equal(lab.numpy(), truth[i])
        np.testing.assert_allclose(conf.numpy(), np.asarray(conf_j),
                                   atol=FEATURE_ATOL)
        np.testing.assert_allclose(feats_b[i].numpy(), feats.numpy(),
                                   atol=FEATURE_ATOL)
        assert np.array_equal(labels_b[i].numpy(), truth[i])


@pytest.mark.parametrize("k1", [None, 0.06])
def test_warp_batch_matches_jax(k1):
    """Three 240×320 frames, each with its own corners, with and without a
    lens: ``warp_batch`` within WARP_ATOL of the reference's on the [0, 1]
    scale, in the frame's own scale (uint8 in, 0–255 out)."""
    hw = (240, 320)
    rng = np.random.default_rng(5)
    frames = rng.integers(0, 256, (3,) + hw + (3,), dtype=np.uint8)
    base = np.array([[40, 30], [280, 36], [272, 214], [46, 206]], np.float32)
    corners = (base + rng.normal(0, 3, (3, 4, 2))).astype(np.float32)
    jl = None if k1 is None else jlens.make_lens(k1, hw)
    pl = None if k1 is None else lens.make_lens(k1, hw)
    ref = np.asarray(jwarp.warp_batch(jnp.asarray(frames),
                                      jnp.asarray(corners), lens=jl))
    ours = warp.warp_batch(_t(frames), _t(corners), lens=pl)
    assert ours.shape == (3, 304, 304, 3) and ours.dtype == torch.float32
    assert np.abs(ours.numpy() - ref).max() / 255.0 <= WARP_ATOL
    assert float(ours.max()) > 1.0


def test_angdiff_and_line_intersection_match_jax():
    """Random angles and lines (parallel pairs included): ``_angdiff``
    within 1e-6 rad, ``_line_intersection`` within 1e-5 relative."""
    rng = np.random.default_rng(6)
    a, b = (rng.uniform(-4, 4, 64).astype(np.float32) for _ in range(2))
    np.testing.assert_allclose(
        bf_auto._angdiff(_t(a), _t(b)).numpy(),
        np.asarray(jbf._angdiff(jnp.asarray(a), jnp.asarray(b))), atol=1e-6)
    t1, t2 = (rng.uniform(0, np.pi, 64).astype(np.float32) for _ in range(2))
    t2[:4] = t1[:4]
    r1, r2 = (rng.uniform(-300, 300, 64).astype(np.float32)
              for _ in range(2))
    ours = bf_auto._line_intersection(_t(t1), _t(r1), _t(t2), _t(r2))
    ref = jbf._line_intersection(*map(jnp.asarray, (t1, r1, t2, r2)))
    for o, r in zip(ours, ref):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=1e-5,
                                   atol=1e-3)


def test_step_frame_loop_equals_the_scan_bitwise():
    """``step_frame`` frame by frame, from a fresh state, over a rendered
    game (an empty board, a white stone placed, then taken away, at
    360×640: chip_smoke.py's capture scenario): every field of the state and every output equal to the
    port's batched ``_scan_canonical`` on the same canonical images, bit
    for bit."""
    a = np.zeros((19, 19), np.int8)
    b = a.copy()
    b[9, 9] = 2
    hw = (360, 640)
    frames = np.stack([still.render_still(a, hw, seed=i)[0] for i in range(6)]
                      + [still.render_still(b, hw, seed=10 + i)[0]
                         for i in range(10)]
                      + [still.render_still(a, hw, seed=30 + i)[0]
                         for i in range(10)])
    canon = warp.warp_batch_fixed(_t(frames), _t(still.default_corners(hw)),
                                  scale=1.0 / 255.0)
    state0 = sf_bgsub.init_state(device="cpu")
    scan_state, labels, conf, agitation = sf_bgsub._scan_canonical(
        state0, canon, 19, 16)
    state = state0
    for i in range(len(canon)):
        state, (lab, cf, ag) = sf_bgsub.step_frame(state, canon[i])
        assert torch.equal(lab, labels[i]) and torch.equal(cf, conf[i])
        assert torch.equal(ag, agitation[i])
    for got, want in zip(state, scan_state):
        assert torch.equal(got, want)
    assert int(labels[14][9, 9]) == 2 and int(labels[-1].sum()) == 0
