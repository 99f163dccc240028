"""The port's batched detection stage 1 against the JAX reference on the
CPU: ``edge_map_batch``, the batched edge plain version against the
reference's batch-grid Pallas kernel in interpret mode, the batched Hough
vote, ``_coarse_from_mag`` with a frame dimension against its vmap, and
``_detect_prepare_batch``, each on a batch whose frames differ (a sparse
board, a saturated board, a board on clutter-free noise), so a statistic
leaking across frames shows."""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import torch

from camkifu_tpu.board import bf_auto as jbf
from camkifu_tpu.ops import edges as jedges
from camkifu_tpu.ops import filters as jfilters
from camkifu_tpu.ops import hough as jhough
from camkifu_tpu.ops.color import rgb_to_gray, to_float
from camkifu_tpu.ops.pallas.edge_kernel import BORDER, edge_magnitude_batch
from camkifu_tpu.utils import synth
from camkifu_tpu_torch.board import bf_auto
from camkifu_tpu_torch.ops import edges, hough
from camkifu_tpu_torch.ops.cuda import edge_kernel, hough_kernel

torch.set_num_threads(1)

HW = (360, 640)
RES = 256


def _t(a):
    return torch.from_numpy(np.array(a))


@functools.lru_cache(maxsize=1)
def _frames() -> np.ndarray:
    """Three 360×640 frames: 40 stones, 250 stones, and the empty board
    under heavier noise."""
    out = []
    for nstones, seed, noise in ((40, 1, 2.0), (250, 3, 2.0), (0, 5, 8.0)):
        labels = np.zeros((19, 19), np.int8)
        idx = np.random.default_rng(seed).choice(361, nstones, replace=False)
        labels.flat[idx[::2]] = 1
        labels.flat[idx[1::2]] = 2
        f, _ = synth.render_frame(labels, frame_hw=HW, seed=seed, noise=noise)
        out.append(f)
    return np.stack(out)


@functools.lru_cache(maxsize=1)
def _smalls() -> np.ndarray:
    """(6, 256, 256): the frames' luma, then their R−B chroma, at the
    detection resolution (resized by JAX)."""
    f = jnp.asarray(_frames())
    lum = jax.image.resize(rgb_to_gray(to_float(f)), (3, RES, RES),
                           method="bilinear")
    chroma = jax.image.resize((f[..., 0].astype(jnp.float32)
                               - f[..., 2].astype(jnp.float32)) / 255.0,
                              (3, RES, RES), method="bilinear")
    return np.asarray(jnp.concatenate([lum, chroma]))


@functools.lru_cache(maxsize=1)
def _jax_mags() -> np.ndarray:
    return np.asarray(jedges.edge_map_batch(jnp.asarray(_smalls()),
                                            backend="xla"))


def test_edge_map_batch_matches_jax_and_single_frames():
    smalls = _smalls()
    ours = edges.edge_map_batch(_t(smalls)).numpy()
    np.testing.assert_allclose(ours, _jax_mags(), atol=1e-5)
    assert (ours > 0).sum(axis=(1, 2)).min() > 100
    # Per-frame thresholds: each map is what the frame gives on its own.
    for i in (0, 2, 5):
        assert np.array_equal(ours[i], edges.edge_map(_t(smalls[i])).numpy())


def test_edge_magnitude_ref_batch_matches_pallas_batch_kernel():
    smalls = _smalls()
    ours = edge_kernel.edge_magnitude_ref(_t(smalls)).numpy()
    ref = np.asarray(edge_magnitude_batch(jnp.asarray(smalls),
                                          interpret=True))
    b = BORDER                              # the Pallas kernel's band
    inner = (slice(None), slice(b, -b), slice(b, -b))
    a, r = ours[inner], ref[inner]
    both = (a > 0) & (r > 0)
    assert both.sum() >= 0.995 * ((a > 0) | (r > 0)).sum()
    np.testing.assert_allclose(a[both], r[both], atol=1e-5)
    # The band the Pallas kernel zeroes follows the reference's XLA route,
    # each map as on its own.
    xla = np.stack([np.asarray(jedges.nms_magnitude(*jfilters.sobel(
        jfilters.gaussian_blur(jnp.asarray(m))))) for m in smalls])
    band = np.ones(ours.shape, bool)
    band[inner] = False
    assert ours[band].any()
    np.testing.assert_allclose(ours[band], xla[band], atol=1e-5)


def test_batched_hough_matches_per_frame_jax():
    mags = _jax_mags()[:3]
    pts_t, wts_t = hough.topk_edge_points(_t(mags))
    assert pts_t.shape == (3, 4096, 2) and wts_t.shape == (3, 4096)
    rho_max = float(np.hypot(RES, RES))
    acc_t = hough.hough_accumulate(pts_t, wts_t, rho_max).numpy()
    assert acc_t.shape == (3, 128, 256)
    for i in range(3):
        pts_j, wts_j = jhough.topk_edge_points(jnp.asarray(mags[i]))
        assert np.array_equal(pts_t[i].numpy(), np.asarray(pts_j))
        np.testing.assert_allclose(wts_t[i].numpy(), np.asarray(wts_j),
                                   atol=1e-6)
        ref = np.asarray(jhough.hough_accumulate(pts_j, wts_j, rho_max))
        np.testing.assert_allclose(acc_t[i], ref, atol=1e-2)
    # The batched plain version is the per-frame one, frame by frame.
    one = hough_kernel.hough_accumulate_ref(pts_t[1], wts_t[1], rho_max)
    assert torch.equal(one, torch.from_numpy(acc_t[1]))


def test_coarse_from_mag_batch_matches_jax_vmap():
    """quad within 0.5 px at 256², score within 1e-3, per frame."""
    mags = _jax_mags()
    quad_j, score_j = jax.jit(jax.vmap(jbf._coarse_from_mag))(
        jnp.asarray(mags[:3]), jnp.asarray(mags[3:]))
    quad_t, score_t = bf_auto._coarse_from_mag(_t(mags[:3]), _t(mags[3:]))
    assert quad_t.shape == (3, 4, 2) and score_t.shape == (3,)
    assert np.abs(quad_t.numpy() - np.asarray(quad_j)).max() < 0.5
    np.testing.assert_allclose(score_t.numpy(), np.asarray(score_j),
                               atol=1e-3)
    assert float(score_t[0]) > 0.55
    # B = 1 is the single-frame call.
    q1, s1 = bf_auto._coarse_from_mag(_t(mags[1]), _t(mags[4]))
    assert torch.equal(q1, quad_t[1]) and torch.equal(s1, score_t[1])


def test_detect_prepare_batch_matches_jax():
    frames = _frames()
    grays_j, quads_j, scores_j = jbf._detect_prepare_batch(
        jnp.asarray(frames), RES)
    grays_t, quads_t, scores_t = bf_auto._detect_prepare_batch(
        _t(frames), RES)
    assert grays_t.dtype == torch.uint8 and grays_t.shape == (3,) + HW
    # Luma rounds half up: a sum landing on .5 may round either way after
    # XLA's fused arithmetic (9 of 691,200 pixels here), by one level.
    dg = np.abs(grays_t.numpy().astype(int) - np.asarray(grays_j))
    assert dg.max() <= 1 and (dg > 0).mean() < 1e-4
    # 0.5 detection-res px, in frame px.
    tol = 0.5 * (HW[1] - 1) / (RES - 1)
    assert np.abs(quads_t.numpy() - np.asarray(quads_j)).max() < tol
    np.testing.assert_allclose(scores_t.numpy(), np.asarray(scores_j),
                               atol=1e-3)
    # The single-frame stage 1 is the batch of one.
    g, q, s = bf_auto._detect_prepare(_t(frames[2]), RES)
    assert torch.equal(g, grays_t[2])
    assert np.abs(q.numpy() - quads_t[2].numpy()).max() < 1e-3
