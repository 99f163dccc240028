"""The port's tensor ops against the JAX reference on the CPU: the same
numpy inputs through both, compared at the stated tolerances. Each CUDA
kernel's plain PyTorch version is held against the reference's Pallas
kernel in interpret mode and against its XLA path."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from camkifu_tpu.board import bf_auto as jbf
from camkifu_tpu.ops import color as jcolor
from camkifu_tpu.ops import edges as jedges
from camkifu_tpu.ops import filters as jfilters
from camkifu_tpu.ops import hough as jhough
from camkifu_tpu.ops import warp as jwarp
from camkifu_tpu.ops import zones as jzones
from camkifu_tpu.ops.kmeans import kmeans as jax_kmeans
from camkifu_tpu.ops.pallas.edge_kernel import edge_magnitude
from camkifu_tpu.ops.pallas.hough_kernel import hough_accumulate_pallas
from camkifu_tpu.ops.pallas.warp_kernel import warp_to_canonical_pallas
from camkifu_tpu.utils import synth
from camkifu_tpu_torch.board import bf_auto
from camkifu_tpu_torch.board.bf_auto import resize_bilinear
from camkifu_tpu_torch.ops import color, edges, filters, hough, kmeans, warp, \
    zones
from camkifu_tpu_torch.ops.cuda import edge_kernel, hough_kernel, warp_kernel

torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.array(a))


def _small_gray(hw=(360, 640), res=256):
    """A synthetic board frame's gray, resized to the detection res (JAX)."""
    labels = np.zeros((19, 19), np.int8)
    labels[3, 4] = 1
    labels[9, 9] = 2
    frame, _ = synth.render_frame(labels, frame_hw=hw, noise=2)
    gray = jcolor.rgb_to_gray(jcolor.to_float(jnp.asarray(frame)))
    return np.asarray(jax.image.resize(gray, (res, res), method="bilinear"))


def test_color_matches_jax():
    rng = np.random.default_rng(0)
    u8 = rng.integers(0, 256, (17, 23, 3), dtype=np.uint8)
    f32 = rng.random((17, 23, 3), dtype=np.float32)
    for x, scale in ((u8, 255.0), (f32, 1.0)):
        np.testing.assert_allclose(color.to_float(_t(x)).numpy(),
                                   np.asarray(jcolor.to_float(x)), atol=1e-5)
        # atol 1e-5 on the [0, 1] scale.
        np.testing.assert_allclose(color.rgb_to_gray(_t(x)).numpy() / scale,
                                   np.asarray(jcolor.rgb_to_gray(x)) / scale,
                                   atol=1e-5)
    assert np.array_equal(color.rgb_to_gray_u8(_t(u8)).numpy(),
                          np.asarray(jcolor.rgb_to_gray_u8(u8)))


def test_filters_match_jax():
    img = np.random.default_rng(1).random((40, 57), dtype=np.float32)
    np.testing.assert_allclose(filters.gaussian_blur(_t(img)).numpy(),
                               np.asarray(jfilters.gaussian_blur(img)),
                               atol=1e-5)
    for ours, ref in zip(filters.sobel(_t(img)), jfilters.sobel(img)):
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-5)


def test_median_u8_matches_jax():
    x = np.random.default_rng(2).random((6, 5, 49), dtype=np.float32)
    np.testing.assert_allclose(zones.median_u8(_t(x)).numpy(),
                               np.asarray(jzones.median_u8(x)), atol=1e-5)


def test_zone_stats_match_jax():
    labels = np.zeros((19, 19), np.int8)
    labels[2, 5] = 1
    labels[10, 11] = 2
    frame, corners = synth.render_frame(labels, frame_hw=(360, 640))
    canon = np.asarray(jwarp.warp_to_canonical(
        jnp.asarray(frame), jnp.asarray(corners))) / 255.0
    ours = zones.zone_stats(_t(canon.astype(np.float32)))
    ref = jzones.zone_stats(jnp.asarray(canon, jnp.float32))
    assert set(ours) == set(ref)
    assert np.array_equal(zones.corner_indices(16), jzones.corner_indices(16))
    assert np.array_equal(zones.bg_indices(19, 16), jzones.bg_indices(19, 16))
    for key in ref:
        np.testing.assert_allclose(ours[key].numpy(), np.asarray(ref[key]),
                                   atol=1e-5, err_msg=key)


@pytest.mark.parametrize("init", [(-0.3, 0.05, 0.3), (-0.35, 0.0, 0.35)])
def test_kmeans_matches_jax(init):
    rng = np.random.default_rng(3)
    x = np.concatenate([rng.normal(m, 0.05, (60, 3))
                        for m in (-0.35, 0.0, 0.35)]).astype(np.float32)
    init = np.array([[c] * 3 for c in init], np.float32)
    c_t, l_t, k_t = kmeans.kmeans(_t(x), _t(init), k=3, iters=8)
    c_j, l_j, k_j = jax_kmeans(jnp.asarray(x), k=3, iters=8,
                               init=jnp.asarray(init))
    np.testing.assert_allclose(c_t.numpy(), np.asarray(c_j), atol=1e-5)
    assert np.array_equal(l_t.numpy(), np.asarray(l_j))
    np.testing.assert_allclose(k_t.numpy(), np.asarray(k_j), atol=1e-5)
    # A batch of problems (the reference vmaps) solves each as alone.
    cb, lb, _ = kmeans.kmeans(_t(np.stack([x, x[::-1].copy()])), _t(init),
                              k=3, iters=8)
    assert torch.equal(lb[0], l_t)
    torch.testing.assert_close(cb[0], c_t, atol=1e-6, rtol=0)


def test_homography_dlt_matches_jax():
    rng = np.random.default_rng(4)
    src = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32)
    for _ in range(5):
        dst = (src + rng.uniform(-0.2, 0.2, (4, 2))).astype(np.float32)
        ours = warp.homography_dlt(_t(src), _t(dst)).numpy()
        ref = np.asarray(jwarp.homography_dlt(jnp.asarray(src),
                                              jnp.asarray(dst)))
        np.testing.assert_allclose(ours, ref, atol=1e-5)
    # Frame scale: the canonical → 1080p map, compared on the frame points.
    corners = synth.default_corners((1080, 1920), perspective=0.2)
    canon = warp.canonical_corners()
    H_t = warp.homography_dlt(canon, _t(corners))
    H_j = jwarp.homography_dlt(jwarp.canonical_corners(), jnp.asarray(corners))
    grid = np.stack(np.meshgrid(np.arange(0, 304, 37.0),
                                np.arange(0, 304, 37.0)), -1).reshape(-1, 2)
    ours = warp.apply_homography(H_t, _t(grid.astype(np.float32))).numpy()
    ref = np.asarray(jwarp.apply_homography(H_j, jnp.asarray(grid,
                                                             jnp.float32)))
    np.testing.assert_allclose(ours, ref, atol=1e-3)
    np.testing.assert_allclose(warp.apply_homography(H_t, canon).numpy(),
                               corners, atol=1e-3)


def test_degenerate_quads_score_out_like_jax():
    """A collapsed or collinear candidate quad has a singular DLT: no error,
    a non-finite homography, and evidence −1, as in the reference."""
    unit = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32)
    quads = np.array([unit, np.full((4, 2), 5.0),
                      [[0, 0], [1, 1], [2, 2], [3, 3]]], np.float32) * 40 + 20
    H = warp.homography_dlt(_t(unit), _t(quads)).numpy()
    assert np.isfinite(H[0]).all() and not np.isfinite(H[1:]).any()
    E = np.random.default_rng(7).random((320, 320)).astype(np.float32)
    ours = bf_auto._lattice_evidence_rc(_t(E), _t(quads), 19).numpy()
    ref = np.asarray(jbf._lattice_evidence_rc(jnp.asarray(E),
                                              jnp.asarray(quads), 19))
    np.testing.assert_allclose(ours, ref, atol=1e-5)
    assert (ours[1:] == -1.0).all()
    # Warping through a non-finite homography samples NaN, no fault.
    frame = _t(np.zeros((1, 12, 16, 3), np.uint8))
    out = warp_kernel.warp_homography_ref(frame, _t(H[1]), (4, 4))
    assert out.shape == (1, 4, 4, 3) and torch.isnan(out).all()


def _edge_compare(ours, ref, border):
    inner = (slice(border, -border),) * 2
    a, b = ours[inner], ref[inner]
    both = (a > 0) & (b > 0)
    support = both.sum() / max(((a > 0) | (b > 0)).sum(), 1)
    assert support >= 0.995, support
    np.testing.assert_allclose(a[both], b[both], atol=1e-5)


def test_edge_magnitude_ref_matches_pallas_kernel():
    small = _small_gray()
    ours = edge_kernel.edge_magnitude_ref(_t(small)).numpy()
    ref = np.asarray(edge_magnitude(jnp.asarray(small), interpret=True))
    _edge_compare(ours, ref, edge_kernel.BORDER)
    band = ours.copy()
    band[edge_kernel.BORDER:-edge_kernel.BORDER,
         edge_kernel.BORDER:-edge_kernel.BORDER] = 0
    assert not band.any()
    # Batched input: each image as on its own.
    two = np.stack([small, small[::-1].copy()])
    batch = edge_kernel.edge_magnitude_ref(_t(two)).numpy()
    assert np.array_equal(batch[0], ours)


def test_edge_map_cpu_matches_jax_xla_route():
    small = _small_gray()
    ours = edges.edge_map(_t(small)).numpy()
    ref = np.asarray(jedges.edge_map(jnp.asarray(small), backend="xla"))
    np.testing.assert_allclose(ours, ref, atol=1e-5)
    assert (ours > 0).sum() > 100


def _hough_points():
    rng = np.random.default_rng(0)
    img = np.zeros((128, 128), np.float32)
    img[40, :] = 1.0
    img[:, 100] = 1.0
    img += rng.random((128, 128)).astype(np.float32) * 0.05
    return img


def test_hough_accumulate_ref_matches_jax():
    img = _hough_points()
    pts_j, wts_j = jhough.topk_edge_points(jnp.asarray(img), k=1024)
    pts_t, wts_t = hough.topk_edge_points(_t(img), k=1024)
    assert np.array_equal(pts_t.numpy(), np.asarray(pts_j))
    np.testing.assert_allclose(wts_t.numpy(), np.asarray(wts_j), atol=1e-6)
    rho_max = float(np.hypot(128, 128))
    ours = hough_kernel.hough_accumulate_ref(pts_t, wts_t, rho_max, 64, 256)
    xla = np.asarray(jhough.hough_accumulate(pts_j, wts_j, rho_max, 64, 256))
    pallas = np.asarray(hough_accumulate_pallas(pts_j, wts_j, rho_max, 64,
                                                256, interpret=True))
    np.testing.assert_allclose(ours.numpy(), xla, atol=1e-2)
    np.testing.assert_allclose(ours.numpy(), pallas, atol=1e-2)
    # The dispatcher takes the plain version for a CPU tensor.
    assert torch.equal(hough.hough_accumulate(pts_t, wts_t, rho_max, 64, 256),
                       ours)


def test_hough_accumulate_ref_nonmultiple_k():
    pts = np.array([[10.0, 20.0], [30.0, 7.0]], np.float32)
    wts = np.array([1.0, 2.0], np.float32)
    ours = hough_kernel.hough_accumulate_ref(_t(pts), _t(wts), 64.0, 16, 128)
    ref = jhough.hough_accumulate(jnp.asarray(pts), jnp.asarray(wts), 64.0,
                                  16, 128)
    pallas = hough_accumulate_pallas(jnp.asarray(pts), jnp.asarray(wts),
                                     64.0, 16, 128, interpret=True)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-4)
    np.testing.assert_allclose(ours.numpy(), np.asarray(pallas), atol=1e-4)


def test_warp_to_canonical_ref_matches_jax_and_pallas():
    labels = np.zeros((19, 19), np.int8)
    labels[3, 3] = 1
    labels[15, 15] = 2
    frame, corners = synth.render_frame(labels, frame_hw=(720, 1280))
    ours = warp_kernel.warp_to_canonical_ref(_t(frame), _t(corners)).numpy()
    ref = np.asarray(jwarp.warp_to_canonical(jnp.asarray(frame),
                                             jnp.asarray(corners)))
    assert np.abs(ours - ref).max() / 255.0 <= 1e-3
    pallas = np.asarray(warp_to_canonical_pallas(
        jnp.asarray(frame), jnp.asarray(corners), interpret=True))
    assert np.abs(ours - pallas).max() < 0.05
    # The module-level path (dispatch on a CPU tensor, batch, fused scale).
    batch = warp.warp_batch_fixed(_t(np.stack([frame, frame])), _t(corners),
                                  scale=1.0 / 255.0).numpy()
    np.testing.assert_allclose(batch[1], ours / 255.0, atol=1e-6)
    one = warp.warp_to_canonical(_t(frame), _t(corners)).numpy()
    assert np.array_equal(one, ours)


@pytest.mark.parametrize("hw", [(360, 640), (720, 1280)])
def test_resize_matches_jax_image_resize(hw):
    img = np.random.default_rng(5).random(hw, dtype=np.float32)
    ours = resize_bilinear(_t(img), (256, 256)).numpy()
    ref = np.asarray(jax.image.resize(jnp.asarray(img), (256, 256),
                                      method="bilinear"))
    np.testing.assert_allclose(ours, ref, atol=1e-4)


def test_top_k_keeps_lax_tie_order():
    """Integer-valued projections tie massively (the coarse quad's corner
    search): the port must pick the same indices as lax.top_k."""
    res = 64
    ys, xs = np.mgrid[0:res, 0:res].astype(np.float32)
    mask = np.random.default_rng(6).random((res, res)) > 0.3
    for proj in (-(xs + ys), xs - ys, xs + ys, ys - xs):
        p = np.where(mask, proj, -np.inf).reshape(-1).astype(np.float32)
        _, idx_j = jax.lax.top_k(jnp.asarray(p), 49)
        _, idx_t = hough.top_k(_t(p), 49)
        assert np.array_equal(idx_t.numpy(), np.asarray(idx_j))


@pytest.mark.parametrize("call", ["warp", "edge", "hough"])
def test_kernel_wrappers_refuse_cpu_tensors(call):
    """A kernel wrapper launches on CUDA tensors or raises; it never falls
    back to its plain version."""
    with pytest.raises(ValueError, match="CUDA"):
        if call == "warp":
            frames = torch.zeros((1, 8, 8, 3), dtype=torch.uint8)
            warp_kernel.warp_homography(frames, torch.eye(3), (4, 4))
        elif call == "edge":
            edge_kernel.edge_magnitude(torch.zeros((32, 32)))
        else:
            hough_kernel.hough_accumulate(torch.zeros((4, 2)), torch.ones(4),
                                          10.0, 8, 16)
