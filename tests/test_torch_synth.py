"""The port's synthetic renderer (camkifu_tpu_torch/utils/synth.py) against
the reference's (camkifu_tpu/utils/synth.py) and against cv2, whose drawing
calls the reference makes: each primitive against its cv2 call, the
canonical board and camera frames at 360×640 for each option group with
the sensor noise off (corners bitwise, images within a stated mean and 99th
percentile of absolute difference), the labels that ``read_board_batch``
reads from either render, and the device-drawn sensor noise's statistics
against the reference's.

Tolerances, in DN (0–255), measured on these inputs with margin:
- anti-aliased rims: cv2 fills circles as 72-gons (4-gons under radius 3)
  with integer coverage; the port's analytic coverage leaves a mean of
  0.73 DN on the canonical board (99th percentile 14);
- bilinear warps and remaps: cv2 rounds coordinates to 1/32 pixel, the port
  samples at the exact coordinate: ±1–2 DN at edges;
- the hand and the glare are filled without anti-aliasing in both, by
  polygons there and exact shapes here: single-pixel rims differ fully.
"""

import cv2
import numpy as np
import pytest
import torch

from camkifu_tpu.utils import synth as jsynth
from camkifu_tpu_torch import pipeline
from camkifu_tpu_torch.utils import synth

torch.set_num_threads(1)

HW = (360, 640)
CPU = torch.device("cpu")


def _labels(n: int = 150, seed: int = 0) -> np.ndarray:
    labels = np.zeros((19, 19), np.int8)
    idx = np.random.default_rng(seed).choice(361, n, replace=False)
    labels.flat[idx[: n // 2]] = 1
    labels.flat[idx[n // 2:]] = 2
    return labels


def _stats(ours, ref) -> tuple[float, float]:
    d = np.abs(np.asarray(ours, np.int64) - np.asarray(ref, np.int64))
    return float(d.mean()), float(np.percentile(d, 99))


# -- primitives against cv2 --------------------------------------------------

def test_perspective_matches_cv2():
    src = np.array([[12, 12], [444, 12], [444, 444], [12, 444]], np.float32)
    for persp in (0.03, 0.12, 0.3):
        dst = synth.default_corners(HW, perspective=persp)
        want = cv2.getPerspectiveTransform(src, dst)
        np.testing.assert_allclose(synth._perspective(src, dst), want,
                                   rtol=1e-6, atol=1e-9)


def test_motion_kernel_is_cv2_bresenham():
    """Every line cv2 draws in the motion-blur kernels of |d| ≤ 12 px."""
    for dx in np.arange(-12, 12.5, 0.5):
        for dy in np.arange(-12, 12.5, 0.5):
            n = max(3, int(np.hypot(dx, dy)) | 1)
            p0 = (int(n / 2 - dx / 2), int(n / 2 - dy / 2))
            p1 = (int(n / 2 + dx / 2), int(n / 2 + dy / 2))
            want = np.zeros((n, n), np.float32)
            cv2.line(want, p0, p1, 1.0, 1)
            assert np.array_equal(synth._line_kernel(n, p0, p1), want), \
                (dx, dy)


def test_gaussian_blur_matches_cv2():
    """Float images to float32 rounding with cv2's (0, 0) kernel size;
    uint8 images within 2 DN (cv2's 8-bit path is fixed point)."""
    rng = np.random.default_rng(1)
    img = rng.random((61, 83)).astype(np.float32)
    for sigma in (1.0, 1.98, 3.5):
        ours = synth._gaussian_blur(torch.from_numpy(img),
                                    synth._gauss_ksize(sigma, False), sigma)
        want = cv2.GaussianBlur(img, (0, 0), sigma)
        np.testing.assert_allclose(ours.numpy(), want, atol=2e-6)
    u8 = rng.integers(0, 256, (61, 83, 3), dtype=np.uint8)
    for k, sigma in ((7, 1.2), (31, 12.0), (9, 1.4)):
        ours = synth._u8_round(synth._gaussian_blur(torch.from_numpy(u8), k,
                                                    sigma))
        want = cv2.GaussianBlur(u8, (k, k), sigma)
        assert np.abs(ours.numpy().astype(int) - want).max() <= 2


def test_filter2d_matches_cv2():
    rng = np.random.default_rng(2)
    u8 = rng.integers(0, 256, (50, 70, 3), dtype=np.uint8)
    k = synth._line_kernel(7, (1, 2), (5, 4))
    k /= k.sum()
    ours = synth._u8_round(synth._conv2d_same(torch.from_numpy(u8), k))
    want = cv2.filter2D(u8, -1, k)
    assert np.abs(ours.numpy().astype(int) - want).max() <= 1


def test_remap_matches_cv2():
    """The lens map and a rolling-shutter shear through ``_remap`` against
    ``cv2.remap(INTER_LINEAR, BORDER_REPLICATE)`` on a textured frame."""
    frame = jsynth.render_frame(_labels(), frame_hw=HW, seed=3)[0]
    map_x, map_y = synth._lens_map(*HW, 0.06, CPU)
    ours = synth._remap(torch.from_numpy(frame), map_x, map_y).numpy()
    want = cv2.remap(frame, map_x.numpy(), map_y.numpy(), cv2.INTER_LINEAR,
                     borderMode=cv2.BORDER_REPLICATE)
    d = np.abs(ours.astype(int) - want)
    assert d.max() <= 3 and d.mean() < 0.2, (d.max(), d.mean())
    yy, xx = synth._pixel_grid(*HW, CPU)
    t = yy / HW[0]
    sx, sy = (xx - 4.2 * t).expand(HW), (yy - 2.9 * t).expand(HW)
    ours = synth._remap(torch.from_numpy(frame), sx, sy).numpy()
    want = cv2.remap(frame, sx.numpy(), sy.numpy(), cv2.INTER_LINEAR,
                     borderMode=cv2.BORDER_REPLICATE)
    d = np.abs(ours.astype(int) - want)
    assert d.max() <= 3 and d.mean() < 0.2, (d.max(), d.mean())


def test_board_warp_and_mask_match_cv2():
    """The canonical board through the warp's plain version (padded by one
    zero pixel) against ``cv2.warpPerspective``, and the nearest-pixel
    mask equal to cv2's."""
    canon = jsynth.render_canonical(_labels(), rng=np.random.default_rng(4))
    size = canon.shape[0]
    src = np.array([[12, 12], [size - 12, 12], [size - 12, size - 12],
                    [12, size - 12]], np.float32)
    m = cv2.getPerspectiveTransform(src, synth.default_corners(HW))
    ours = synth._warp_board(torch.from_numpy(canon), m, *HW).numpy()
    want = cv2.warpPerspective(canon, m, HW[::-1], flags=cv2.INTER_LINEAR)
    d = np.abs(ours.astype(int) - want)
    assert d.mean() < 0.05 and np.percentile(d, 99.9) <= 2, \
        (d.mean(), d.max())
    mask = synth._board_mask(np.linalg.inv(m).tobytes(), size, *HW, CPU)
    want = cv2.warpPerspective(np.full((size, size), 255, np.uint8), m,
                               HW[::-1], flags=cv2.INTER_NEAREST) > 0
    assert np.array_equal(mask.numpy(), want)


@pytest.mark.parametrize("radius, mean_tol", [(11, 2.5), (3, 4.0), (2, 4.0)])
def test_disc_coverage_against_cv2(radius, mean_tol):
    """A filled anti-aliased circle: the same interior, rims within a mean
    of ``mean_tol`` DN over the circle's bounding box."""
    n = 2 * radius + 9
    want = np.zeros((n, n), np.uint8)
    cv2.circle(want, (n // 2, n // 2), radius, 255, -1, cv2.LINE_AA)
    yy, xx = synth._pixel_grid(n, n, CPU)
    ours = 255.0 * synth._disc(xx - n // 2, yy - n // 2, radius)
    d = np.abs(torch.round(ours).numpy() - want)
    assert d.mean() < mean_tol, d.mean()
    inner = (xx - n // 2) ** 2 + (yy - n // 2) ** 2 <= (radius - 1) ** 2
    assert (torch.round(ours)[inner] == 255).all()
    assert (want[inner.numpy()] == 255).all()


@pytest.mark.parametrize("axes, angle", [((38, 22), -30.0), ((26, 17), 71.5),
                                          ((4, 2), -30.0)])
def test_filled_ellipse_against_cv2(axes, angle):
    """cv2's filled ellipse without anti-aliasing (the hand's, the glare's
    on float images): the same pixels but for at most a third of the
    rim's length (cv2 fills a polygon with its edge pixels; 0.08–0.30 of
    it measured)."""
    n = 2 * max(axes) + 9
    want = np.zeros((n, n), np.uint8)
    cv2.ellipse(want, (n // 2, n // 2), axes, angle, 0, 360, 255, -1)
    yy, xx = synth._pixel_grid(n, n, CPU)
    _, d = synth._ellipse_d(yy, xx, n // 2, n // 2, *axes, angle)
    ours = (d <= synth.FILL_REACH).numpy()
    rim = 2 * np.pi * np.sqrt((axes[0] ** 2 + axes[1] ** 2) / 2)
    assert np.count_nonzero(ours != (want > 0)) <= rim / 3


def test_thick_line_against_cv2():
    """A thick cv2 line with round caps (the hand's arm and fingers): the
    same pixels but for at most a third of the outline's length (cv2
    rounds the band's corners to whole pixels and draws the caps as
    polygons; 0.10–0.30 of it measured)."""
    for p0, p1, t in (((20, 30), (70, 95), 44), ((40, 12), (46, 60), 7),
                      ((15, 80), (90, 81), 40)):
        want = np.zeros((110, 110), np.uint8)
        cv2.line(want, p0, p1, 255, t)
        yy, xx = synth._pixel_grid(110, 110, CPU)
        ours = synth._capsule(yy, xx, p0, p1, synth._thick_half(t)).numpy()
        outline = 2 * np.hypot(p1[0] - p0[0], p1[1] - p0[1]) + np.pi * t
        assert np.count_nonzero(ours != (want > 0)) <= outline / 3


def test_clutter_keep_out_equals_cv2_dilate():
    """The host's box test against the board (the nearest-pixel map within
    12 px of a box) equals the reference's ``dilate(mask, 25×25)`` read
    over the box, on 400 boxes around a default view."""
    size = 456
    src = np.array([[12, 12], [444, 12], [444, 444], [12, 444]], np.float32)
    m = cv2.getPerspectiveTransform(src, synth.default_corners(HW))
    hinv = np.linalg.inv(m)
    mask = cv2.warpPerspective(np.full((size, size), 255, np.uint8), m,
                               HW[::-1], flags=cv2.INTER_NEAREST)
    keep_out = cv2.dilate(mask, np.ones((25, 25), np.uint8))
    rng = np.random.default_rng(3)
    h, w = HW
    for _ in range(400):
        x, y = int(rng.integers(0, w)), int(rng.integers(0, h))
        r = int(rng.integers(8, 30))
        y0, y1 = max(0, y - r - 4), min(h, y + r + 4)
        x0, x1 = max(0, x - r - 4), min(w, x + r + 4)
        ky0, ky1 = max(0, y0 - 12), min(h, y1 + 12)
        kx0, kx1 = max(0, x0 - 12), min(w, x1 + 12)
        v = np.arange(ky0, ky1, dtype=np.float64)[:, None]
        u = np.arange(kx0, kx1, dtype=np.float64)[None, :]
        ours = bool(synth._nearest_inside(hinv, size, u, v, np.rint).any())
        assert ours == bool(keep_out[y0:y1, x0:x1].any()), (x, y, r)


# -- the canonical board and the camera frame against the reference -----------

def test_render_canonical_against_the_reference():
    labels = _labels()
    for kw in ({}, dict(stone_jitter=0.07, jitter_key=4, wood_texture=0.1),
               dict(glare=0.5, palette="bamboo", jitter_key=2)):
        want = jsynth.render_canonical(labels, rng=np.random.default_rng(1),
                                       **kw)
        ours = synth.render_canonical(labels, rng=np.random.default_rng(1),
                                      device="cpu", **kw)
        assert ours.dtype == torch.uint8 and ours.shape == want.shape
        mean, p99 = _stats(ours.numpy(), want)
        assert mean < 1.5 and p99 <= 22, (kw, mean, p99)


def test_wood_grain_is_the_references():
    np.testing.assert_array_equal(synth._wood_grain(456, 0.1, 7),
                                  jsynth._wood_grain(456, 0.1, 7))


GROUPS = {
    "plain": {},
    "hard": dict(stone_jitter=0.07, light_gradient=0.3, blur_sigma=1.2,
                 shadow=0.18),
    "t3 + clutter": dict(stone_jitter=0.07, wood_texture=0.10,
                         vignette=0.22, glare=0.5, clutter=3),
    "lens + rolling shutter": dict(lens_k1=0.06, rolling_shutter=(3.5, 2.0)),
    "hand": dict(hand=(300.0, 200.0, 0.8), white_balance=0.05),
    "walnut": dict(palette="walnut", motion_blur=(4.0, 1.5)),
}

#: (mean, 99th percentile) of |port − reference| in DN, per group.
TOLS = {"plain": (0.4, 8), "hard": (0.15, 2), "t3 + clutter": (0.6, 12),
        "lens + rolling shutter": (0.35, 6), "hand": (0.45, 8),
        "walnut": (0.35, 8)}


@pytest.mark.parametrize("group", list(GROUPS))
def test_render_frame_against_the_reference(group):
    """``noise=0`` (the noise is the one departure): corners bitwise, the
    frame within the group's stated tolerance."""
    kw = GROUPS[group]
    want, want_c = jsynth.render_frame(_labels(), frame_hw=HW, noise=0,
                                       seed=3, **kw)
    ours, corners = synth.render_frame(_labels(), frame_hw=HW, noise=0,
                                       seed=3, device="cpu", **kw)
    assert np.array_equal(corners, want_c) and corners.dtype == np.float32
    assert ours.dtype == torch.uint8 and ours.shape == (*HW, 3)
    mean, p99 = _stats(ours.numpy(), want)
    tol_mean, tol_p99 = TOLS[group]
    assert mean < tol_mean and p99 <= tol_p99, (group, mean, p99)


def test_read_board_batch_reads_the_same_labels_from_either_render():
    """Both renders of a hard frame, read by the port's fixed-corner
    classifier: the same labels, and the board's."""
    labels = _labels(120, seed=5)
    kw = dict(stone_jitter=0.07, light_gradient=0.3, blur_sigma=1.2,
              shadow=0.18, glare=0.5, shot_noise=0.4)
    want, corners = jsynth.render_frame(labels, frame_hw=(480, 854), seed=9,
                                        **kw)
    ours, _ = synth.render_frame(labels, frame_hw=(480, 854), seed=9,
                                 device="cpu", **kw)
    frames = torch.stack([ours, torch.from_numpy(want)])
    read, _ = pipeline.read_board_batch(frames, torch.from_numpy(corners))
    assert np.array_equal(read[0].numpy(), read[1].numpy())
    assert np.array_equal(read[0].numpy(), labels)


@pytest.mark.parametrize("noise, shot", [(3.0, 0.0), (3.0, 0.4)])
def test_device_noise_statistics(noise, shot):
    """The device-drawn sensor noise against the reference's host draw:
    the mean and standard deviation of (noisy − clean) agree to 0.05 DN
    (both truncate, so both means sit near −0.5), and a frame's seed fixes
    its noise."""
    labels = _labels()
    kw = dict(shot_noise=shot, stone_jitter=0.07)

    def moments(render, **dev):
        clean = render(labels, frame_hw=HW, noise=0, seed=5, **kw, **dev)[0]
        noisy = render(labels, frame_hw=HW, noise=noise, seed=5, **kw,
                       **dev)[0]
        d = np.asarray(noisy, np.float64) - np.asarray(clean, np.float64)
        return d.mean(), d.std()

    ours = moments(synth.render_frame, device="cpu")
    want = moments(jsynth.render_frame)
    assert abs(ours[0] - want[0]) < 0.05 and abs(ours[1] - want[1]) < 0.05, \
        (ours, want)
    a = synth.render_frame(labels, frame_hw=HW, seed=5, device="cpu")[0]
    b = synth.render_frame(labels, frame_hw=HW, seed=5, device="cpu")[0]
    c = synth.render_frame(labels, frame_hw=HW, seed=6, device="cpu")[0]
    assert torch.equal(a, b) and not torch.equal(a, c)
