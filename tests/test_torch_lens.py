"""The port's radial lens model (``camkifu_tpu_torch/ops/lens.py``) and
the warp's lens mode against the JAX reference on the CPU: the algebra,
the frame undistortion, the three canonical warps with a lens, and the
numpy renderer's lens against ``synth.render_frame``'s."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from camkifu_tpu.ops import lens as JL
from camkifu_tpu.ops import warp as jwarp
from camkifu_tpu.utils import synth
from camkifu_tpu_torch.ops import lens as L
from camkifu_tpu_torch.ops import warp
from camkifu_tpu_torch.ops.cuda import warp_kernel
from camkifu_tpu_torch.utils import still

torch.set_num_threads(1)

HW = (720, 1280)
SMALL = (360, 640)
#: Points, px: the same float32 operations in both packages.
TOL_PTS = 1e-4


def _t(a):
    return torch.from_numpy(np.array(a))


def _points(k1, hw=HW, n=400):
    """``n`` random frame points; for pincushion only those inside 0.9 of
    the fold radius sqrt(−1/(3·k1)), where the model is invertible (as
    tests/test_lens.py keeps them)."""
    rng = np.random.default_rng(3)
    pts = rng.uniform([0, 0], [hw[1], hw[0]], size=(n, 2)).astype(np.float32)
    if k1 < 0:
        lens = L.make_lens(k1, hw)
        nrm = (pts - [lens.cx, lens.cy]) / [lens.sx, lens.sy]
        pts = pts[np.linalg.norm(nrm, axis=1) < 0.9 * np.sqrt(-1 / (3 * k1))]
        assert len(pts) > 50
    return pts


@pytest.mark.parametrize("k1", [0.08, 0.03, -0.05, -0.12, 0.2])
def test_distort_and_undistort_match_jax(k1):
    pts = _points(k1)
    lens_t, lens_j = L.make_lens(k1, HW), JL.make_lens(k1, HW)
    d_t = L.distort_pts(lens_t, _t(pts))
    d_j = JL.distort_pts(lens_j, jnp.asarray(pts))
    np.testing.assert_allclose(d_t.numpy(), np.asarray(d_j), atol=TOL_PTS)
    u_t = L.undistort_pts(lens_t, _t(pts))
    u_j = JL.undistort_pts(lens_j, jnp.asarray(pts))
    np.testing.assert_allclose(u_t.numpy(), np.asarray(u_j), atol=TOL_PTS)
    # The roundtrip, tests/test_lens.py's 2e-3 px.
    back = L.undistort_pts(lens_t, d_t).numpy()
    assert np.abs(back - pts).max() < 2e-3


def test_lens_constructors_match_jax():
    for ours, ref in ((L.make_lens(0.06, HW), JL.make_lens(0.06, HW)),
                      (L.scale_lens(L.make_lens(0.06, HW), 0.4, 0.7),
                       JL.scale_lens(JL.make_lens(0.06, HW), 0.4, 0.7)),
                      (L.identity_lens(), JL.identity_lens())):
        assert tuple(ours) == tuple(ref)
    pts = _t(_points(0.0))
    assert L.distort_pts(None, pts) is pts
    assert L.undistort_pts(None, pts) is pts
    # k1 = 0 is an identity up to rounding.
    np.testing.assert_allclose(L.distort_pts(L.make_lens(0.0, HW), pts),
                               pts, atol=1e-4)


def test_stack_lenses_applies_each_lens_to_its_own_points():
    lenses = [L.make_lens(k, HW) for k in (0.0, 0.03, 0.06, -0.04)]
    stacked = L.stack_lenses(lenses, "cpu")
    ref = JL.stack_lenses([JL.make_lens(k, HW) for k in (0.0, 0.03, 0.06,
                                                         -0.04)])
    for ours, theirs in zip(stacked, ref):
        assert ours.shape == (4,) and ours.dtype == torch.float32
        np.testing.assert_array_equal(ours.numpy(), np.asarray(theirs))
    assert L.as_table(stacked).shape == (4, 5)
    pts = np.stack([_points(0.0, n=12)] * 4)               # (4, 12, 2)
    for fn in (L.distort_pts, L.undistort_pts):
        all_t = fn(stacked, _t(pts))
        for i, ln in enumerate(lenses):
            np.testing.assert_allclose(all_t[i].numpy(),
                                       fn(ln, _t(pts[i])).numpy(), atol=1e-4)


def test_undistort_keeps_nan_and_refuses_what_is_not_a_lens():
    """A NaN corner (a failed detection) stays NaN, with no error; a half
    NaN point comes out as the reference's does."""
    nan = float("nan")
    pts = np.array([[nan, nan], [nan, 3.0], [100.0, 200.0]], np.float32)
    out = L.undistort_pts(L.make_lens(0.06, HW), _t(pts)).numpy()
    ref = np.asarray(JL.undistort_pts(JL.make_lens(0.06, HW),
                                      jnp.asarray(pts)))
    assert np.isnan(out[0]).all() and np.isfinite(out[2]).all()
    np.testing.assert_allclose(out, ref, atol=TOL_PTS)
    for fn in (L.distort_pts, L.undistort_pts):
        with pytest.raises(TypeError, match="Lens"):
            fn(object(), pts)


@pytest.mark.parametrize("gray", [False, True])
def test_undistort_frame_matches_jax(gray):
    """A 360×640 render through k1 = 0.06, RGB and gray: uint8 within one
    level (a value on a rounding boundary may fall either way)."""
    labels = np.zeros((19, 19), np.int8)
    labels[4, 4], labels[12, 7] = 1, 2
    frame, _ = synth.render_frame(labels, frame_hw=SMALL, lens_k1=0.06,
                                  seed=2)
    if gray:
        frame = np.ascontiguousarray(frame[..., 1])
    ours = L.undistort_frame(_t(frame), L.make_lens(0.06, SMALL))
    ref = np.asarray(JL.undistort_frame(jnp.asarray(frame),
                                        JL.make_lens(0.06, SMALL)))
    assert ours.dtype == torch.uint8 and ours.shape == frame.shape
    diff = np.abs(ours.numpy().astype(np.int16) - ref.astype(np.int16))
    assert diff.max() <= 1, diff.max()
    # A batch is one warp of the same frames.
    if not gray:
        both = L.undistort_frame(_t(np.stack([frame, frame])),
                                 L.make_lens(0.06, SMALL))
        assert torch.equal(both[1], ours)


def _lens_game(n=20, k1=0.06):
    """``n`` frames of one board at 360×640 under a drifting camera seen
    through a k1 lens, and their (distorted) true corners."""
    labels = np.zeros((19, 19), np.int8)
    idx = np.random.default_rng(1).choice(361, 80, replace=False)
    labels.flat[idx[:40]] = 1
    labels.flat[idx[40:]] = 2
    pin = still.handheld_corners(n, SMALL, drift=(6.0, 4.5),
                                 periods=(5.0, 6.0))
    frames, truth = [], []
    for c in pin:
        f, t = synth.render_frame(labels, c, SMALL, seed=11, lens_k1=k1)
        frames.append(f)
        truth.append(t)
    return np.stack(frames), np.stack(truth)


def test_warp_to_canonical_and_fixed_with_a_lens_match_jax():
    """The fixed-camera warps with a lens: within 1e-3 of the [0, 1] range
    (the pinhole warp's tolerance, tests/test_torch_ops.py)."""
    frames, truth = _lens_game(2)
    lens_t, lens_j = L.make_lens(0.06, SMALL), JL.make_lens(0.06, SMALL)
    ref = np.asarray(jwarp.warp_to_canonical(
        jnp.asarray(frames[0]), jnp.asarray(truth[0]), lens=lens_j))
    ours = warp.warp_to_canonical(_t(frames[0]), _t(truth[0]), lens=lens_t)
    assert np.abs(ours.numpy() - ref).max() / 255.0 <= 1e-3
    # Without the lens the same corners read a different image.
    plain = warp.warp_to_canonical(_t(frames[0]), _t(truth[0])).numpy()
    assert np.abs(plain - ref).max() / 255.0 > 0.1
    ref_b = np.asarray(jwarp.warp_batch_fixed(
        jnp.asarray(frames), jnp.asarray(truth[0]), lens=lens_j))
    ours_b = warp.warp_batch_fixed(_t(frames), _t(truth[0]),
                                   scale=1.0 / 255.0, lens=lens_t)
    assert np.abs(ours_b.numpy() - ref_b / 255.0).max() <= 1e-3
    np.testing.assert_allclose(ours_b[0].numpy(), ours.numpy() / 255.0,
                               atol=1e-6)


def test_warp_batch_chunked_with_a_lens_matches_jax():
    """B = 20, chunk 8 (a padded chunk), drifting corners through the
    lens, at tests/test_torch_track.py's chunked-warp tolerance."""
    frames, truth = _lens_game(20)
    ref = np.asarray(jax.jit(jwarp.warp_batch_chunked)(
        jnp.asarray(frames), jnp.asarray(truth),
        lens=JL.make_lens(0.06, SMALL)))
    ours = warp.warp_batch_chunked(_t(frames), _t(truth), scale=1.0 / 255.0,
                                   lens=L.make_lens(0.06, SMALL)).numpy()
    assert ours.shape == (20, 304, 304, 3)
    err = np.abs(ours - ref / 255.0)
    assert err.max() <= 1e-3, err.max()
    assert (err > 1e-4).mean() <= 1e-5, (err > 1e-4).mean()


def test_warp_lens_table_a_frame_equals_the_shared_lens():
    """The plain version's two lens forms: a (B, 5) table whose rows are
    one lens gives the shared lens's bits; rows of two lenses give each
    frame its own."""
    frames, truth = _lens_game(2)
    fr = _t(frames)
    H = warp.homography_dlt(warp.canonical_corners(), _t(truth[0]))
    shared = L.make_lens(0.06, SMALL)
    one = warp_kernel.warp_homography_ref(fr, H, (64, 96), 1.0, shared)
    table = L.as_table(L.stack_lenses([shared, shared], "cpu"))
    assert torch.equal(warp_kernel.warp_homography_ref(fr, H, (64, 96), 1.0,
                                                       table), one)
    two = L.stack_lenses([shared, L.make_lens(-0.04, SMALL)], "cpu")
    mixed = warp.warp_frames(fr, H, (64, 96), 1.0, L.as_table(two))
    assert torch.equal(mixed[0], one[0])
    other = warp_kernel.warp_homography_ref(
        fr[1:], H, (64, 96), 1.0, L.make_lens(-0.04, SMALL))
    assert torch.equal(mixed[1], other[0])
    with pytest.raises(ValueError, match="B, 5"):
        warp_kernel.warp_homography_ref(fr, H, (8, 8), 1.0, table[:1])
    with pytest.raises(TypeError, match="Lens"):
        warp.warp_frames(fr, H, (8, 8), 1.0, object())


@pytest.mark.parametrize("k1", [0.07, -0.05])
def test_renderer_lens_corners_match_synth(k1):
    """``still``'s lens: the same returned corners as
    ``synth.render_frame`` for the same pinhole corners and k1, within
    1e-2 px, the pinhole board drawn through the lens (its slab moves with
    the corners), and a lens-free render unchanged."""
    labels = np.zeros((19, 19), np.int8)
    base = synth.default_corners(SMALL)
    _, ref = synth.render_frame(labels, corners=base, frame_hw=SMALL,
                                lens_k1=k1)
    frame, ours = still.render_still(labels, frame_hw=SMALL, corners=base,
                                     lens_k1=k1)
    assert np.abs(ours - ref).max() < 1e-2
    pinhole, same = still.render_still(labels, frame_hw=SMALL, corners=base)
    assert np.array_equal(same, base)
    # Undistorting the lens frame straightens it back to the pinhole one.
    back = L.undistort_frame(_t(frame), L.make_lens(k1, SMALL)).numpy()
    inner = (slice(40, -40), slice(60, -60))
    assert np.abs(back[inner].astype(np.float32)
                  - pinhole[inner].astype(np.float32)).mean() < 8.0
    assert np.abs(frame[inner].astype(np.float32)
                  - pinhole[inner].astype(np.float32)).mean() > 10.0
