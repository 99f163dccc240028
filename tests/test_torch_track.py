"""The port's tracker against the JAX reference on the CPU, function by
function: the sub-pixel shift and the chunked warp of ``ops/warp.py``, the
tracker's measurements in ``board/bf_auto.py`` (the discrete gates
compared as booleans), and the batched profile helpers against their
per-frame forms. The two engines and the slice whole are in
``test_torch_track_engines.py``."""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from camkifu_tpu.board import bf_auto as jbf
from camkifu_tpu.ops import warp as jwarp
from camkifu_tpu.utils import synth
from camkifu_tpu_torch.board import bf_auto
from camkifu_tpu_torch.ops import warp
from camkifu_tpu_torch.utils import still

torch.set_num_threads(1)

HW = (360, 640)
G = 19


def _t(a):
    return torch.from_numpy(np.array(a))


def _labels(n=80, seed=1):
    labels = np.zeros((G, G), np.int8)
    idx = np.random.default_rng(seed).choice(G * G, n, replace=False)
    labels.flat[idx[:n // 2]] = 1
    labels.flat[idx[n // 2:]] = 2
    return labels


# -- ops/warp.py --------------------------------------------------------------

@pytest.mark.parametrize("offset", [
    (0.0, 0.0), (0.3, -0.7), (-1.25, 1.6), (1.0, -1.0), (2.0, -2.0),
    (1.999, 0.5), (3.5, -4.0), (-2.0, 1.0), (0.999, -0.001)])
def test_subpixel_shift_matches_jax(offset):
    """Offsets inside, at and beyond the ±2 px range (an offset above 1 px
    fades the image in both: the blend has no shift past +1)."""
    img = np.random.default_rng(0).random((24, 24, 3), np.float32)
    off = np.array(offset, np.float32)
    ref = np.asarray(jwarp._subpixel_shift(jnp.asarray(img),
                                           jnp.asarray(off)))
    ours = warp._subpixel_shift(_t(img), _t(off))
    np.testing.assert_allclose(ours.numpy(), ref, atol=1e-6)


def test_subpixel_shift_batch_is_per_image():
    rng = np.random.default_rng(1)
    imgs = rng.random((5, 16, 16, 3), np.float32)
    offs = rng.uniform(-2.5, 2.5, (5, 2)).astype(np.float32)
    ours = warp._subpixel_shift(_t(imgs), _t(offs))
    for i in range(5):
        ref = np.asarray(jwarp._subpixel_shift(jnp.asarray(imgs[i]),
                                               jnp.asarray(offs[i])))
        np.testing.assert_allclose(ours[i].numpy(), ref, atol=1e-6)


def test_shifted_crop_is_crop_then_shift():
    """The fused gather equals the reference's two steps: a window cut at
    each image's integer origin, padded by ITS edge, then shifted."""
    rng = np.random.default_rng(2)
    src = rng.random((4, 40, 40, 3), np.float32)
    origin = np.array([[3, 9], [0, 0], [12, 1], [7, 12]], np.int64)
    offs = rng.uniform(-2.0, 1.0, (4, 2)).astype(np.float32)
    ours = warp._shifted_crop(_t(src), _t(origin), 28, _t(offs))
    for i, (x0, y0) in enumerate(origin):
        cut = src[i, y0:y0 + 28, x0:x0 + 28]
        ref = np.asarray(jwarp._subpixel_shift(jnp.asarray(cut),
                                               jnp.asarray(offs[i])))
        np.testing.assert_allclose(ours[i].numpy(), ref, atol=1e-6)


@functools.lru_cache(maxsize=1)
def _drifting():
    """20 frames of one board under a drifting camera, 360×640."""
    corners = still.handheld_corners(20, HW, drift=(6.0, 4.5),
                                     periods=(5.0, 6.0))
    labels = _labels()
    frames = np.stack([synth.render_frame(labels, c, HW, seed=11)[0]
                       for c in corners])
    return frames, corners


def test_handheld_corners_are_the_reference_tests_poses():
    """tests/test_tracking.py's drifting and rotating-zooming poses."""
    base = synth.default_corners((720, 1280))
    got = still.handheld_corners(4, (720, 1280), periods=(5.0, 6.0))
    for i in range(4):
        drift = np.array([12.0 * np.sin(i / 5), 9.0 * np.cos(i / 6)],
                         np.float32)
        np.testing.assert_allclose(got[i], base + drift[None], atol=1e-4)
    got = still.handheld_corners(4, (720, 1280), drift=(6.0, 4.0),
                                 periods=(5.0, 6.0), rate_deg=0.15,
                                 scale_rate=0.002)
    c0 = base.mean(axis=0)
    th = np.deg2rad(0.15) * 3
    rot = np.array([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]],
                   np.float32)
    want = c0 + 1.002 ** 3 * (base - c0) @ rot.T \
        + np.array([6.0 * np.sin(3 / 5), 4.0 * np.cos(3 / 6)], np.float32)
    np.testing.assert_allclose(got[3], want, atol=1e-3)


def _same_canon(ours: np.ndarray, ref: np.ndarray, unit: float = 1.0):
    """Canonical images in [0, ``unit``] agree: within 1e-4 of the unit
    everywhere but on at most 1 value in 100,000, and within 1e-3 there
    (the fixed-camera warp's tolerance). The source coordinates are summed
    term by term here and as a matrix product in the reference; across a
    grid line's edge (150 levels a pixel) their last bits show."""
    err = np.abs(ours - ref) / unit
    assert err.max() <= 1e-3, err.max()
    assert (err > 1e-4).mean() <= 1e-5, (err > 1e-4).mean()


def test_warp_batch_chunked_matches_jax():
    """B = 20, chunk 8 (so the batch is padded), drifting corners."""
    frames, corners = _drifting()
    ref = np.asarray(jax.jit(jwarp.warp_batch_chunked)(
        jnp.asarray(frames), jnp.asarray(corners)))
    ours = warp.warp_batch_chunked(_t(frames), _t(corners))
    assert ours.shape == (20, 304, 304, 3)
    _same_canon(ours.numpy(), ref, unit=255.0)
    scaled = warp.warp_batch_chunked(_t(frames), _t(corners),
                                     scale=1.0 / 255.0)
    _same_canon(scaled.numpy(), ref / 255.0)


def test_warp_batch_chunked_needs_the_even_count_median(monkeypatch):
    """A chunk of 8 has no middle frame: the reference averages the two
    middle corner sets. With ``torch.median`` (the lower one) in place of
    the quantile the canonical images move."""
    frames, corners = _drifting()
    ref = np.asarray(jax.jit(jwarp.warp_batch_chunked)(
        jnp.asarray(frames[:8]), jnp.asarray(corners[:8])))
    good = warp.warp_batch_chunked(_t(frames[:8]), _t(corners[:8])).numpy()
    _same_canon(good, ref, unit=255.0)
    monkeypatch.setattr(
        torch, "quantile",
        lambda x, q, dim: torch.median(x, dim=dim).values)
    bad = warp.warp_batch_chunked(_t(frames[:8]), _t(corners[:8])).numpy()
    assert np.abs(bad - ref).max() > 1e-2 * 255


# -- the tracker's measurements -------------------------------------------------

@functools.lru_cache(maxsize=1)
def _rects():
    """(8, 160, 160) rectified gray canvases of the drifting frames, cut
    through the first frame's corners with the tracking margin (by JAX),
    and where those corners land on the canvas."""
    frames, corners = _drifting()
    res = 160
    H = jbf._rect_H(jnp.asarray(corners[0]), jbf.TRACK_MARGIN, res)
    gray = jax.vmap(jbf.rgb_to_gray_u8)(jnp.asarray(frames[:8]))
    rects = jax.vmap(lambda g: jbf._sample_rect(g, H, res))(gray)
    rc = jwarp.apply_homography(jwarp._inv3(H), jnp.asarray(corners[0]))
    return np.asarray(rects), np.asarray(rc)


@functools.lru_cache(maxsize=1)
def _profiles():
    """JAX's six split profiles of the canvases, each (8, 160)."""
    rects, _ = _rects()
    return [np.asarray(p) for p in jax.vmap(
        lambda r: jbf._split_profiles(r, G))(jnp.asarray(rects))]


def test_split_profiles_batch_matches_jax_and_the_per_frame_form():
    rects, _ = _rects()
    ours = bf_auto._split_profiles(_t(rects), G)
    assert len(ours) == 6
    for got, ref in zip(ours, _profiles()):
        assert got.shape == (8, 160)
        np.testing.assert_allclose(got.numpy(), ref, atol=1e-5)
    for i in (0, 5):
        one = bf_auto._split_profiles(_t(rects[i]), G)
        for got, whole in zip(one, ours):
            np.testing.assert_allclose(got.numpy(), whole[i].numpy(),
                                       atol=1e-6)


def test_corr_shift_matches_jax():
    cf = _profiles()[0]
    ref = cf[0]
    S = 6
    d_j, sh_j = jbf._corr_shift(jnp.asarray(cf), jnp.asarray(ref), S)
    d_t, sh_t = bf_auto._corr_shift(_t(cf), _t(ref), S)
    np.testing.assert_allclose(d_t.numpy(), np.asarray(d_j), atol=1e-4)
    np.testing.assert_allclose(sh_t.numpy(), np.asarray(sh_j), rtol=1e-5)
    assert abs(float(d_t[0])) < 1e-4 and float(np.abs(d_t.numpy()).max()) > 0.5
    # A flat correlation ties everywhere: both take the first shift.
    flat = np.ones((2, 40), np.float32)
    d_j, _ = jbf._corr_shift(jnp.asarray(flat), jnp.zeros(40), 3)
    d_t, _ = bf_auto._corr_shift(_t(flat), torch.zeros(40), 3)
    assert d_t.tolist() == np.asarray(d_j).tolist() == [3.0, 3.0]


@pytest.mark.parametrize("ok", [
    [0, 0, 1, 0, 1, 1, 0, 0], [1, 1, 1, 1, 1, 1, 1, 1],
    [0, 0, 0, 0, 0, 0, 0, 0], [1, 0, 0, 0, 0, 0, 0, 1]])
def test_hold_bad_equals_jax(ok):
    """The last good value is held, 0 before the first (an all-bad
    prefix): equal, not close."""
    d = np.random.default_rng(3).normal(size=8).astype(np.float32)
    ok = np.array(ok, bool)
    ref = np.asarray(jbf._hold_bad(jnp.asarray(d), jnp.asarray(ok)))
    assert np.array_equal(bf_auto._hold_bad(_t(d), _t(ok)).numpy(), ref)


def test_half_geometry_matches_jax():
    _, rc = _rects()
    ref = jbf._half_geometry(jnp.asarray(rc), 160, G)
    ours = bf_auto._half_geometry(_t(rc), 160, G)
    np.testing.assert_allclose([float(v) for v in ours],
                               [float(v) for v in ref], rtol=1e-6)


def _seed_lattice():
    """(first_x, first_y, pitch_x, pitch_y) of the seed's lattice on the
    canvases of ``_rects``."""
    _, rc = _rects()
    return (0.5 * (rc[0, 0] + rc[3, 0]), 0.5 * (rc[0, 1] + rc[1, 1]),
            (rc[1, 0] - rc[0, 0]) / (G - 1), (rc[3, 1] - rc[0, 1]) / (G - 1))


def test_teeth_fit_matches_jax_per_frame_and_stacked():
    ct, cb = _profiles()[2], _profiles()[3]
    fx, _, px, _ = _seed_lattice()
    firsts = fx + np.linspace(-1.5, 1.5, 8).astype(np.float32)
    fit = jax.vmap(lambda p, f: jbf._teeth_fit(p, f, px, G))
    for prof in (ct, cb):
        da_j, b_j, ok_j = fit(jnp.asarray(prof), jnp.asarray(firsts))
        da_t, b_t, ok_t = bf_auto._teeth_fit(_t(prof), _t(firsts),
                                             float(px), G)
        np.testing.assert_allclose(da_t.numpy(), np.asarray(da_j), atol=1e-4)
        np.testing.assert_allclose(b_t.numpy(), np.asarray(b_j), atol=1e-5)
        assert np.array_equal(ok_t.numpy(), np.asarray(ok_j))
        assert ok_t.any()
    # Two halves stacked, each with its own pitch, as _track_measure fits.
    both = bf_auto._teeth_fit(
        _t(np.stack([ct, cb])), _t(np.stack([firsts, firsts + 0.25])),
        torch.tensor([[float(px)], [float(px) * 1.01]]), G)
    one = bf_auto._teeth_fit(_t(cb), _t(firsts + 0.25), float(px) * 1.01, G)
    for a, b in zip(both, one):
        np.testing.assert_allclose(a[1].numpy(), b.numpy(), atol=1e-6)


def test_lattice_offset_matches_jax():
    cf, rf = _profiles()[0], _profiles()[1]
    fx, fy, px, py = _seed_lattice()
    for prof, first, pitch in ((cf[3], fx, px), (rf[6], fy, py),
                               (cf[0], fx + 2.5, px)):
        d_j, s_j = jbf._lattice_offset(jnp.asarray(prof), first, pitch, G, 6)
        d_t, s_t = bf_auto._lattice_offset(_t(prof), float(first),
                                           float(pitch), G, 6)
        assert abs(float(d_t) - float(d_j)) < 1e-4
        assert float(s_t) == pytest.approx(float(s_j), rel=1e-5)


#: ``_abs_lock_update`` cases: each gate forced both ways. The lattice of
#: frame 0 sits on the seed comb, so a comb asked for 2.5 px to its right
#: finds a residual of −2.5 px, outside the 0.12-cell deadband.
LOCK_CASES = {
    "accepted": dict(shift=2.5, dx0=0.0, ok0=True, moves=True),
    "frame_not_ok": dict(shift=2.5, dx0=0.0, ok0=False, moves=False),
    "inside_deadband": dict(shift=0.3, dx0=0.0, ok0=True, moves=False),
    "referee_prefers_held": dict(shift=2.5, dx0=-2.5, ok0=True, moves=False),
    "flat_profile_not_sharp": dict(shift=2.5, dx0=0.0, ok0=True, moves=False,
                                   flat=True),
}


@pytest.mark.parametrize("case", sorted(LOCK_CASES))
def test_abs_lock_update_gates_match_jax(case):
    c = LOCK_CASES[case]
    cf, rf = _profiles()[0], _profiles()[1]
    cols0, rows0 = cf[0], rf[0]
    if c.get("flat"):
        cols0 = np.full_like(cols0, 0.5)
        rows0 = np.full_like(rows0, 0.5)
    fx, fy, px, py = _seed_lattice()
    fx, fy = fx + c["shift"], fy + c["shift"]
    e0 = np.array([0.4, -0.4], np.float32)
    ref = np.asarray(jbf._abs_lock_update(
        jnp.asarray(cols0), jnp.asarray(rows0), fx, fy, px, py,
        jnp.float32(c["dx0"]), jnp.float32(c["dx0"]), jnp.bool_(c["ok0"]),
        jnp.asarray(e0), 6, G))
    ours = bf_auto._abs_lock_update(
        _t(cols0), _t(rows0), float(fx), float(fy), float(px), float(py),
        torch.tensor(c["dx0"]), torch.tensor(c["dx0"]),
        torch.tensor(c["ok0"]), _t(e0), 6, G).numpy()
    # The gate itself: the held value comes back bit for bit, or does not.
    assert (ours != e0).tolist() == (ref != e0).tolist() \
        == [c["moves"], c["moves"]]
    np.testing.assert_allclose(ours, ref, atol=1e-4)


def _measure_inputs(ref_frame: int):
    profs = _profiles()
    _, rc = _rects()
    return profs, profs[0][ref_frame], profs[1][ref_frame], rc


@pytest.mark.parametrize("case", ["drift", "occluded", "reference_off"])
def test_track_measure_matches_jax(case):
    """Values within 1e-4, the three boolean outputs equal. ``occluded``
    flattens two frames' profiles (their gates close), ``reference_off``
    measures against a later frame's profiles (a large coarse shift)."""
    profs, ref_col, ref_row, rc = _measure_inputs(
        5 if case == "reference_off" else 0)
    profs = [p.copy() for p in profs]
    if case == "occluded":
        for p in profs:
            p[2] = 0.5
            p[6] = np.random.default_rng(4).random(160).astype(np.float32)
    S = 6
    geom_j = jbf._half_geometry(jnp.asarray(rc), 160, G)
    out_j = jbf._track_measure(*[jnp.asarray(p) for p in profs],
                               jnp.asarray(ref_col), jnp.asarray(ref_row), S,
                               geom_j, G)
    geom_t = bf_auto._half_geometry(_t(rc), 160, G)
    out_t = bf_auto._track_measure(*[_t(p) for p in profs], _t(ref_col),
                                   _t(ref_row), S, geom_t, G)
    names = ("tx", "ty", "theta", "sigma", "sharp", "ok", "rot_ok", "scl_ok")
    ok = np.asarray(out_j[5])
    for name, got, ref in zip(names, out_t, out_j):
        got, ref = got.numpy(), np.asarray(ref)
        if got.dtype == bool:
            assert np.array_equal(got, ref), name
        elif name == "sharp":
            np.testing.assert_allclose(got, ref, rtol=1e-5, err_msg=name)
        else:
            # A rejected frame's values are held over, never used: its flat
            # correlation's parabola vertex is rounding noise.
            np.testing.assert_allclose(got[ok], ref[ok], atol=1e-4,
                                       err_msg=name)
    assert ok[0] and ok.sum() >= 6 and (case != "occluded" or not ok[2])


def test_apply_similarity_and_align_quality_match_jax():
    profs, _, _, rc = _measure_inputs(0)
    rng = np.random.default_rng(5)
    dx, dy = (rng.uniform(-3, 3, (2, 8))).astype(np.float32)
    theta = rng.uniform(-0.05, 0.05, 8).astype(np.float32)
    sigma = rng.uniform(-0.03, 0.03, 8).astype(np.float32)
    ref = np.asarray(jbf._apply_similarity(
        jnp.asarray(rc), *[jnp.asarray(v) for v in (dx, dy, theta, sigma)]))
    ours = bf_auto._apply_similarity(_t(rc), _t(dx), _t(dy), _t(theta),
                                     _t(sigma))
    np.testing.assert_allclose(ours.numpy(), ref, atol=1e-4)
    ref = np.asarray(jbf._align_quality(
        jnp.asarray(profs[0]), jnp.asarray(profs[1]), jnp.asarray(rc),
        jnp.asarray(dx), jnp.asarray(dy), jnp.asarray(sigma), G))
    ours = bf_auto._align_quality(_t(profs[0]), _t(profs[1]), _t(rc),
                                  _t(dx), _t(dy), _t(sigma), G)
    np.testing.assert_allclose(ours.numpy(), ref, atol=1e-5)
    # A comb pushed off the canvas is disqualified in both.
    far = np.full(8, 60.0, np.float32)
    ref = np.asarray(jbf._align_quality(
        jnp.asarray(profs[0]), jnp.asarray(profs[1]), jnp.asarray(rc),
        jnp.asarray(far), jnp.asarray(dy), jnp.asarray(sigma), G))
    ours = bf_auto._align_quality(_t(profs[0]), _t(profs[1]), _t(rc),
                                  _t(far), _t(dy), _t(sigma), G)
    assert (ours.numpy() < -5).all() and (ref < -5).all()


def test_profile_shift_matches_jax():
    p = _profiles()[0][0]
    for delta in (0.0, 1.75, -3.2):
        ref = np.asarray(jbf._profile_shift(jnp.asarray(p), delta))
        ours = bf_auto._profile_shift(_t(p), torch.tensor(delta))
        np.testing.assert_allclose(ours.numpy(), ref, atol=1e-6)


def test_track_constants_equal_the_reference():
    for name in ("TRACK_MARGIN", "TRACK_WIN_OFFSET", "TRACK_MIN_SHARPNESS",
                 "TRACK_REF_EMA", "TRACK_ALIGN_TRIP", "TRACK_JUMP_TRIP",
                 "TRACK_MAX_THETA", "TRACK_MAX_SIGMA", "TRACK_DIFF_AGREE",
                 "TRACK_ABS_DEADBAND"):
        assert getattr(bf_auto, name) == getattr(jbf, name), name
