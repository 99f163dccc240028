"""The generator's frames show what it says they show: the board's true
corners and the stones' labels, with and without a lens."""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import scan
from benchmark.traffic import generator

HW = (270, 480)
G = 19


def _board() -> np.ndarray:
    rng = np.random.default_rng(4)
    board, _ = generator.opening_and_moves(rng, G, 60, 0)
    return board


def _at(img: torch.Tensor, pts: np.ndarray) -> np.ndarray:
    """Colours of the pixels nearest to points (N, 2) (x, y)."""
    x = np.clip(np.rint(pts[:, 0]).astype(int), 0, img.shape[1] - 1)
    y = np.clip(np.rint(pts[:, 1]).astype(int), 0, img.shape[0] - 1)
    return img[torch.as_tensor(y), torch.as_tensor(x)].numpy()


def _intersections(corners: np.ndarray, off: float = 0.0) -> np.ndarray:
    """(G·G, 2) frame positions of every intersection, row-major, moved
    by ``off`` cell down and right (off the grid lines, inside a stone,
    away from its glint)."""
    board = np.array([[0, 0], [G - 1, 0], [G - 1, G - 1], [0, G - 1]],
                     np.float64)
    h = generator._homography(board, corners.astype(np.float64))
    r, c = np.mgrid[0:G, 0:G] + off
    pts = np.stack([c.ravel(), r.ravel(), np.ones(G * G)], 1) @ h.T
    return pts[:, :2] / pts[:, 2:]


def _read(img: torch.Tensor, corners: np.ndarray) -> np.ndarray:
    """Labels read off a noise-free frame at the intersections' centres."""
    rgb = _at(img, _intersections(corners, 0.25)).astype(np.float32)
    refs = np.array([generator.BLACK_STONE, generator.WHITE_STONE])
    d = np.linalg.norm(rgb[:, None, :] - refs[None], axis=-1)
    lab = np.where(d.min(axis=1) < 40.0, 1 + d.argmin(axis=1), 0)
    return lab.reshape(G, G)


def test_stones_at_the_true_intersections():
    board = _board()
    corners = generator.default_corners(HW)
    img = generator.render_clean(torch.as_tensor(board)[None],
                                 corners[None],
                                 generator.pinhole_grid(HW, 0.0, "cpu"),
                                 0.08)[0]
    assert np.array_equal(_read(img, corners), board)


def test_lens_shows_the_distorted_corners():
    """Through a lens the stones sit where ``distort_corners`` puts the
    pinhole intersections, not at their pinhole positions."""
    board = _board()
    pin = generator.default_corners(HW)
    k1 = 0.08
    img = generator.render_clean(torch.as_tensor(board)[None], pin[None],
                                 generator.pinhole_grid(HW, k1, "cpu"),
                                 0.08)[0]
    pts = generator.distort_corners(_intersections(pin, 0.25), k1, HW)
    rgb = _at(img, pts).astype(np.float32)
    stone = board.ravel() != 0
    wood = np.array(generator.WOOD, np.float32)
    dark = np.linalg.norm(rgb - wood, axis=1) > 60.0
    assert np.array_equal(dark, stone)
    # Far from the pinhole positions: the lens moves the corners.
    d = generator.distort_corners(pin, k1, HW)
    assert np.all(np.linalg.norm(d - pin, axis=1) > 0.5)


def test_pool_layout_truth_and_corners():
    """``make_inputs``: batch r of the pool is one contiguous block; the
    truth adds ``moves_per_round`` stones, each from its frame on, to an
    opening of ``start_stones``; fixed corners do not move, handheld ones
    do, and run on without a jump where the pool wraps; the noise comes
    from the seed."""
    cfg = {"gsize": G, "zone": 16, "frame_hw": [90, 160], "streams": 2,
           "noise_sigma": 3.0, "line_width": 0.08,
           "camera": {"kind": "fixed", "perspective": 0.12}}
    mix = {"pool_batches": 2, "batch_frames": 16, "start_stones": [0, 150],
           "moves_per_round": 1}
    a = generator.make_inputs(cfg, mix, 2 ** 40 + 3, "cpu")
    b = generator.make_inputs(cfg, mix, 2 ** 40 + 3, "cpu")
    assert a["pool"].shape == (2, 2, 16, 90, 160, 3)
    assert a["pool"][1].is_contiguous()
    assert torch.equal(a["pool"], b["pool"])
    assert not torch.equal(a["pool"][0, 0, 0], a["pool"][0, 0, 1])  # noise
    stones = (a["truth"] != 0).sum(dim=(-1, -2))            # (R, S, B)
    per_frame = stones.permute(1, 0, 2).reshape(2, 32)
    added = per_frame - per_frame[:, :1]
    for s in range(2):
        assert 0 <= int(per_frame[s, 0]) <= 150
        steps = torch.diff(added[s])
        assert int(steps.sum()) == 1 and int((steps != 0).sum()) == 1
    assert torch.equal(a["corners"][0, :, 0], a["corners"][1, :, -1])
    cfg["camera"] = {"kind": "handheld", "perspective": 0.12,
                     "drift_px": [3.0, 2.0], "periods": [7.0, 9.0],
                     "phase_frames": 64.0, "k1_range": [-0.06, 0.08]}
    h = generator.make_inputs(cfg, mix, 5, "cpu")
    c = h["corners"].permute(1, 0, 2, 3, 4).reshape(2, 32, 4, 2)
    step = (c[:, 1:] - c[:, :-1]).abs().amax()
    assert step > 0
    assert (c[:, 0] - c[:, -1]).abs().amax() <= step + 1e-4
    assert ((h["k1"] >= -0.06) & (h["k1"] <= 0.08)).all()


def test_reference_warp_lands_the_corners():
    """The reference's canonical warp maps the canonical corner
    intersections onto the true corners (its homography and taps)."""
    corners = torch.as_tensor(generator.default_corners(HW))
    H = scan.homography_dlt(scan.canonical_corners(G, 16, "cpu"), corners)
    back = scan.apply_homography(H, scan.canonical_corners(G, 16, "cpu"))
    assert torch.allclose(back, corners, atol=1e-3)


def test_lens_grid_finite_and_undistorted_near_the_board():
    """The inverse lens steps diverge only far out in a 1080p frame's
    corners under the strongest pincushion; there the pixels keep their
    place. Everywhere a board can be, the grid is undistorted."""
    hw = (1080, 1920)
    y = torch.arange(hw[0], dtype=torch.float32)[:, None].expand(hw)
    x = torch.arange(hw[1], dtype=torch.float32)[None, :].expand(hw)
    r = torch.hypot(x - hw[1] / 2, y - hw[0] / 2)
    for k1 in (-0.06, -0.058, 0.08):
        yy, xx = generator.pinhole_grid(hw, k1, "cpu")
        assert torch.isfinite(yy).all() and torch.isfinite(xx).all()
        near = (r > 10) & (r < 900)
        assert not ((yy == y) & (xx == x))[near].any()


def test_every_seed_deals_the_same_cameras():
    """Moving cameras: every seed has the same set of phases and lenses,
    dealt to the streams in its own order."""
    cfg = {"gsize": G, "streams": 8, "frame_hw": [1080, 1920],
           "camera": {"kind": "handheld", "perspective": 0.12,
                      "drift_px": [18.0, 13.5], "periods": [7.0, 9.0],
                      "phase_frames": 64.0, "k1_range": [-0.06, 0.08]}}
    mix = {"pool_batches": 4, "batch_frames": 16, "start_stones": [0, 150],
           "moves_per_round": 1}
    a = generator.stream_plan(cfg, mix, 2 ** 31 + 1)
    b = generator.stream_plan(cfg, mix, 2 ** 31 + 2)
    assert [p["k1"] for p in a] != [p["k1"] for p in b]
    assert sorted(p["k1"] for p in a) == sorted(p["k1"] for p in b)
    first = sorted(tuple(p["pinhole"][0, 0]) for p in a)
    assert first == sorted(tuple(p["pinhole"][0, 0]) for p in b)
