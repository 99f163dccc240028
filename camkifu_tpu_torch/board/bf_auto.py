"""Automatic goban localization: the ``detect_corners`` path of
camkifu_tpu/board/bf_auto.py on tensors.

1. downscale the gray frame (and an R−B chroma channel) to a square
   detection resolution; edge maps (ops.edges, the CUDA edge kernel on the
   card) → the dense edge region's quadrilateral, scored by edge
   concentration and Hough peakedness (ops.hough, the CUDA Hough kernel);
2. rectify the frame by the coarse quad (the CUDA warp kernel) and race
   comb fits of the grid lines on the 1D lattice profiles, ranking every
   candidate by 2D lattice evidence on the seed rectification;
3. pin the outer grid lines to sub-pixel on a fresh rectification
   (line-dominated boards), or run the seeded comb races and evidence
   polish (stone-saturated boards).

Corners are the goban's corner intersections, tl/tr/br/bl, in frame
pixels. The reference's ``lax.cond`` branches become Python ``if``s on a
device scalar, which waits for the device twice per detection.

``detect_batch`` runs stage 1 for a whole batch (one edge and one Hough
launch) and refines each chunk of frames on a shared canvas (one warp
launch per chunk), validated on the device; ``detect_batch_stable`` is the
fixed-camera estimate of the recorded-video path.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from camkifu_tpu_torch.config import cvconf
from camkifu_tpu_torch.ops.color import rgb_to_gray, rgb_to_gray_u8, \
    to_float
from camkifu_tpu_torch.ops.edges import edge_map_batch, percentile
from camkifu_tpu_torch.ops.filters import edge_pad, sobel
from camkifu_tpu_torch.ops.hough import hough_accumulate, top_k, \
    topk_edge_points
from camkifu_tpu_torch.ops.lens import Lens, as_table, check_lens, \
    distort_pts, make_lens, undistort_frame, undistort_pts
from camkifu_tpu_torch.ops.warp import _inv3, _shifted_crop, \
    apply_homography, canonical_corners, homography_dlt, square, warp_frames
from camkifu_tpu_torch.ops.zones import median_u8
from camkifu_tpu_torch.utils.profiling import span

#: Rectification resolution for the grid-comb refinement.
REFINE_RES = 320

#: Clutter-defense component merge: keep connected dense components at
#: least this fraction of the largest one's size.
CLUTTER_COMP_KEEP = 0.30

#: Residual-rotation re-rectification threshold (radians).
DEROTATE_TRIP = float(np.deg2rad(0.7))

#: Minimum folded-orientation concentration for the rotation estimate to
#: be trusted (saturated boards read near-uniform orientations).
DEROTATE_MIN_CONC = 0.12

#: The least detection score that counts as a board found.
DETECT_MIN_SCORE = 0.1


def _f32(values, device) -> torch.Tensor:
    return torch.tensor(values, dtype=torch.float32, device=device)


def _at(x: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """``x[i]`` for a 0-d index tensor without waiting for the device:
    indexing with a 0-d tensor reads it on the host, a 1-element index
    tensor does not."""
    return x[i.reshape(1)][0]


def _angdiff(a, b):
    """Angular distance on the line-orientation circle (period π)."""
    d = torch.abs(a - b) % np.pi
    return torch.minimum(d, np.pi - d)


def _line_intersection(t1, r1, t2, r2):
    """Intersection of x·cosθ + y·sinθ = ρ pairs → (x, y)."""
    det = torch.cos(t1) * torch.sin(t2) - torch.sin(t1) * torch.cos(t2)
    det = torch.where(torch.abs(det) < 1e-9, 1e-9, det)
    x = (r1 * torch.sin(t2) - r2 * torch.sin(t1)) / det
    y = (r2 * torch.cos(t1) - r1 * torch.cos(t2)) / det
    return x, y


def _order_quad(pts_xy: torch.Tensor) -> torch.Tensor:
    """Order 4 points (..., 4, 2) tl/tr/br/bl (image y grows downward)."""
    ctr = pts_xy.mean(dim=-2, keepdim=True)
    ang = torch.atan2(pts_xy[..., 1] - ctr[..., 1],
                      pts_xy[..., 0] - ctr[..., 0])
    order = torch.argsort(ang, dim=-1, stable=True)
    ordered = torch.gather(pts_xy, -2, order[..., None].expand_as(pts_xy))
    roll = torch.argmin(ordered.sum(dim=-1), dim=-1, keepdim=True)
    ar = torch.arange(4, device=pts_xy.device)
    ordered = torch.gather(ordered, -2,
                           ((ar + roll) % 4)[..., None].expand_as(pts_xy))
    flipped = ordered[..., [0, 3, 2, 1], :]
    keep = (ordered[..., 1, 0] >= ordered[..., 3, 0])[..., None, None]
    return torch.where(keep, ordered, flipped)


def _box_blur(img: torch.Tensor, radius: int) -> torch.Tensor:
    """Separable box filter over the last two dims via cumulative sums
    (O(n), any radius)."""
    def along(a, dim):
        c = torch.cumsum(a, dim=dim)
        n = a.shape[dim]
        cp = edge_pad(c, radius + 1, radius, dim)
        # window sum = c[i+r] - c[i-r-1]
        hi = cp.narrow(dim, 2 * radius + 1, n)
        lo = cp.narrow(dim, 0, n)
        return (hi - lo) / (2 * radius + 1)
    return along(along(img, img.ndim - 2), img.ndim - 1)


@functools.lru_cache(maxsize=8)
def _resize_matrix(n_in: int, n_out: int, device) -> torch.Tensor:
    """(n_in, n_out) weights of ``jax.image.resize(method="bilinear")``
    along one axis: a triangle kernel widened by the downscale factor (it
    antialiases), normalized per output sample."""
    inv = np.float32(1.0 / (n_out / n_in))
    kscale = max(inv, np.float32(1.0))
    sample = (np.arange(n_out, dtype=np.float32) + np.float32(0.5)) * inv \
        - np.float32(0.5)
    x = np.abs(sample[None, :] - np.arange(n_in, dtype=np.float32)[:, None]) \
        / kscale
    w = np.maximum(np.float32(0.0), np.float32(1.0) - x)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps,
                 w / np.where(total != 0, total, 1), 0)
    w = np.where(((sample >= -0.5) & (sample <= n_in - 0.5))[None, :], w, 0)
    return torch.as_tensor(w.astype(np.float32), device=device)


def resize_bilinear(img: torch.Tensor,
                    out_hw: tuple[int, int]) -> torch.Tensor:
    """(..., H, W) float32 → (..., *out_hw), as ``jax.image.resize(img,
    out_hw, "bilinear")`` computes it: separable weight matrices, two
    matmuls (the same matrices for every leading index)."""
    h, w = img.shape[-2:]
    wh = _resize_matrix(h, out_hw[0], img.device)
    ww = _resize_matrix(w, out_hw[1], img.device)
    return wh.T @ img @ ww


def _coarse_from_mag(mag: torch.Tensor, mag_c: torch.Tensor | None):
    """The dense post-edge half of detection stage 1: edge maps (res, res)
    or (B, res, res) → (quad (4, 2) or (B, 4, 2), score () or (B,)); score
    < ~0.1 means "no board found".

    Every statistic is taken per frame, where the reference vmaps:
    percentiles, connected-component sizes (ids offset per frame), top-k
    corners and the score. Nothing in it waits for the device.
    """
    if mag.ndim == 2:
        quad, score = _coarse_from_mag(
            mag[None], None if mag_c is None else mag_c[None])
        return quad[0], score[0]
    b, res = mag.shape[0], mag.shape[-1]
    dev = mag.device
    if mag_c is not None:
        # Union in per-channel-normalized units (strided percentiles).
        def norm(m):
            ref = percentile(m[:, ::2, ::2].reshape(b, -1), 99.5, dim=1)
            return m / torch.clamp(ref, min=1e-6)[:, None, None]
        mag = torch.maximum(norm(mag), norm(mag_c))
    density = _box_blur((mag > 0).to(torch.float32), radius=7)
    mask = density > 0.06

    # Clutter defense: keep the largest connected dense component (and
    # any within CLUTTER_COMP_KEEP of it), found by max-pool label
    # propagation on the 2-px-eroded core at half resolution.
    core = _box_blur(mask.to(torch.float32), 2) > 0.999
    h2 = res // 2
    n_ids = h2 * h2 + 1
    core2 = core[:, :h2 * 2, :h2 * 2].reshape(b, h2, 2, h2, 2) \
        .all(dim=4).all(dim=2)
    idx0 = torch.arange(1, n_ids, dtype=torch.float32,
                        device=dev).reshape(h2, h2)
    # float32 ids are exact below 2**24; 0 pads the 5×5 window as the
    # reference's reduce_window init does (ids are ≥ 0). One max-pool
    # launch per step covers every frame.
    ids = torch.where(core2, idx0, 0.0)[:, None]
    for _ in range(2 * h2):
        ids = torch.where(core2[:, None],
                          F.max_pool2d(ids, 5, stride=1, padding=2), 0.0)
    ids = ids[:, 0].to(torch.int64).reshape(b, -1)
    # Component sizes per frame: ids offset by frame into one count
    # (a scatter-add, which unlike bincount does not wait for the device).
    off = ids + torch.arange(b, device=dev)[:, None] * n_ids
    sizes = torch.zeros(b * n_ids, dtype=torch.int64, device=dev) \
        .scatter_add_(0, off.reshape(-1), torch.ones_like(off.reshape(-1))) \
        .reshape(b, n_ids)
    sizes[:, 0] = 0
    best = sizes.amax(dim=1, keepdim=True)
    keep2 = (ids > 0) & (torch.gather(sizes, 1, ids)
                         >= CLUTTER_COMP_KEEP * best)
    keep2 = keep2.reshape(b, h2, h2)
    comp = keep2.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
    comp = F.pad(comp, (0, res - h2 * 2, 0, res - h2 * 2))
    comp = (_box_blur(comp.to(torch.float32), 3) > 1e-6) & mask
    flood_ok = 4 * keep2.sum(dim=(1, 2)) \
        > 0.25 * torch.clamp(mask.sum(dim=(1, 2)), min=1)
    mask = torch.where(flood_ok[:, None, None], comp, mask)

    ar = torch.arange(res, dtype=torch.float32, device=dev)
    ys = ar[:, None].expand(res, res)
    xs = ar[None, :].expand(res, res)
    xs_flat, ys_flat = xs.reshape(-1), ys.reshape(-1)
    mask_flat = mask.reshape(b, -1)

    def corner(proj, k=49):
        p = torch.where(mask_flat, proj.reshape(-1), float("-inf"))
        _, idx = top_k(p, k)                                   # (B, k)
        # 49 values: an odd count, so torch.median is jnp.median here.
        return torch.stack([torch.median(xs_flat[idx], dim=1).values,
                            torch.median(ys_flat[idx], dim=1).values], -1)

    quad = _order_quad(torch.stack([
        corner(-(xs + ys)),        # tl
        corner(xs - ys),           # tr
        corner(xs + ys),           # br
        corner(ys - xs),           # bl
    ], dim=1))                                                 # (B, 4, 2)

    # Score: edge density concentrated in the quad, times line structure.
    inside = torch.ones((b, res, res), dtype=torch.bool, device=dev)
    for i in range(4):
        p0 = quad[:, i, None, None, :]
        e = quad[:, (i + 1) % 4, None, None, :] - p0
        inside &= ((xs - p0[..., 0]) * e[..., 1]
                   - (ys - p0[..., 1]) * e[..., 0]) <= 0
    in_mean = torch.where(inside, density, 0.0).sum(dim=(1, 2)) \
        / torch.clamp(inside.sum(dim=(1, 2)), min=1)
    out_count = (~inside).sum(dim=(1, 2))
    out_mean = torch.where(~inside, density, 0.0).sum(dim=(1, 2)) \
        / torch.clamp(out_count, min=1)
    diff = torch.where(out_count > 0.05 * res * res, in_mean - out_mean,
                       in_mean)
    contrast = diff / torch.clamp(in_mean, min=1e-3)
    pts, wts = topk_edge_points(mag)                   # (B, K, 2), (B, K)
    acc = hough_accumulate(pts, wts, float(np.hypot(res, res)))
    peakedness = acc.amax(dim=(1, 2)) \
        / torch.clamp(acc.mean(dim=(1, 2)), min=1e-6)
    structure = torch.clamp((peakedness - 7.0) / 6.0, 0.0, 1.0)

    e1 = quad[:, 1] - quad[:, 0]
    e2 = quad[:, 3] - quad[:, 0]
    quad_area = torch.abs(e1[:, 0] * e2[:, 1] - e1[:, 1] * e2[:, 0])
    score = torch.clamp(contrast, 0.0, 1.0) * structure \
        * (quad_area > (0.15 * res) ** 2)
    return quad, score


def _coarse_quad(gray_small: torch.Tensor,
                 chroma_small: torch.Tensor | None = None):
    """Edge-density board-region quadrilateral on the detection-res gray
    (res, res) or grays (B, res, res) → (quad (4, 2) or (B, 4, 2) in
    detection-res coordinates, score () or (B,)); score < ~0.1 means "no
    board found".

    ``chroma_small`` (same shape, an R−B opponent channel) adds a second
    edge map, union-merged after per-channel normalization (dark woods
    can vanish in luma against the table and stay apart in chroma). Every
    map goes through one edge and one hysteresis launch on the card, and
    ``_coarse_from_mag`` through one Hough launch.
    """
    grays = gray_small[None] if gray_small.ndim == 2 else gray_small
    b = grays.shape[0]
    if chroma_small is None:
        quad, score = _coarse_from_mag(edge_map_batch(grays), None)
    else:
        mags = edge_map_batch(torch.cat([grays,
                                         chroma_small.reshape(grays.shape)]))
        quad, score = _coarse_from_mag(mags[:b], mags[b:])
    if gray_small.ndim == 2:
        return quad[0], score[0]
    return quad, score


def _col(v):
    """A per-frame value with a trailing axis to broadcast against a
    frame's teeth or bins; Python numbers pass through."""
    return v[..., None] if isinstance(v, torch.Tensor) else v


def _interp1d_hat(profile: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """Linear interpolation of a 1D profile at positions ``pos`` as a
    hat-weight contraction: Σ_b max(0, 1−|b−p|)·profile[b].

    profile (n,) takes ``pos`` of any shape; profiles (..., n) take ``pos``
    (..., *rest) with the same leading dims, each profile interpolated at
    its own positions (one batched product)."""
    n = profile.shape[-1]
    p = torch.clamp(pos, 0.0, n - 1.001)
    bins = torch.arange(n, dtype=torch.float32, device=profile.device)
    w = torch.clamp(1.0 - torch.abs(bins - p[..., None]), min=0.0)
    if profile.ndim == 1:
        return w @ profile
    w = w.reshape(*profile.shape[:-1], -1, n)
    return (w @ profile[..., None])[..., 0].reshape(p.shape)


@functools.lru_cache(maxsize=8)
def _comb_matrices(n: int, gsize: int, n_offsets: int, n_spacings: int,
                   device):
    """Comb-scoring operators on ``device``, built once in numpy: for every
    (offset, spacing) comb, the hat weights of its teeth and of its
    between-line gaps."""
    spacings = np.linspace(0.70 * n / gsize, 1.02 * n / (gsize - 1),
                           n_spacings, dtype=np.float32)
    offsets = np.linspace(0.0, 0.30 * n, n_offsets, dtype=np.float32)
    idx = np.arange(gsize, dtype=np.float32)                # teeth
    mid = np.arange(gsize - 1, dtype=np.float32) + 0.5      # between-line gaps
    pos = offsets[:, None, None] + spacings[None, :, None] * idx   # (O,S,g)
    gaps = offsets[:, None, None] + spacings[None, :, None] * mid
    valid = pos[..., -1] <= n - 1.0

    def interp_matrix(positions, teeth):
        flat = np.clip(positions.reshape(-1, teeth), 0.0, n - 1.001)
        bins = np.arange(n, dtype=np.float32)
        w = np.maximum(0.0, 1.0 - np.abs(bins - flat[..., None]))
        return w.mean(axis=1).astype(np.float32)            # (O·S, n)

    return tuple(torch.as_tensor(a, device=device) for a in (
        offsets, spacings, interp_matrix(pos, gsize),
        interp_matrix(gaps, gsize - 1), valid))


def _comb_scores(profile: torch.Tensor, gsize: int, n_offsets: int = 64,
                 n_spacings: int = 48):
    """(offsets (O,), spacings (S,), teeth_score (O, S), gap_score (O, S),
    valid (O, S)) of every comb on a 1D edge-energy profile."""
    offsets, spacings, a_teeth, a_gaps, valid = _comb_matrices(
        profile.shape[0], gsize, n_offsets, n_spacings, profile.device)
    teeth_score = (a_teeth @ profile).reshape(n_offsets, n_spacings)
    gap_score = (a_gaps @ profile).reshape(n_offsets, n_spacings)
    return offsets, spacings, teeth_score, gap_score, valid


def _comb_fit(profile: torch.Tensor, gsize: int, n_offsets: int = 64,
              n_spacings: int = 48, gap_weight: float = 0.0):
    """Fit a gsize-tooth even comb to a 1D edge-energy profile under one
    gap-weight scoring → (offset, spacing, gap-penalized quality), 0-d
    tensors; the quality is the common metric (teeth − gaps) of the
    chosen comb, whatever weight chose it."""
    offsets, spacings, teeth_score, gap_score, valid = _comb_scores(
        profile, gsize, n_offsets, n_spacings)
    scores = torch.where(valid, teeth_score - gap_weight * gap_score,
                         float("-inf"))
    flat = torch.argmax(scores)
    quality = _at((teeth_score - gap_score).reshape(-1), flat)
    return (_at(offsets, flat // n_spacings),
            _at(spacings, flat % n_spacings), quality)


def _snap_to_peaks(profile: torch.Tensor, teeth: torch.Tensor, pitch,
                   n_off: int):
    """Move each expected tooth position to its sub-pixel profile peak
    within ±pitch/3 → (snapped positions (g,), peak strengths (g,)).

    Profiles (..., n) take teeth (..., g) and a pitch that is a number or
    broadcasts against the leading dims."""
    offs = torch.linspace(-1.0, 1.0, n_off, device=profile.device) \
        * _col(pitch / 3.0)                                 # (..., n_off)
    win = _interp1d_hat(profile, teeth[..., :, None] + offs[..., None, :])
    best = torch.argmax(win, dim=-1, keepdim=True)          # (..., g, 1)
    bm1 = torch.gather(win, -1, torch.clamp(best - 1, 0, n_off - 1))[..., 0]
    bp1 = torch.gather(win, -1, torch.clamp(best + 1, 0, n_off - 1))[..., 0]
    b0 = torch.gather(win, -1, best)[..., 0]
    den = bm1 - 2 * b0 + bp1
    delta = torch.where(torch.abs(den) > 1e-9, 0.5 * (bm1 - bp1) / den, 0.0)
    step = (offs[..., 1] - offs[..., 0])[..., None]
    at_best = torch.gather(offs[..., None, :].expand(win.shape), -1,
                           best)[..., 0]
    snapped = teeth + at_best + torch.clamp(delta, -1.0, 1.0) * step
    return snapped, b0


def _snap_teeth(profile: torch.Tensor, o, s, gsize: int):
    """Snap each tooth to its profile peak, then weighted-LS refit (o, s)."""
    idx = torch.arange(gsize, dtype=torch.float32, device=profile.device)
    snapped, b0 = _snap_to_peaks(profile, o + s * idx, s, n_off=21)
    w = torch.clamp(b0, min=1e-6)
    sw = w.sum()
    mi = (w * idx).sum() / sw
    mp = (w * snapped).sum() / sw
    var = (w * (idx - mi) ** 2).sum()
    s2 = (w * (idx - mi) * (snapped - mp)).sum() / torch.clamp(var, min=1e-9)
    o2 = mp - s2 * mi
    # Keep the comb fit if the refit drifted implausibly.
    ok = (torch.abs(s2 - s) < 0.2 * s) & (torch.abs(o2 - o) < 0.5 * s)
    return torch.where(ok, o2, o), torch.where(ok, s2, s)


def _snap_quadratic(profile: torch.Tensor, o, s, gsize: int):
    """Snap each tooth to its profile peak, weighted-LS fit a + b·i + c·i²
    (one IRLS pass), and return the fitted OUTER line positions, or the
    comb's where the fit is implausible."""
    idx = torch.arange(gsize, dtype=torch.float32, device=profile.device)
    snapped, b0 = _snap_to_peaks(profile, o + s * idx, s, n_off=21)

    w = torch.clamp(b0, min=1e-6)
    ic = idx - (gsize - 1) / 2.0                # centered → conditioned 3×3
    X = torch.stack([torch.ones_like(ic), ic, ic * ic], dim=-1)   # (g, 3)

    def wls(weights):
        A = (X * weights[:, None]).T @ X
        rhs = (X * weights[:, None]).T @ snapped
        return torch.linalg.solve_ex(A, rhs).result

    beta = wls(w)
    resid = snapped - X @ beta
    w2 = w / (1.0 + (resid / (0.12 * s)) ** 2)
    beta = wls(w2)
    r2 = snapped - X @ beta
    rms = torch.sqrt((w2 * r2 * r2).sum() / torch.clamp(w2.sum(), min=1e-6))
    fit_ok = rms < 0.15 * s
    e = (gsize - 1) / 2.0
    lo = beta[0] - beta[1] * e + beta[2] * e * e
    hi = beta[0] + beta[1] * e + beta[2] * e * e
    bow_ok = torch.abs(beta[2]) * e * e < 0.35 * s
    lo_ok = torch.abs(lo - o) < 0.5 * s
    hi_ok = torch.abs(hi - (o + s * (gsize - 1))) < 0.5 * s
    ok = bow_ok & lo_ok & hi_ok & fit_ok
    return (torch.where(ok, lo, o),
            torch.where(ok, hi, o + s * (gsize - 1)))


def _pin_corners(gray: torch.Tensor, quad: torch.Tensor, gsize: int,
                 res: int = REFINE_RES):
    """Final sub-pixel corner pin on a fresh rectification by ``quad``."""
    H = _rect_H(quad, 0.10, res)
    rect = _sample_rect(gray, H, res)
    return _pin_corners_on_rect(rect, H, quad, gsize)


def _pin_corners_on_rect(rect: torch.Tensor, H: torch.Tensor,
                         quad: torch.Tensor, gsize: int):
    """The pin measured on a rectified canvas: each axis's outer lines are
    snapped per half (quadratic pitch-drift fit) and linearly extrapolated
    to the outer-line heights, then mapped back through ``H``."""
    res = rect.shape[0]
    _, _, ct, cb, rl, rr = _split_profiles(rect, gsize)
    rc = apply_homography(_inv3(H), quad)
    ox = 0.5 * (rc[0, 0] + rc[3, 0])
    xh = 0.5 * (rc[1, 0] + rc[2, 0])
    oy = 0.5 * (rc[0, 1] + rc[1, 1])
    yh = 0.5 * (rc[2, 1] + rc[3, 1])
    sx = (xh - ox) / (gsize - 1)
    sy = (yh - oy) / (gsize - 1)
    x0t, x1t = _snap_quadratic(ct, ox, sx, gsize)     # top-half rows
    x0b, x1b = _snap_quadratic(cb, ox, sx, gsize)     # bottom-half rows
    y0l, y1l = _snap_quadratic(rl, oy, sy, gsize)     # left-half cols
    y0r, y1r = _snap_quadratic(rr, oy, sy, gsize)     # right-half cols

    h1, h2 = 0.3125 * res, 0.6875 * res
    span = h2 - h1
    y_top = 0.5 * (y0l + y0r)
    y_bot = 0.5 * (y1l + y1r)
    x_left = 0.5 * (x0t + x0b)
    x_right = 0.5 * (x1t + x1b)

    def at(v1, v2, pos):                  # linear extrapolation in h
        return v1 + (pos - h1) * (v2 - v1) / span

    def guard(v1, v2, pitch):             # halves disagreeing: drop shear
        bad = torch.abs(v2 - v1) > 0.5 * pitch
        m = 0.5 * (v1 + v2)
        return torch.where(bad, m, v1), torch.where(bad, m, v2)

    x0t, x0b = guard(x0t, x0b, sx)
    x1t, x1b = guard(x1t, x1b, sx)
    y0l, y0r = guard(y0l, y0r, sy)
    y1l, y1r = guard(y1l, y1r, sy)

    rc2 = torch.stack([
        torch.stack([at(x0t, x0b, y_top), at(y0l, y0r, x_left)]),     # tl
        torch.stack([at(x1t, x1b, y_top), at(y0l, y0r, x_right)]),    # tr
        torch.stack([at(x1t, x1b, y_bot), at(y1l, y1r, x_right)]),    # br
        torch.stack([at(x0t, x0b, y_bot), at(y1l, y1r, x_left)]),     # bl
    ])
    return apply_homography(H, rc2)


def _comb_quality(profile: torch.Tensor, o, s, gsize: int):
    """Gap-penalized comb score at exactly (o, s); combs running off the
    profile window are disqualified. Profiles (..., n) take an offset
    tensor ``o`` (...,) and a spacing that is a number or (...,)."""
    n = profile.shape[-1]
    idx = torch.arange(gsize, dtype=torch.float32, device=profile.device)
    mid = idx[:-1] + 0.5
    q = _interp1d_hat(profile, _col(o) + _col(s) * idx).mean(dim=-1) \
        - _interp1d_hat(profile, _col(o) + _col(s) * mid).mean(dim=-1)
    out = (o < 0.0) | (o + s * (gsize - 1) > n - 1.0)
    return q - 10.0 * out


def _rect_profiles(gray: torch.Tensor, quad: torch.Tensor, gsize: int,
                   margin: float = 0.08, res: int = REFINE_RES):
    """Rectify by ``quad`` (+outward margin) → (H, col_profile,
    row_profile)."""
    H, col_profile, row_profile, _ = _rect_profiles_rect(gray, quad, gsize,
                                                         margin, res)
    return H, col_profile, row_profile


def _rect_profiles_rect(gray: torch.Tensor, quad: torch.Tensor, gsize: int,
                        margin: float = 0.08, res: int = REFINE_RES):
    """``_rect_profiles`` that also returns the rectified image."""
    H = _rect_H(quad, margin, res)
    rect = _sample_rect(gray, H, res)
    col_profile, row_profile = _profiles_of(rect, gsize)
    return H, col_profile, row_profile, rect


def _rect_H(quad: torch.Tensor, margin: float, res: int) -> torch.Tensor:
    """Homography rect → frame for the quad expanded outward by
    ``margin``."""
    ctr = quad.mean(dim=0)
    equad = ctr + (quad - ctr) * (1.0 + margin)
    return homography_dlt(square(0.0, res - 1.0, quad.device), equad)


def _sample_rect(gray: torch.Tensor, H: torch.Tensor, res: int,
                 lens: Lens | None = None) -> torch.Tensor:
    """Rectify the (H, W) gray frame through ``H`` → (res, res) float32,
    in [0, 1] for uint8 gray. Runs the warp kernel on the card. With
    ``lens``, H maps the rect to PINHOLE frame coordinates (built on
    undistorted corners) and the sample grid bends back through the
    lens."""
    scale = 1.0 / 255.0 if gray.dtype == torch.uint8 else 1.0
    rect = warp_frames(gray[None, :, :, None], H, (res, res), scale, lens)
    return rect[0, :, :, 0]


def _prep_profile(profile: torch.Tensor, gsize: int) -> torch.Tensor:
    """Condition raw 1D energy profiles (..., n), each on its own, into
    normalized lattice signals: clip spikes at the 90th percentile,
    high-pass at the cell scale, max-normalize."""
    p = torch.minimum(profile, percentile(profile, 90, dim=-1)[..., None])
    n = p.shape[-1]
    r = max(2, n // (2 * gsize))
    c = torch.cumsum(edge_pad(p, r + 1, r, -1), dim=-1)
    local_mean = (c[..., 2 * r + 1:] - c[..., :n]) / (2 * r + 1)
    p = torch.clamp(p - local_mean, min=0.0)
    return p / torch.clamp(p.amax(dim=-1, keepdim=True), min=1e-6)


def _wood_deviation(rect: torch.Tensor) -> torch.Tensor:
    """|rect − wood level| of images (..., res, res), the wood level being
    each image's radix-select median of a 4×-subsampled view."""
    sub = rect[..., ::4, ::4]
    wood = median_u8(sub.reshape(*rect.shape[:-2], -1))
    return torch.abs(rect - wood[..., None, None])


def _profiles_of(rect: torch.Tensor, gsize: int):
    """Rectified board image → (col_profile, row_profile) lattice signals:
    gradient energy plus luma deviation from the wood level."""
    res = rect.shape[0]
    gx, gy = sobel(rect)
    i0, i1 = res // 8, res - res // 8
    dev = _wood_deviation(rect)
    col_profile = _prep_profile(torch.abs(gx)[i0:i1, :].mean(dim=0), gsize) \
        + _prep_profile(dev[i0:i1, :].mean(dim=0), gsize)
    row_profile = _prep_profile(torch.abs(gy)[:, i0:i1].mean(dim=1), gsize) \
        + _prep_profile(dev[:, i0:i1].mean(dim=1), gsize)
    return col_profile, row_profile


def _split_profiles(rect: torch.Tensor, gsize: int):
    """Full + half-split lattice profiles of a rectified image (res, res):
    (col_full, row_full, col_top, col_bot, row_left, row_right), each
    (res,). Images (..., res, res) give profiles (..., res): the whole
    batch's twelve raw profiles are conditioned in one pass."""
    res = rect.shape[-1]
    gx, gy = sobel(rect)
    i0, i1, mid = res // 8, res - res // 8, res // 2
    dev = _wood_deviation(rect)
    agx, agy = torch.abs(gx), torch.abs(gy)

    def colp(a, b):
        return [agx[..., a:b, :].mean(dim=-2), dev[..., a:b, :].mean(dim=-2)]

    def rowp(a, b):
        return [agy[..., :, a:b].mean(dim=-1), dev[..., :, a:b].mean(dim=-1)]

    raw = torch.stack(colp(i0, i1) + rowp(i0, i1) + colp(i0, mid)
                      + colp(mid, i1) + rowp(i0, mid) + rowp(mid, i1))
    p = _prep_profile(raw, gsize)                         # (12, ..., res)
    return tuple(p[0::2] + p[1::2])


def _comb_variants(H: torch.Tensor, col_profile: torch.Tensor,
                   row_profile: torch.Tensor, ox, sx, oy, sy, gsize: int):
    """The comb (ox, sx) × (oy, sy) translated by {−1, 0, +1} teeth along
    each axis → (corners (9, 4, 2) in frame coordinates through ``H``,
    gap-penalized qualities (9,)); the (0, 0) comb is index 4. The comb's
    basins are one tooth apart and no in-basin score tells "19 teeth on
    the grid" from "18 and one on the slab edge", so callers race all
    nine."""
    span = gsize - 1.0
    shifts = (-1.0, 0.0, 1.0)
    qxs = [_comb_quality(col_profile, ox + d * sx, sx, gsize) for d in shifts]
    qys = [_comb_quality(row_profile, oy + d * sy, sy, gsize) for d in shifts]
    var_corners, var_q = [], []
    for i, dx in enumerate(shifts):
        for j, dy in enumerate(shifts):
            x0, y0 = ox + dx * sx, oy + dy * sy
            x1, y1 = x0 + span * sx, y0 + span * sy
            rc = torch.stack([torch.stack([x0, y0]), torch.stack([x1, y0]),
                              torch.stack([x1, y1]), torch.stack([x0, y1])])
            var_corners.append(apply_homography(H, rc))
            var_q.append(qxs[i] + qys[j])
    return torch.stack(var_corners), torch.stack(var_q)


def _fit_combs(H: torch.Tensor, col_profile: torch.Tensor,
               row_profile: torch.Tensor, gsize: int, gap_weight: float):
    """Comb-fit both axes on precomputed profiles under one gap weight →
    (corners (4, 2) in frame coordinates, comb quality, variant corners
    (9, 4, 2), variant qualities (9,)) (``_comb_variants``)."""
    ox, sx, qx = _comb_fit(col_profile, gsize, gap_weight=gap_weight)
    oy, sy, qy = _comb_fit(row_profile, gsize, gap_weight=gap_weight)
    ox, sx = _snap_teeth(col_profile, ox, sx, gsize)
    oy, sy = _snap_teeth(row_profile, oy, sy, gsize)
    var_corners, var_q = _comb_variants(H, col_profile, row_profile, ox, sx,
                                        oy, sy, gsize)
    return var_corners[4], qx + qy, var_corners, var_q


def _refine_grid(gray: torch.Tensor, quad: torch.Tensor, gsize: int,
                 margin: float = 0.08, res: int = REFINE_RES,
                 gap_weight: float = 1.0):
    """Rectify by ``quad`` (+outward margin) and comb-fit the grid lines:
    ``_rect_profiles`` followed by ``_fit_combs``."""
    H, col_profile, row_profile = _rect_profiles(gray, quad, gsize, margin,
                                                 res)
    return _fit_combs(H, col_profile, row_profile, gsize, gap_weight)


def _fit_combs_multi(H: torch.Tensor, col_profile: torch.Tensor,
                     row_profile: torch.Tensor, gsize: int,
                     gap_weights=(1.0, 0.0)):
    """Comb-fit both axes under several gap-weight scorings in one pass →
    (seeds (G, 4, 2), variant corners (G*9, 4, 2), variant qualities
    (G*9,)); the 9 variants per scoring are ``_comb_variants``."""
    grid_x = _comb_scores(col_profile, gsize)
    grid_y = _comb_scores(row_profile, gsize)
    seeds, var_corners, var_q = [], [], []
    for gw in gap_weights:
        def pick(grid):
            offsets, spacings, teeth, gap, valid = grid
            scores = torch.where(valid, teeth - gw * gap, float("-inf"))
            flat = torch.argmax(scores)
            n_sp = spacings.shape[0]
            return _at(offsets, flat // n_sp), _at(spacings, flat % n_sp)
        ox, sx = pick(grid_x)
        oy, sy = pick(grid_y)
        ox, sx = _snap_teeth(col_profile, ox, sx, gsize)
        oy, sy = _snap_teeth(row_profile, oy, sy, gsize)
        vc, vq = _comb_variants(H, col_profile, row_profile, ox, sx, oy, sy,
                                gsize)
        seeds.append(vc[4])                    # this scoring's (0, 0) comb
        var_corners.append(vc)
        var_q.append(vq)
    return torch.stack(seeds), torch.cat(var_corners), torch.cat(var_q)


def _side_insets(corners: torch.Tensor, slab: torch.Tensor) -> torch.Tensor:
    """Inward distance from candidate quads (..., 4, 2) to each side of the
    slab → (..., 4): top, right, bottom, left."""
    dists = []
    for i in range(4):
        p0 = slab[i]
        e = slab[(i + 1) % 4] - p0
        n = torch.stack([-e[1], e[0]])
        n = n / torch.clamp(torch.linalg.vector_norm(n), min=1e-6)
        dists.append(((corners - p0) @ n).min(dim=-1).values)
    return torch.stack(dists, dim=-1)


def _slab_inset(corners: torch.Tensor, slab: torch.Tensor) -> torch.Tensor:
    """Smallest inward distance (px) from any candidate corner to the slab
    boundary (...,); negative = a corner lies outside the slab."""
    return _side_insets(corners, slab).min(dim=-1).values


def _evidence_map(rect: torch.Tensor, gsize: int) -> torch.Tensor:
    """2D lattice-evidence map: center-surround of the wood deviation and
    of the gradient energy, each rectified and max-normalized."""
    res = rect.shape[0]
    dev = _wood_deviation(rect)
    gx, gy = sobel(rect)
    edge = torch.abs(gx) + torch.abs(gy)
    s_cell = res / (gsize + 1.0)
    r_in = max(1, int(s_cell * 0.18))
    r_out = max(r_in + 2, int(s_cell * 0.6))
    cs_dev = _box_blur(dev, r_in) - _box_blur(dev, r_out)
    cs_edge = _box_blur(edge, r_in) - _box_blur(edge, r_out)
    return (torch.clamp(cs_dev, min=0.0)
            / torch.clamp(torch.abs(cs_dev).max(), min=1e-9)
            + torch.clamp(cs_edge, min=0.0)
            / torch.clamp(torch.abs(cs_edge).max(), min=1e-9))


def _lattice_evidence(E: torch.Tensor, Hinv: torch.Tensor,
                      cands: torch.Tensor, gsize: int) -> torch.Tensor:
    """Mean evidence at each candidate's gsize² intersections, measured in
    the seed rect. cands: (N, 4, 2) frame px; Hinv maps frame → rect."""
    return _lattice_evidence_rc(E, apply_homography(Hinv, cands), gsize)


def _lattice_evidence_rc(E: torch.Tensor, rc: torch.Tensor,
                         gsize: int) -> torch.Tensor:
    """``_lattice_evidence`` for quads already in rect coords (N, 4, 2);
    interior points are projective (per-candidate DLT)."""
    iu = torch.arange(gsize, dtype=torch.float32, device=E.device) \
        / (gsize - 1.0)
    gv, gu = torch.meshgrid(iu, iu, indexing="ij")
    grid = torch.stack([gu, gv], dim=-1).reshape(-1, 2)     # (G², 2)
    return _grid_evidence_rc(E, rc, grid)


def _grid_evidence_rc(E: torch.Tensor, rc: torch.Tensor,
                      grid: torch.Tensor) -> torch.Tensor:
    """Mean bilinear evidence at unit-square points projected through each
    candidate quad's DLT → (N,); a degenerate quad scores −1."""
    res = E.shape[0]
    unit = _f32([[0.0, 0.0], [1.0, 0.0], [1.0, 1.0], [0.0, 1.0]], E.device)
    P = apply_homography(homography_dlt(unit, rc), grid)    # (N, M, 2)
    px = torch.clamp(P[..., 0], 0.0, res - 1.001)
    py = torch.clamp(P[..., 1], 0.0, res - 1.001)
    x0f, y0f = torch.floor(px), torch.floor(py)
    fx, fy = px - x0f, py - y0f
    # A NaN point (singular DLT) indexes pixel 0 and keeps its NaN weight,
    # so its candidate's mean stays NaN and scores −1 below.
    x0 = torch.nan_to_num(x0f, nan=0.0).long()
    y0 = torch.nan_to_num(y0f, nan=0.0).long()
    val = (E[y0, x0] * (1 - fx) * (1 - fy)
           + E[y0, x0 + 1] * fx * (1 - fy)
           + E[y0 + 1, x0] * (1 - fx) * fy
           + E[y0 + 1, x0 + 1] * fx * fy)
    ev = val.mean(dim=1)
    return torch.where(torch.isfinite(ev), ev, -1.0)


def _evidence_polish(E: torch.Tensor, H: torch.Tensor, Hinv: torch.Tensor,
                     w: torch.Tensor, gsize: int,
                     spans=(0.45, 0.30, 0.15, 0.06), k: int = 5):
    """Corner-wise coordinate descent on the 2D evidence map, each corner
    over a shrinking k×k search grid (spans in cells of the seed rect)."""
    rc = apply_homography(Hinv, w)                          # (4, 2) rect px
    cell = torch.linalg.vector_norm(rc[1] - rc[0]) / (gsize - 1.0)
    for span in spans:
        offs = torch.linspace(-span, span, k, device=E.device) * cell
        oi, oj = torch.meshgrid(offs, offs, indexing="ij")
        dxy = torch.stack([oi, oj], dim=-1).reshape(-1, 2)  # (k*k, 2)
        for i in range(4):
            cands = rc.expand(k * k, 4, 2).clone()
            cands[:, i] += dxy
            ev = _lattice_evidence_rc(E, cands, gsize)
            rc = _at(cands, torch.argmax(ev))
    return apply_homography(H, rc)


def _rank_evidence(cands: torch.Tensor, E: torch.Tensor, Hinv: torch.Tensor,
                   quad: torch.Tensor, cell, gsize: int) -> torch.Tensor:
    """Cross-basin candidate ranking: 2D lattice evidence plus soft priors
    on the slab inset and on margin symmetry (in the seed rect frame)."""
    ev = _lattice_evidence(E, Hinv, cands, gsize)
    insets = _slab_inset(cands, quad)
    rc = apply_homography(Hinv, cands)                        # (N, 4, 2)
    rslab = apply_homography(Hinv, quad)                      # (4, 2)
    side = _side_insets(rc, rslab)                            # (N, 4)
    rcell = torch.linalg.vector_norm(rc[:, 1] - rc[:, 0], dim=1) \
        / (gsize - 1.0)
    asym = (torch.abs(side[:, 0] - side[:, 2])
            + torch.abs(side[:, 1] - side[:, 3])) \
        / torch.clamp(rcell, min=1e-3)                        # in cells
    return ev + torch.clamp(insets / cell - 0.25, max=0.0) \
        - 0.8 * torch.square(torch.clamp(asym - 0.6, min=0.0))


def _resid_rotation(rect: torch.Tensor):
    """In-plane rotation of the rectified lattice vs the canvas axes →
    (angle_rad, concentration): energy-weighted circular mean of the
    gradient orientation folded mod 90°."""
    gx = (rect[:, 2:] - rect[:, :-2])[1:-1, :]
    gy = (rect[2:, :] - rect[:-2, :])[:, 1:-1]
    m2 = gx * gx + gy * gy
    w = torch.minimum(m2, percentile(m2[::2, ::2], 99.0))
    phi4 = 4.0 * torch.atan2(gy, gx)
    s = (w * torch.sin(phi4)).sum()
    c = (w * torch.cos(phi4)).sum()
    conc = torch.sqrt(s * s + c * c) / torch.clamp(w.sum(), min=1e-9)
    return torch.atan2(s, c) / 4.0, conc


def _detect_prepare(frame: torch.Tensor, res: int):
    """Detection stage 1: (H, W, 3) frame → (gray u8 (H, W), coarse quad
    (4, 2) frame px, score): ``_detect_prepare_batch`` of one frame."""
    grays, quads, scores = _detect_prepare_batch(frame[None], res)
    return grays[0], quads[0], scores[0]


def _detect_prepare_batch(frames: torch.Tensor, res: int):
    """Batched detection stage 1: (B, H, W, 3) → (grays u8 (B, H, W),
    quads (B, 4, 2) frame px, scores (B,)).

    Luma and chroma of the whole batch are resized by the same weight
    matrices, and ``_coarse_quad`` takes every frame at once: its 2B edge
    maps are one edge-kernel launch on the card, and one Hough launch
    follows.
    """
    h, w = frames.shape[1], frames.shape[2]
    grays = rgb_to_gray_u8(frames)
    fscale = 1.0 / 255.0 if frames.dtype == torch.uint8 else 1.0
    smalls = resize_bilinear(grays.to(torch.float32) / 255.0, (res, res))
    chromas = resize_bilinear(
        (frames[..., 0].to(torch.float32) - frames[..., 2].to(torch.float32))
        * fscale, (res, res))
    quads, scores = _coarse_quad(smalls, chromas)
    scale = _f32([(w - 1) / (res - 1), (h - 1) / (res - 1)], frames.device)
    return grays, quads * scale, scores


def _detect_refine(gray: torch.Tensor, quad: torch.Tensor, score,
                   gsize: int, refine_iters: int = 1):
    """Detection stages 2–3: comb refinement race + 2D-evidence
    disambiguation + the sub-pixel outer-line pin (line-dominated boards,
    score > 0.55), or seeded comb races + evidence polish (saturated
    boards). The two branch tests read a device scalar on the host."""
    gap_weights = (1.0, 0.0)
    H, colp, rowp, rect = _rect_profiles_rect(gray, quad, gsize, margin=0.10)

    # De-rotation: rotate the rect canvas by 2/3 of the measured residual
    # rotation through the homography and re-rectify once.
    raw_delta, conc = _resid_rotation(rect)
    delta = raw_delta * (2.0 / 3.0)
    if bool((torch.abs(delta) > DEROTATE_TRIP) & (conc > DEROTATE_MIN_CONC)):
        rres = rect.shape[0]
        unit = _f32([[0.0, 0.0], [rres - 1.0, 0.0], [rres - 1.0, rres - 1.0],
                     [0.0, rres - 1.0]], gray.device)
        cc = (rres - 1.0) / 2.0
        cd, sd = torch.cos(delta), torch.sin(delta)
        rotm = torch.stack([torch.stack([cd, -sd]), torch.stack([sd, cd])])
        runit = cc + (unit - cc) @ rotm.T
        equad2 = apply_homography(H, runit)
        ctr2 = equad2.mean(dim=0)
        quad = (ctr2 + (equad2 - ctr2) / 1.10).to(torch.float32)
        H, colp, rowp, rect = _rect_profiles_rect(gray, quad, gsize,
                                                  margin=0.10)

    cell = torch.linalg.vector_norm(quad[1] - quad[0]) / (gsize + 0.0)
    _, vc1, _ = _fit_combs_multi(H, colp, rowp, gsize, gap_weights)
    E = _evidence_map(rect, gsize)
    Hinv = torch.linalg.inv_ex(H).inverse
    rank1 = _rank_evidence(vc1, E, Hinv, quad, cell, gsize)
    w1 = _at(vc1, torch.argmax(rank1))
    pin1 = _pin_corners(gray, w1, gsize)
    if bool(score > 0.55):                            # line-dominated
        return pin1.to(torch.float32)

    cands, ranks, w = vc1, rank1, w1
    for _ in range(max(refine_iters, 1)):
        H2, c2, r2 = _rect_profiles(gray, w, gsize, margin=0.10)
        _, vc2, _ = _fit_combs_multi(H2, c2, r2, gsize, gap_weights)
        cands = torch.cat([cands, vc2])
        ranks = torch.cat(
            [ranks, _rank_evidence(vc2, E, Hinv, quad, cell, gsize)])
        w = _at(cands, torch.argmax(ranks))
    pins = torch.stack([pin1, _pin_corners(gray, w, gsize)])
    cands = torch.cat([cands, pins])
    ranks = torch.cat(
        [ranks, _rank_evidence(pins, E, Hinv, quad, cell, gsize)])
    # Two evidence-ascent polish → re-rank rounds of the running winner.
    for _ in range(2):
        w3 = _at(cands, torch.argmax(ranks))
        pol = _evidence_polish(E, H, Hinv, w3, gsize)[None]
        cands = torch.cat([cands, pol])
        ranks = torch.cat(
            [ranks, _rank_evidence(pol, E, Hinv, quad, cell, gsize)])
    return _at(cands, torch.argmax(ranks)).to(torch.float32)


def detect_corners(frame: torch.Tensor, res: int = cvconf.bf_resolution,
                   gsize: int = 19, refine_iters: int = 1):
    """One frame (H, W, 3) uint8/float → (corners (4, 2) float32, score).

    Corners are the outer grid intersections, tl/tr/br/bl, in frame pixels.
    score < ~0.1 means "no board found" (callers keep the previous
    estimate). ``refine_iters`` counts the extra seeded comb races of the
    stone-saturated branch (score ≤ 0.55).
    """
    gray, quad, score = _detect_prepare(frame, res)
    corners = _detect_refine(gray, quad, score, gsize, refine_iters)
    return corners, score


def _gsize_probe(frame: torch.Tensor, res: int = cvconf.bf_resolution,
                 gsize: int = 19):
    """Full detection at a candidate gsize, scored by a PITCH-SENSITIVE
    quality: the winner's per-axis lattice-profile energy at its gsize
    tooth positions MINUS the energy at its between-teeth midpoints →
    (corners (4, 2), score, quality).

    A denser impostor's teeth fall mostly between the profile's peaks, and
    a sparser one's midpoints land on the lines it skipped, so only the
    true pitch scores peak minus wood. Profiles are per-axis max-normalized
    (``_prep_profile``), so sizes compare directly.
    """
    gray, quad, score = _detect_prepare(frame, res)
    return _gsize_quality(gray, quad, score, gsize)


def _gsize_quality(gray: torch.Tensor, quad: torch.Tensor, score,
                   gsize: int):
    """Stages 2–3 of ``_gsize_probe`` on a stage-1 result, and the
    quality of the corners they find."""
    corners = _detect_refine(gray, quad, score, gsize, 1)
    H, col_profile, row_profile, _ = _rect_profiles_rect(gray, corners,
                                                         gsize)
    n = col_profile.shape[0]
    dev = gray.device
    # Tooth positions from the corners' ACTUAL rect coordinates (the margin
    # expansion happens in frame space, so the inset is only approximately
    # static under perspective).
    rc = apply_homography(_inv3(H), corners)                 # (4, 2)
    idx = torch.arange(gsize, dtype=torch.float32, device=dev) \
        / (gsize - 1.0)
    midx = (torch.arange(gsize - 1, dtype=torch.float32, device=dev)
            + 0.5) / (gsize - 1.0)

    def taps(profile, pos):
        pos = torch.clamp(pos, 0.0, n - 1.001)
        i0f = torch.floor(pos)
        w = pos - i0f
        # A NaN position (singular corners) reads bin 0 with a NaN weight:
        # the quality is NaN and the probe fails, as in the reference.
        i0 = torch.nan_to_num(i0f, nan=0.0).long()
        return profile[i0] * (1 - w) + profile[i0 + 1] * w

    q = torch.zeros((), dtype=torch.float32, device=dev)
    for profile, a0, a1 in ((col_profile, (rc[0, 0] + rc[3, 0]) * 0.5,
                             (rc[1, 0] + rc[2, 0]) * 0.5),
                            (row_profile, (rc[0, 1] + rc[1, 1]) * 0.5,
                             (rc[3, 1] + rc[2, 1]) * 0.5)):
        teeth = a0 + (a1 - a0) * idx
        mids = a0 + (a1 - a0) * midx
        # ±2 px tolerance on teeth (profile peaks are 1–2 px wide); the
        # midpoints get a plain tap (a sparse impostor's sit ON lines).
        tooth_e = torch.stack([taps(profile, teeth + d) for d in
                               (-2.0, -1.0, 0.0, 1.0, 2.0)]).amax(dim=0)
        q = q + tooth_e.mean() - taps(profile, mids).mean()
    return corners, score, 0.5 * q


def infer_gsize(frame: torch.Tensor, candidates: tuple[int, ...] = (9, 13, 19),
                res: int = cvconf.bf_resolution) -> tuple[int, dict]:
    """Infer the board size from one frame (``--gsize auto``).

    Runs detection once per candidate size and compares each winner's
    pitch-sensitive lattice quality (``_gsize_probe``). Stage 1 does not
    depend on the size, so it runs once; each candidate refines on its
    result, and the numbers are those of separate probes. Reads each
    candidate's score and quality on the host.

    Returns (gsize, qualities): qualities maps each candidate to its
    quality (−1.0 where detection failed: score < 0.1 or a non-finite
    quality); gsize is 0 when no candidate found a board at all — callers
    choose their own default.
    """
    gray, quad, score = _detect_prepare(frame, res)
    quals: dict[int, float] = {}
    for g in candidates:
        _, sc, q = _gsize_quality(gray, quad, score, int(g))
        sc, q = float(sc), float(q)
        quals[int(g)] = q if sc >= DETECT_MIN_SCORE and np.isfinite(q) \
            else -1.0
    best = max(quals, key=lambda g: quals[g])
    return (best if quals[best] > 0.0 else 0), quals


# ---------------------------------------------------------------------------
# Lens (radial distortion) calibration, anchor time only: each probe reads
# one number on the host, as the reference's sweep reads each quality.
# ---------------------------------------------------------------------------

#: Coarse calibration grid (barrel-skewed: webcams are barrel far more
#: often than pincushion, and strong pincushion folds at the frame edge).
#: Detection is fine below |k1| ≈ 0.015 and unrecoverable past ~0.15.
K1_CAL_GRID = (-0.09, -0.06, -0.035, -0.015, 0.0,
               0.015, 0.035, 0.06, 0.09, 0.13)

#: Minimum lattice-evidence gain over the pinhole (k1 = 0) run before a
#: non-zero k1 is adopted: on pinhole footage the argmax over the grid is
#: sampling noise (≤ 7% gain on straight renders; a real lens gains 17% at
#: k1 = 0.02 and 35%+ from 0.04 up), and a phantom lens would bend every
#: warp.
K1_CAL_MARGIN = 1.10


def _line_evidence(rect: torch.Tensor) -> torch.Tensor:
    """LINE-scale lattice evidence of a rectified board (res, res): the
    center-surround (radii 1 and 5 px) of the Sobel energy, clipped at 0
    and max-normalized. It is made for grid lines 1–2 rect px wide, whose
    residual bow at Δk1 = 0.015 (~3 px mid-edge) hides inside the
    blob-scale evidence's plateau; a line of 2 px or more reads as two
    edge ridges with a trough on the line itself."""
    gx, gy = sobel(rect)
    edge = torch.abs(gx) + torch.abs(gy)
    cs = _box_blur(edge, 1) - _box_blur(edge, 5)
    return torch.clamp(cs, min=0.0) / torch.clamp(torch.abs(cs).max(),
                                                  min=1e-9)


def _detect_k1_probe(frame: torch.Tensor, k1: float, res: int = 512,
                     gsize: int = 19):
    """Full detection on the frame undistorted at ``k1``, and a
    lattice-evidence quality of the result → (corners (4, 2) raw frame
    positions, score, quality).

    The frame is resampled to pinhole geometry first (``undistort_frame``,
    one full-frame gather: calibration runs once a session) and the
    straight-line detector runs unchanged at res 512 (at 256 the coarse
    quad's own noise moves the objective by more than a 0.015 k1 step).
    Quality = mean line-scale evidence at the detected quad's gsize²
    intersections: with a wrong k1 the interior lines stay bowed and the
    evidence drops."""
    lens = make_lens(k1, (frame.shape[0], frame.shape[1]))
    pin = undistort_frame(frame, lens)
    gray, quad, score = _detect_prepare(pin, res)
    corners = _detect_refine(gray, quad, score, gsize, 1)
    H, _, _, rect = _rect_profiles_rect(gray, corners, gsize)
    q = _lattice_evidence(_line_evidence(rect), _inv3(H), corners[None],
                          gsize)[0]
    return distort_pts(lens, corners), score, q


def _undistort_batch(frames: torch.Tensor, lens: Lens) -> torch.Tensor:
    """Pinhole-resample a small frame batch (B, H, W, C): one warp launch
    (anchor-path detection only; hot paths bend their sample
    coordinates)."""
    return undistort_frame(frames, lens)


def _k1_sweep(q_at, grid) -> tuple[float, float]:
    """Coarse-grid + fine-neighborhood maximization of a k1 quality probe,
    with the phantom-lens hysteresis shared by both calibrators."""
    qs = [q_at(k) for k in grid]
    q0 = qs[list(grid).index(0.0)]
    i = int(np.argmax(qs))
    best_k, best_q = grid[i], qs[i]
    if best_k != 0.0:
        lo = grid[i - 1] if i > 0 else best_k - 0.02
        hi = grid[i + 1] if i + 1 < len(grid) else best_k + 0.02
        for k in np.linspace(lo, hi, 7)[1:-1]:
            q = q_at(float(k))
            if q > best_q:
                best_k, best_q = float(k), q
    gain = best_q / max(q0, 1e-9)
    if gain < K1_CAL_MARGIN or abs(best_k) < 0.01:
        return 0.0, gain
    return round(best_k, 4), gain


def _k1_bow_refine(bow_at, k0: float) -> float:
    """Two-stage scan of the |bow| objective around the evidence winner:
    ±0.02 at 0.005 steps, then ±0.005 at ~0.0017 steps around that
    argmin."""
    best_k, best_b = k0, bow_at(k0)
    for span, n in ((0.02, 9), (0.005, 7)):
        for k in np.linspace(best_k - span, best_k + span, n):
            bv = bow_at(float(k))
            if bv < best_b:
                best_k, best_b = float(k), bv
    return round(best_k, 4)


def _cal_zone(gsize: int) -> int:
    """Canonical px a cell for the known-corner probes: the rect at
    ≥ 512² (513² at 19), the resolution 0.015-step discrimination needs."""
    return max(16, int(round(512 / gsize)))


def estimate_lens_k1(frame: torch.Tensor, gsize: int = 19,
                     grid=K1_CAL_GRID) -> tuple[float, float]:
    """Estimate the radial distortion coefficient from one frame
    (H, W, 3) → (k1, gain).

    Coarse grid over k1, a fine sweep between the winner's neighbours
    (``_detect_k1_probe``), then a bow refinement against the corners
    detected at the adopted k1 (``_corners_bow_probe``: the bow
    differential cancels any constant or affine residual of a ~2 px
    corner error). gain is the winner's evidence over the pinhole run; k1
    is 0.0 unless it clears ``K1_CAL_MARGIN``. The k1 values are Python
    floats, and each probe's quality is read on the host.
    """
    def q_at(k1: float) -> float:
        _, _, q = _detect_k1_probe(frame, k1, gsize=gsize)
        q = float(q)
        return q if np.isfinite(q) else -1.0

    k1, gain = _k1_sweep(q_at, grid)
    if k1 != 0.0:
        corners, score, _ = _detect_k1_probe(frame, k1, gsize=gsize)
        if float(score) >= DETECT_MIN_SCORE \
                and bool(torch.isfinite(corners).all()):
            zone = _cal_zone(gsize)

            def bow_at(k: float) -> float:
                b = float(_corners_bow_probe(frame, corners, k, gsize=gsize,
                                             zone=zone))
                return b if np.isfinite(b) else np.inf

            k1 = _k1_bow_refine(bow_at, k1)
    return k1, gain


def _gray_of(frame: torch.Tensor) -> torch.Tensor:
    """The probes' gray frame: uint8 luma of uint8 RGB, float luma of
    float RGB."""
    return rgb_to_gray_u8(frame) if frame.dtype == torch.uint8 \
        else rgb_to_gray(to_float(frame))


def _corners_rect(frame: torch.Tensor, corners: torch.Tensor, k1: float,
                  gsize: int, zone: int):
    """The frame rectified through known raw ``corners`` under a candidate
    lens: the homography on their pinhole positions, the sample grid bent
    back through the lens (the readers' sampler) → (rect (S, S), canonical
    corners (4, 2)), S = gsize·zone."""
    lens = make_lens(k1, (frame.shape[0], frame.shape[1]))
    pin = undistort_pts(lens, corners.to(torch.float32))
    cc = canonical_corners(gsize, zone, corners.device)
    H = homography_dlt(cc, pin)
    return _sample_rect(_gray_of(frame), H, gsize * zone, lens), cc


def _corners_k1_probe(frame: torch.Tensor, corners: torch.Tensor, k1: float,
                      gsize: int = 19, zone: int = 27) -> torch.Tensor:
    """Lattice-evidence quality of KNOWN corners under a candidate k1 (the
    manual-mode calibration probe): the frame rectified through the
    candidate lens, scored by line-scale evidence at the canonical
    intersections. With the true k1 the grid lines land on the canonical
    lattice; with a wrong one the interior lines stay bowed. One warp,
    a Sobel and two box blurs: no detection."""
    rect, cc = _corners_rect(frame, corners, k1, gsize, zone)
    return _lattice_evidence_rc(_line_evidence(rect), cc[None], gsize)[0]


@functools.lru_cache(maxsize=16)
def _bow_windows(gsize: int, zone: int, device):
    """The static centroid windows of ``_corners_bow_probe`` on ``device``,
    made once per (gsize, zone, device): (tap indices (G, 2w+1) int64,
    tap positions (G, 2w+1), line centers (G,)). Read only."""
    centers = zone / 2.0 - 0.5 + zone * np.arange(gsize)
    w = zone // 2 - 3
    idx = np.round(centers).astype(np.int32)[:, None] \
        + np.arange(-w, w + 1)[None, :]                  # (G, 2w+1)
    return (torch.as_tensor(idx.astype(np.int64), device=device),
            torch.as_tensor(idx.astype(np.float32), device=device),
            torch.as_tensor(centers.astype(np.float32), device=device))


def _corners_bow_probe(frame: torch.Tensor, corners: torch.Tensor,
                       k1: float, gsize: int = 19,
                       zone: int = 27) -> torch.Tensor:
    """Mean |line bow| of the candidate-k1 rectified canvas: the k1
    REFINEMENT objective (``_corners_k1_probe`` is the adoption one).

    Residual distortion leaves grid lines bowed in the canvas: a line's
    mid-span centroid shifts against its end spans. Per grid line,
    sub-pixel edge-energy centroids in three bands along it give
    bow = offset(mid) − mean(offset(outer)); the objective is mean |bow|
    over the interior lines of both axes (the outermost two sit against
    the board edge). Its argmin sits on the true k1 at 0.005 granularity
    where the evidence curve is plateau-noisy. Windows are ±(zone/2 − 3)
    px, so it only refines."""
    rect, _ = _corners_rect(frame, corners, k1, gsize, zone)
    res = gsize * zone
    gx = torch.abs(torch.diff(rect, dim=1, prepend=rect[:, :1]))
    gy = torch.abs(torch.diff(rect, dim=0, prepend=rect[:1]))
    idx, taps, ctr = _bow_windows(gsize, zone, rect.device)

    def offsets(prof: torch.Tensor) -> torch.Tensor:
        seg = prof[idx]                                   # (G, 2w+1)
        seg = seg - seg.amin(dim=1, keepdim=True)
        m = torch.clamp(seg.sum(dim=1), min=1e-9)
        return (seg * taps).sum(dim=1) / m - ctr          # (G,)

    b = res // 3
    total = None
    for energy, mean_axis in ((gx, 0), (gy, 1)):
        if mean_axis == 0:      # vertical lines: row bands
            bands = (energy[:b].mean(0), energy[b:2 * b].mean(0),
                     energy[2 * b:].mean(0))
        else:                   # horizontal lines: column bands
            bands = (energy[:, :b].mean(1), energy[:, b:2 * b].mean(1),
                     energy[:, 2 * b:].mean(1))
        o0, o1, o2 = (offsets(p) for p in bands)
        bow = torch.abs(o1 - 0.5 * (o0 + o2))[2:-2].mean()
        total = bow if total is None else total + bow
    return 0.5 * total


def estimate_lens_k1_corners(frame: torch.Tensor, corners,
                             gsize: int = 19,
                             grid=K1_CAL_GRID) -> tuple[float, float]:
    """Estimate k1 from one frame whose board corners (raw frame
    positions, tl/tr/br/bl) are KNOWN — the manual finder's calibrator —
    → (k1, gain), with the sweep and hysteresis of
    ``estimate_lens_k1``."""
    corners = torch.as_tensor(np.asarray(corners, np.float32)
                              .reshape(4, 2)).to(frame.device) \
        if not isinstance(corners, torch.Tensor) else \
        corners.to(frame.device, torch.float32).reshape(4, 2)
    zone = _cal_zone(gsize)

    def q_at(k1: float) -> float:
        q = float(_corners_k1_probe(frame, corners, k1, gsize=gsize,
                                    zone=zone))
        return q if np.isfinite(q) else -1.0

    k1, gain = _k1_sweep(q_at, grid)
    if k1 != 0.0:
        def bow_at(k: float) -> float:
            b = float(_corners_bow_probe(frame, corners, k, gsize=gsize,
                                         zone=zone))
            return b if np.isfinite(b) else np.inf

        k1 = _k1_bow_refine(bow_at, k1)
    return k1, gain


# ---------------------------------------------------------------------------
# Batched redetection: stage 1 for the whole batch, then per-chunk refines
# on a chunk-shared rectification canvas, per-frame refines where a chunk
# fails validation.
# ---------------------------------------------------------------------------

#: Max stage-1 quad deviation from the chunk median (in cells) for the
#: shared-canvas refine; beyond it the per-frame refine is the route.
SHARED_REFINE_SPREAD = 0.55

#: Frames per shared-canvas chunk.
SHARED_CHUNK = 8


def _refine_shared_batch(grays: torch.Tensor, shared_quad: torch.Tensor,
                         quads: torch.Tensor, gsize: int = 19):
    """Line-dominated refine of a batch on ONE shared rectification canvas.

    All B grays (B, H, W) are rectified through the homography of
    ``shared_quad`` in one warp-kernel launch; each frame's own lattice is
    then measured on its own canvas (comb race, 2D evidence ranking,
    per-half sub-pixel pin), so its corners come from its own pixels only.
    The per-frame measurement is a Python loop over frames with no host
    wait, about 2,600 small device ops a frame (the per-frame refine's
    line-dominated branch less its gathers), so it is bound by the host's
    launch rate; a frame dimension through it is the lever.
    Returns (corners (B, 4, 2), derotate deltas (B,), concentrations (B,)).
    """
    res = REFINE_RES
    H = _rect_H(shared_quad, 0.10, res)
    scale = 1.0 / 255.0 if grays.dtype == torch.uint8 else 1.0
    rects = warp_frames(grays[..., None], H, (res, res), scale)[..., 0]
    Hinv = torch.linalg.inv_ex(H).inverse
    corners, deltas, concs = [], [], []
    for rect, quad in zip(rects, quads):
        colp, rowp = _profiles_of(rect, gsize)
        _, vc1, _ = _fit_combs_multi(H, colp, rowp, gsize, (1.0, 0.0))
        E = _evidence_map(rect, gsize)
        cell = torch.linalg.vector_norm(quad[1] - quad[0]) / (gsize + 0.0)
        rank1 = _rank_evidence(vc1, E, Hinv, quad, cell, gsize)
        w1 = _at(vc1, torch.argmax(rank1))
        corners.append(_pin_corners_on_rect(rect, H, w1, gsize))
        delta, conc = _resid_rotation(rect)
        deltas.append(delta)
        concs.append(conc)
    return (torch.stack(corners).to(torch.float32), torch.stack(deltas),
            torch.stack(concs))


def _shared_gate(quads, scores, gsize: int):
    """The stage-1 part of ONE chunk's verdict, on the device → (ok, the
    chunk's median quad): every quad finite and line-dominated, and
    within SHARED_REFINE_SPREAD cells of the chunk median."""
    # The median of an even count averages the two middle values, as
    # jnp.median does; torch.median would return the lower one.
    med = torch.quantile(quads, 0.5, dim=0)
    cell = torch.linalg.vector_norm(med[1] - med[0]) / max(gsize - 1, 1)
    ok = torch.isfinite(quads).all() & (scores > 0.55).all() \
        & (cell > 1e-6) \
        & ((quads - med).abs().amax() <= SHARED_REFINE_SPREAD * cell)
    return ok, med


def _shared_refine(grays, med, quads, gsize: int):
    """ONE chunk refined on the canvas of its median quad ``med`` →
    (corners, the post-refine part of its verdict: no derotate trip and
    finite corners), on the device; in its own span."""
    with span("camkifu.detect_batch.shared"):
        corners, deltas, concs = _refine_shared_batch(grays, med, quads,
                                                      gsize)
        trip = ((torch.abs(deltas * (2.0 / 3.0)) > DEROTATE_TRIP)
                & (concs > DEROTATE_MIN_CONC)).any()
        return corners, ~trip & torch.isfinite(corners).all()


def _chunked_route(grays, quads, scores, gsize: int, chunk: int):
    """The batch through per-chunk shared-canvas refines → (corners
    (B, 4, 2), full verdicts (B // chunk,) bool: gate and post-refine
    parts), both left on the device. The reference's jitted entry points
    around it (``_route_and_refine_chunked``, ``_route_and_refine_shared``
    for one chunk, and ``_detect_batch_fused`` with stage 1 ahead of it)
    are this function here: eager PyTorch needs no separate entry point.
    ``_detect_batch_routed`` refines only the chunks whose gate holds."""
    corners, oks = [], []
    for lo in range(0, grays.shape[0], chunk):
        part = slice(lo, lo + chunk)
        gate, med = _shared_gate(quads[part], scores[part], gsize)
        c, ok = _shared_refine(grays[part], med, quads[part], gsize)
        corners.append(c)
        oks.append(gate & ok)
    return torch.cat(corners), torch.stack(oks)


def _detect_batch_routed(grays, quads, scores, gsize: int):
    """Route a batch through per-chunk shared-canvas refines; None if every
    chunk fell back. Every chunk's gate is fetched in one host read, and
    only the chunks that pass it are refined on their shared canvas (a
    failed gate would discard those corners); a second read fetches their
    post-refine verdicts."""
    b = grays.shape[0]
    if b < 2:
        return None
    chunk = SHARED_CHUNK if b % SHARED_CHUNK == 0 else b
    parts = [slice(lo, lo + chunk) for lo in range(0, b, chunk)]
    gates, meds = zip(*(_shared_gate(quads[p], scores[p], gsize)
                        for p in parts))
    oks = torch.stack(gates).cpu().numpy()
    if not oks.any():
        return None
    refined = {c: _shared_refine(grays[parts[c]], meds[c], quads[parts[c]],
                                 gsize)
               for c in np.flatnonzero(oks).tolist()}
    oks[list(refined)] = torch.stack([ok for _, ok in refined.values()]) \
        .cpu().numpy()
    return _merge_routed(grays, quads, scores,
                         {c: cs for c, (cs, _) in refined.items()}, oks,
                         chunk, gsize)


def _merge_routed(grays, quads, scores, corners, oks_host: np.ndarray,
                  chunk: int, gsize: int):
    """Shared-canvas chunks where the verdict holds (``corners[c]``: chunk
    c's shared-canvas corners), per-frame refines of the failed
    chunks (``_detect_refine``, the reference's ``_refine_one``); None when
    no chunk validated."""
    if not oks_host.any():
        return None
    out = []
    for c, ok in enumerate(oks_host):
        lo, hi = c * chunk, (c + 1) * chunk
        if ok:
            out.append(corners[c])
        else:
            out.append(torch.stack([
                _refine_one(grays[i], quads[i], scores[i], gsize)
                for i in range(lo, hi)]))
    return torch.cat(out)


def _refine_one(gray, quad, score, gsize: int):
    """One frame refined alone (``_detect_refine``), in its own span: a
    frame of a chunk that failed validation, or of a batch that no shared
    canvas served."""
    with span("camkifu.detect_batch.refine_one"):
        return _detect_refine(gray, quad, score, gsize)


def detect_batch(frames: torch.Tensor, res: int = cvconf.bf_resolution,
                 gsize: int = 19):
    """Per-frame detection over a batch (B, H, W, 3) → (corners (B, 4, 2),
    scores (B,)).

    Stage 1 runs batched; with two frames or more, each chunk of
    ``SHARED_CHUNK`` frames (or the whole batch where B is not a multiple)
    is gated on its stage-1 quads and scores, and a chunk that passes is
    refined on its own shared canvas and validated on the device. The
    host fetches the gates, then the verdicts of the chunks refined;
    chunks that fail either are refined frame by frame, as
    ``detect_corners`` refines.

    Spans: ``camkifu.detect_batch`` around the call, holding
    ``camkifu.detect_batch.coarse`` (stage 1: the edge, hysteresis and
    Hough launches) and ``camkifu.detect_batch.refine`` (the gates, the
    shared-canvas refines, the verdict fetches and any per-frame refine),
    which holds one ``camkifu.detect_batch.shared`` a chunk refined on
    its shared canvas and one ``camkifu.detect_batch.refine_one`` a frame
    refined alone.
    """
    with span("camkifu.detect_batch"):
        with span("camkifu.detect_batch.coarse"):
            grays, quads, scores = _detect_prepare_batch(frames, res)
        with span("camkifu.detect_batch.refine"):
            merged = _detect_batch_routed(grays, quads, scores, gsize)
            if merged is None:
                merged = torch.stack([
                    _refine_one(grays[i], quads[i], scores[i], gsize)
                    for i in range(frames.shape[0])])
        return merged, scores


def accept_detections(detected: torch.Tensor, scores: torch.Tensor,
                      seeds: torch.Tensor) -> torch.Tensor:
    """Each board's detected corners where they are finite and its score
    reaches ``DETECT_MIN_SCORE`` (``BoardFinderAuto._detect``'s rule, a
    board at a time), its row of ``seeds`` elsewhere, chosen on the
    device: detected (n, 4, 2), scores (n,), seeds (n, 4, 2) → (n, 4, 2)
    in ``seeds``' dtype."""
    ok = torch.isfinite(detected).all(dim=-1).all(dim=-1) \
        & (scores >= DETECT_MIN_SCORE)
    return torch.where(ok[:, None, None], detected.to(seeds.dtype), seeds)


def detect_batch_stable(frames: torch.Tensor,
                        res: int = cvconf.bf_resolution, gsize: int = 19,
                        max_frames: int = 8) -> torch.Tensor:
    """Fixed-camera estimate (4, 2): per-frame detection of at most
    ``max_frames`` evenly spaced frames, then the median corner positions
    over the confident ones (the plain median if none is confident).

    Medians average the two middle values of an even count, as
    ``jnp.median`` and ``jnp.nanmedian`` do (``torch.median`` would take
    the lower one)."""
    b = frames.shape[0]
    if b > max_frames:
        frames = frames[::max(1, b // max_frames)][:max_frames]
    corners, scores = detect_batch(frames, res, gsize)
    ok = (scores >= 0.05)[:, None, None]
    big = torch.where(ok, corners, float("nan"))
    med = torch.nanquantile(big, 0.5, dim=0)
    return torch.where(torch.isnan(med), torch.quantile(corners, 0.5, dim=0),
                       med)


# ---------------------------------------------------------------------------
# Per-frame corner tracking (a handheld camera): each frame's board motion
# is measured from its own pixels on a canvas its chunk shares. A chunk of
# frames is a tensor dimension; the only Python loop is the one over
# chunks, which carries (seed, ref_col, ref_row) as tensors and never
# reads a value on the host.
# ---------------------------------------------------------------------------

#: Outward margin of the tracking rectification; also bounds how far the
#: board may move within ~2 chunks before tracking must re-seed.
TRACK_MARGIN = 0.18

#: Correlation search half-window, in cells: how far the board may move
#: between consecutive tracked frames (and per chunk re-seed).
TRACK_WIN_OFFSET = 0.75

#: Correlation-peak sharpness (peak/mean) below which a frame's measurement
#: is rejected (occlusion/motion blur) and the previous offset is kept.
TRACK_MIN_SHARPNESS = 1.5

#: Reference-profile adaptation rate (EMA toward the latest aligned frame,
#: so slow scene changes — new stones — don't decorrelate the reference).
TRACK_REF_EMA = 0.15

#: Lattice-alignment trip-wire: a host forces re-detection when a batch's
#: comb alignment falls below this fraction of the baseline pinned at the
#: last re-anchor.
TRACK_ALIGN_TRIP = 0.6

#: Discontinuity trip-wire: the max credible per-frame tracked-corner step,
#: in cells (the lattice is periodic, so a bump can lock a whole cell off).
TRACK_JUMP_TRIP = 0.5

#: Per-chunk caps on the measured rotation/scale update: beyond these the
#: scene changed faster than tracking can model (a bump).
TRACK_MAX_THETA = 0.12          # rad (~7°)
TRACK_MAX_SIGMA = 0.08

#: Max disagreement between the two independent θ (or σ) estimates before
#: the whole frame is distrusted: occluders corrupt the x- and y-derived
#: estimates differently; real rotation/zoom moves both together.
TRACK_DIFF_AGREE = 0.015

#: Deadband (in cells) for the ABSOLUTE corrections (teeth-fit center
#: deviations, lattice lock): below it a correction is indistinguishable
#: from the lattice signal's own content bias; above it, it is a real
#: seed/reference error and applies whole.
TRACK_ABS_DEADBAND = 0.12


def _profile_shift(profile: torch.Tensor, delta) -> torch.Tensor:
    """Translate a 1D profile by ``delta`` (sub-pixel, edge-clamped).
    Profiles (..., n) take a ``delta`` of their leading dims."""
    n = profile.shape[-1]
    return _interp1d_hat(
        profile,
        torch.arange(n, dtype=torch.float32, device=profile.device)
        + _col(delta))


def _corr_shift(profiles: torch.Tensor, ref: torch.Tensor, S: int):
    """(B, n) profiles × (n,) reference → per-frame sub-pixel translation +
    correlation-peak sharpness, via one (B, n)×(n, 2S+1) product. Leading
    dims (..., B, n) × (..., n) are streams, each with its own reference.

    corr[s] pairs p[i] with ref[i + s − S]: a peak at s means the profile
    is the reference translated RIGHT by d = S − s. Ties take the first
    peak.
    """
    n = profiles.shape[-1]
    n_sh = 2 * S + 1
    shifted = F.pad(ref, (S, S)).unfold(-1, n, 1)           # (..., 2S+1, n)
    corr = profiles @ shifted.transpose(-1, -2)             # (..., B, 2S+1)
    best = torch.argmax(corr, dim=-1, keepdim=True)
    c0 = torch.gather(corr, -1, best)[..., 0]
    cm = torch.gather(corr, -1, torch.clamp(best - 1, 0, n_sh - 1))[..., 0]
    cp = torch.gather(corr, -1, torch.clamp(best + 1, 0, n_sh - 1))[..., 0]
    den = cm - 2 * c0 + cp
    sub = torch.where(torch.abs(den) > 1e-9,
                      torch.clamp(0.5 * (cm - cp) / den, -1, 1), 0.0)
    d = S - (best[..., 0].to(torch.float32) + sub)
    sharp = c0 / torch.clamp(corr.mean(dim=-1), min=1e-6)
    return d, sharp


def _hold_bad(d: torch.Tensor, ok: torch.Tensor) -> torch.Tensor:
    """Replace rejected per-frame measurements (..., chunk) with the last
    good one, 0 before the first: a running maximum over the good frames'
    indices, then a gather."""
    idx = torch.arange(d.shape[-1], device=d.device)
    last = torch.cummax(torch.where(ok, idx, -1), dim=-1).values
    return torch.where(last >= 0,
                       torch.gather(d, -1, torch.clamp(last, min=0)), 0.0)


def _lattice_offset(profile: torch.Tensor, first, pitch, gsize: int,
                    S: int):
    """ABSOLUTE lattice lock: sub-pixel offset of a profile's lattice from
    the positions the seed quad implies (teeth at first + k·pitch).

    The content-reference correlation measures only RELATIVE motion, so a
    seed error would persist as a constant corner offset; correlating
    against a synthetic comb TEMPLATE of the expected lattice measures the
    absolute residual once per chunk. Profiles (..., n) take ``first`` of
    their leading dims. Returns (offset, sharpness).
    """
    n = profile.shape[-1]
    bins = torch.arange(n, dtype=torch.float32, device=profile.device)
    pos = _col(first) + pitch * torch.arange(gsize, dtype=torch.float32,
                                             device=profile.device)
    template = torch.clamp(
        1.0 - torch.abs(bins - pos[..., :, None]), min=0.0).sum(dim=-2)
    d, sh = _corr_shift(profile[..., None, :], template, S)
    return d[..., 0], sh[..., 0]


def _abs_lock_update(cols0, rows0, first_x, first_y, px, py,
                     dx0, dy0, ok0, e_lock, S: int, gsize: int):
    """One chunk's absolute-lattice-lock update, shared by both tracking
    engines (per-axis vs shared pitch is the only call-site difference).

    Template-correlate the chunk's first frame against the seed-implied
    comb, then gate the residual three ways before merging it into the
    running ``e_lock`` (2,): correlation sharpness + frame ok; the
    comb-quality referee (accept only where the absolute comb score of the
    locked position beats the currently-held one); and the deadband
    (TRACK_ABS_DEADBAND·pitch). Leading dims of the profiles are streams.
    """
    ex_m, sex = _lattice_offset(cols0, first_x, px, gsize, S)
    ey_m, sey = _lattice_offset(rows0, first_y, py, gsize, S)
    qx_with = _comb_quality(cols0, first_x + ex_m, px, gsize)
    qx_without = _comb_quality(cols0, first_x + dx0 + e_lock[0], px, gsize)
    qy_with = _comb_quality(rows0, first_y + ey_m, py, gsize)
    qy_without = _comb_quality(rows0, first_y + dy0 + e_lock[1], py, gsize)
    exc = ex_m - dx0
    eyc = ey_m - dy0
    return torch.stack([
        torch.where((sex >= TRACK_MIN_SHARPNESS) & ok0
                    & (qx_with > qx_without)
                    & (torch.abs(exc) >= TRACK_ABS_DEADBAND * px),
                    exc, e_lock[0]),
        torch.where((sey >= TRACK_MIN_SHARPNESS) & ok0
                    & (qy_with > qy_without)
                    & (torch.abs(eyc) >= TRACK_ABS_DEADBAND * py),
                    eyc, e_lock[1])])


def _teeth_fit(profile: torch.Tensor, first, pitch, gsize: int):
    """Robust per-tooth lattice fit: snap each of the gsize teeth (expected
    at first + k·pitch) to its sub-pixel profile peak within ±pitch/3, then
    IRLS-weighted linear fit position_k ≈ A + B·(k − center).

    Profiles (..., n) take ``first`` (...,) and a pitch that is a number
    or broadcasts against it. Returns (da, b, ok), each (...,): deviation
    of the lattice CENTER from expected, fitted pitch B, and a validity
    flag (weighted rms residual < 0.15·pitch).
    """
    idx = torch.arange(gsize, dtype=torch.float32, device=profile.device)
    snapped, b0 = _snap_to_peaks(profile, _col(first) + _col(pitch) * idx,
                                 pitch, n_off=15)

    w = torch.clamp(b0, min=1e-6)
    ic = idx - (gsize - 1) / 2.0

    def wls(weights):
        sw = weights.sum(dim=-1)
        sx = (weights * ic).sum(dim=-1)
        sy = (weights * snapped).sum(dim=-1)
        sxx = (weights * ic * ic).sum(dim=-1)
        sxy = (weights * ic * snapped).sum(dim=-1)
        d = torch.clamp(sw * sxx - sx * sx, min=1e-6)
        B = (sw * sxy - sx * sy) / d
        A = (sy - B * sx) / sw
        return A, B

    A, B = wls(w)
    resid = snapped - (_col(A) + _col(B) * ic)
    w2 = w / (1.0 + (resid / (0.12 * _col(pitch))) ** 2)
    A, B = wls(w2)
    r2 = snapped - (_col(A) + _col(B) * ic)
    rms = torch.sqrt((w2 * r2 * r2).sum(dim=-1)
                     / torch.clamp(w2.sum(dim=-1), min=1e-6))
    ok = (rms < 0.15 * pitch) & (B > 0.5 * pitch)
    da = A - (first + pitch * (gsize - 1) / 2.0)
    return da, B, ok


def _half_geometry(rc: torch.Tensor, n: int, gsize: int):
    """Expected per-half lattice (first tooth, pitch) from the seed quad's
    ACTUAL rect-space corners (4, 2).

    The margin-expanded rectification is projective, so even a perfect
    seed's lattice is a slightly slanted quad in rect coordinates;
    interpolating the quad's edge lines at each half's measurement height
    gives every half its own exact expectation.

    Returns (fx_t, fx_b, sx_t, sx_b, fy_l, fy_r, sy_l, sy_r).
    """
    h1, h2 = 0.3125 * n, 0.6875 * n     # interior half measurement centers

    def xl(y):
        return rc[0, 0] + (y - rc[0, 1]) * (rc[3, 0] - rc[0, 0]) \
            / (rc[3, 1] - rc[0, 1])

    def xr(y):
        return rc[1, 0] + (y - rc[1, 1]) * (rc[2, 0] - rc[1, 0]) \
            / (rc[2, 1] - rc[1, 1])

    def yt(x):
        return rc[0, 1] + (x - rc[0, 0]) * (rc[1, 1] - rc[0, 1]) \
            / (rc[1, 0] - rc[0, 0])

    def yb(x):
        return rc[3, 1] + (x - rc[3, 0]) * (rc[2, 1] - rc[3, 1]) \
            / (rc[2, 0] - rc[3, 0])

    g1 = gsize - 1
    return (xl(h1), xl(h2), (xr(h1) - xl(h1)) / g1, (xr(h2) - xl(h2)) / g1,
            yt(h1), yt(h2), (yb(h1) - yt(h1)) / g1, (yb(h2) - yt(h2)) / g1)


def _track_measure(cf, rf, ct, cb, rl, rr, ref_col, ref_row, S: int,
                   geom, gsize: int):
    """Full + half-split profiles → per-frame 4-DoF similarity measurement.

    Inputs: (chunk, n) profiles from ``_split_profiles`` and the (n,)
    full-axis references, or a leading stream dim on both. Model: the
    board moved by a similarity about the rect center,
    p' = c + (1+σ)·R(θ)·(p−c) + t.

    Coarse translation and the frame gate use the full-extent content
    correlations (an occluder collapses their peak sharpness, so corrupted
    frames reject and hold). The four half-split profiles then get one
    robust per-tooth lattice fit (``_teeth_fit`` over a (4, chunk) stack),
    seeded at the frame's coarse translation and each against its own
    expected lattice (``_half_geometry``): rotation from the offsets of
    opposite halves, scale from the fitted pitch, absolute translation
    from the mean center offset. Each differential is accepted only when
    the frame's gate passed, both its half-fits converged, and the x- and
    y-derived estimates agree where both exist.

    Returns (tx, ty, theta, sigma, sharp, ok, rot_ok, scl_ok), all
    (..., chunk).
    """
    n = ct.shape[-1]
    fx_t, fx_b, sx_t, sx_b, fy_l, fy_r, sy_l, sy_r = geom
    tx, shxf = _corr_shift(cf, ref_col, S)
    ty, shyf = _corr_shift(rf, ref_row, S)
    sharp = torch.minimum(shxf, shyf)
    ok = sharp >= TRACK_MIN_SHARPNESS

    firsts = torch.stack([fx_t + tx, fx_b + tx, fy_l + ty, fy_r + ty])
    pitches = torch.stack([sx_t, sx_b, sy_l, sy_r]) \
        .reshape((4,) + (1,) * tx.ndim)
    (a_t, a_b, a_l, a_r), (b_t, b_b, b_l, b_r), (k_t, k_b, k_l, k_r) = \
        _teeth_fit(torch.stack([ct, cb, rl, rr]), firsts, pitches, gsize)

    lo = 0.375 * n                        # orthogonal-split lever

    th1 = (a_t - a_b) / lo
    th2 = (a_r - a_l) / lo
    v1 = k_t & k_b & ok
    v2 = k_l & k_r & ok
    both = v1 & v2
    agree_t = torch.abs(th1 - th2) < TRACK_DIFF_AGREE
    theta = torch.where(both, 0.5 * (th1 + th2), torch.where(v1, th1, th2))
    rot_ok = torch.where(both, agree_t, v1 | v2)

    sg1 = 0.5 * (b_t / sx_t + b_b / sx_b) - 1.0
    sg2 = 0.5 * (b_l / sy_l + b_r / sy_r) - 1.0
    agree_s = torch.abs(sg1 - sg2) < TRACK_DIFF_AGREE
    sigma = torch.where(both, 0.5 * (sg1 + sg2), torch.where(v1, sg1, sg2))
    scl_ok = torch.where(both, agree_s, v1 | v2)

    # Per-frame absolute translation refinement, when both halves fit (a
    # single half would alias θ into translation), outside the deadband.
    dbx = TRACK_ABS_DEADBAND * 0.5 * (sx_t + sx_b)
    dby = TRACK_ABS_DEADBAND * 0.5 * (sy_l + sy_r)
    cx = 0.5 * (a_t + a_b)
    cy = 0.5 * (a_l + a_r)
    tx = torch.where(v1 & (torch.abs(cx) >= dbx), tx + cx, tx)
    ty = torch.where(v2 & (torch.abs(cy) >= dby), ty + cy, ty)

    theta = torch.clamp(theta, -TRACK_MAX_THETA, TRACK_MAX_THETA)
    sigma = torch.clamp(sigma, -TRACK_MAX_SIGMA, TRACK_MAX_SIGMA)
    return tx, ty, theta, sigma, sharp, ok, rot_ok, scl_ok


def _apply_similarity(rc_pts: torch.Tensor, dx, dy, theta, sigma):
    """Apply per-frame similarity updates to rect-space points.

    rc_pts: (k, 2); dx/dy/theta/sigma: (..., chunk). → (..., chunk, k, 2)."""
    c = rc_pts.mean(dim=0)
    v = rc_pts - c                                       # (k, 2)
    cosT, sinT = torch.cos(theta), torch.sin(theta)      # (..., chunk)
    # Written out rather than as a product: a frame's points then do not
    # depend on how many frames or streams share the call.
    vv = torch.stack([_col(cosT) * v[:, 0] - _col(sinT) * v[:, 1],
                      _col(sinT) * v[:, 0] + _col(cosT) * v[:, 1]], -1) \
        * (1.0 + sigma)[..., None, None]                     # (..., k, 2)
    return c + vv + torch.stack([dx, dy], -1)[..., None, :]


def _align_quality(cols, rows, rc_seed, dx, dy, sigma, gsize: int):
    """Lattice-alignment trip-wire signal (..., chunk): the gap-penalized comb
    score of each frame's OWN profiles at the comb position the tracked
    transform predicts. It is absolute: teeth off the true lattice score
    low however self-consistent the correlation is."""
    c = rc_seed.mean(dim=0)
    ox = c[0] + (rc_seed[0, 0] - c[0]) * (1.0 + sigma) + dx   # (chunk,)
    oy = c[1] + (rc_seed[0, 1] - c[1]) * (1.0 + sigma) + dy
    sx = (rc_seed[1, 0] - rc_seed[0, 0]) * (1.0 + sigma) / (gsize - 1)
    sy = (rc_seed[3, 1] - rc_seed[0, 1]) * (1.0 + sigma) / (gsize - 1)
    return _comb_quality(cols, ox, sx, gsize) \
        + _comb_quality(rows, oy, sy, gsize)


def _chunks(x: torch.Tensor, chunk: int, dim: int = 0) -> torch.Tensor:
    """Frames along ``dim``, (..., B, ...) → (..., k, chunk, ...), the last
    frame repeated up to a multiple of ``chunk``."""
    pad = (-x.shape[dim]) % chunk
    if pad:
        last = x.narrow(dim, x.shape[dim] - 1, 1)
        x = torch.cat([x, last.expand(*x.shape[:dim], pad,
                                      *x.shape[dim + 1:])], dim=dim)
    return x.reshape(*x.shape[:dim], -1, chunk, *x.shape[dim + 1:])


def _held_measure(profiles, ref_col, ref_row, S: int, geom, gsize: int):
    """``_track_measure`` of a chunk with rejected frames holding the last
    good value per degree of freedom → (dx, dy, theta, sigma, sharp, ok)."""
    tx, ty, theta, sigma, sharp, ok, rot_ok, scl_ok = _track_measure(
        *profiles, ref_col, ref_row, S, geom, gsize)
    return (_hold_bad(tx, ok), _hold_bad(ty, ok),
            _hold_bad(theta, rot_ok & ok), _hold_bad(sigma, scl_ok & ok),
            sharp, ok)


def track_corners_batch(frames: torch.Tensor, seed_corners: torch.Tensor,
                        gsize: int = 19, chunk: int = 8,
                        res: int = REFINE_RES, lens: Lens | None = None):
    """Per-frame board corners across a batch, tracked from a seed
    detection.

    Each ``chunk`` consecutive gray frames are rectified through one
    homography built from the running seed (one warp launch per chunk),
    and each frame's lattice profiles are cross-correlated against a
    slowly-adapting reference for a coarse (dx, dy); on top of it a full
    4-DoF similarity (translation, in-plane rotation, scale) is solved
    from half-split profile lattice fits (``_track_measure``). The next
    chunk re-rectifies at the last frame's corners. Out-of-plane drift is
    unmodeled; the per-frame lattice-alignment score ``align`` is the
    trip-wire for it.

    frames: (B, H, W, 3) uint8/float; seed_corners: (4, 2) from
    ``detect_corners`` (or the previous batch's ``new_seed``), raw frame
    positions. With ``lens`` the canvas is built in pinhole geometry and
    its sample grid bends through the lens, so the lattice stays straight;
    the corners come back distorted to raw frame positions.
    Returns (corners (B, 4, 2) float32, sharpness (B,), align (B,),
    new_seed (4, 2)).
    """
    b = frames.shape[0]
    fc = _chunks(frames, chunk)

    # Correlation search window, in rect px (static).
    s0 = (res - 1.0) / ((1.0 + TRACK_MARGIN) * (gsize - 1))
    S = max(2, int(round(TRACK_WIN_OFFSET * s0)))

    def canvas(seed):
        """Homography rect → pinhole frame of the canvas anchored on
        ``seed``, and where the seed corners ACTUALLY land on it (4, 2):
        the frame-space margin expansion is not affine."""
        pin = undistort_pts(lens, seed)
        H = _rect_H(pin, TRACK_MARGIN, res)
        return H, apply_homography(_inv3(H), pin)

    seed = seed_corners.to(torch.float32)
    H, rc_seed = canvas(seed)
    ref_col = ref_row = None
    out_cs, out_sharp, out_align = [], [], []
    for frames_chunk in fc:
        grays = rgb_to_gray_u8(frames_chunk)
        rects = warp_frames(grays[..., None], H, (res, res),
                            1.0 / 255.0, lens)[..., 0]
        profiles = _split_profiles(rects, gsize)
        cols, rows = profiles[0], profiles[1]
        # The first chunk bootstraps the reference from its first frame
        # (the seed detection ran on or near it).
        if ref_col is None:
            ref_col, ref_row = cols[0], rows[0]
        sx = (rc_seed[1, 0] - rc_seed[0, 0]) / (gsize - 1)
        sy = (rc_seed[3, 1] - rc_seed[0, 1]) / (gsize - 1)
        first_x = 0.5 * (rc_seed[0, 0] + rc_seed[3, 0])
        first_y = 0.5 * (rc_seed[0, 1] + rc_seed[1, 1])
        dx, dy, theta, sigma, sharp, ok = _held_measure(
            profiles, ref_col, ref_row, S,
            _half_geometry(rc_seed, res, gsize), gsize)

        # Absolute lattice lock, chunk-local: the hand-off re-anchors on
        # measured corners, so no correction carries across chunks.
        e_lock = _abs_lock_update(cols[0], rows[0], first_x, first_y,
                                  sx, sy, dx[0], dy[0], ok[0],
                                  dx.new_zeros(2), S, gsize)
        dx = dx + e_lock[0]
        dy = dy + e_lock[1]

        cs = distort_pts(lens, apply_homography(
            H, _apply_similarity(rc_seed, dx, dy, theta, sigma)))
        out_cs.append(cs)
        out_sharp.append(sharp)
        out_align.append(
            _align_quality(cols, rows, rc_seed, dx, dy, sigma, gsize))
        # Hand off: the next chunk re-rectifies at the last frame's
        # corners, so on ITS canvas the lattice sits at the new rc_seed.
        # Realign both reference parts onto the new anchor
        # (``_profile_shift`` moves a peak at p to p − delta).
        seed = cs[-1]
        anchor = rc_seed.mean(dim=0)
        H, rc_seed = canvas(seed)
        anchor2 = rc_seed.mean(dim=0)
        ref_col = (1 - TRACK_REF_EMA) * _profile_shift(
            ref_col, anchor[0] - anchor2[0]) \
            + TRACK_REF_EMA * _profile_shift(
                cols[-1], anchor[0] + dx[-1] - anchor2[0])
        ref_row = (1 - TRACK_REF_EMA) * _profile_shift(
            ref_row, anchor[1] - anchor2[1]) \
            + TRACK_REF_EMA * _profile_shift(
                rows[-1], anchor[1] + dy[-1] - anchor2[1])
    return (torch.cat(out_cs)[:b], torch.cat(out_sharp)[:b],
            torch.cat(out_align)[:b], seed)


def rectify_track_batch(frames: torch.Tensor, seed_corners: torch.Tensor,
                        gsize: int = 19, zone: int = 16, chunk: int = 16,
                        pad_cells: int = 1, lens: Lens | None = None):
    """FUSED canonical rectification + per-frame board tracking.

    One warp launch per chunk rectifies its frames to an EXPANDED canonical
    canvas whose anchors put the seed's corner intersections at static
    positions; lattice-profile correlation against a drift-realigned
    reference then measures each frame's similarity from its own pixels,
    and the canonical image is cropped at the measured integer offset and
    sub-pixel-shifted by the fraction. Against ``track_corners_batch``
    followed by ``warp_batch_chunked`` this warps each frame once, and the
    drift correction comes from measured pixels. The crop corrects
    translation only: in-chunk rotation is bounded by one chunk's worth,
    since the chunk hand-off re-anchors the canvas on the tracked corners.

    frames: (B, H, W, 3); seed_corners: (4, 2) from ``detect_corners``,
    raw frame positions; lens: the camera's ``ops.lens.Lens`` or None.
    Returns (canon (B, S, S, 3) float [0, 1] with S = gsize·zone,
             corners (B, 4, 2) frame-space, sharpness (B,), align (B,),
             new_seed (4, 2)).

    One stream of ``rectify_track_streams``.
    """
    out = rectify_track_streams(frames[None], seed_corners[None], gsize,
                                zone, chunk, pad_cells, lens)
    return tuple(x[0] for x in out)


def rectify_track_streams(frames: torch.Tensor, seeds: torch.Tensor,
                          gsize: int = 19, zone: int = 16, chunk: int = 16,
                          pad_cells: int = 1, lenses: Lens | None = None):
    """``rectify_track_batch`` of n independent streams at once, the
    streams a leading tensor dimension: frames (n, B, H, W, 3), seeds
    (n, 4, 2), and every output gains the leading n. Each chunk is one warp
    launch for all n·chunk frames, each through its own stream's
    homography; the measurement, lattice lock and crop run on (n, chunk)
    stacks. The only Python loop is over chunks, and nothing in it waits
    for the device.

    ``lenses``: None, one ``Lens`` of numbers for every stream, or a
    stacked one (``ops.lens.stack_lenses``, (n,) fields), a camera a
    stream: the chunk's warp then reads a lens a frame, its table made
    once a call.
    """
    with span("camkifu.rectify_track_streams"):
        check_lens(lenses)
        n_streams, b = frames.shape[0], frames.shape[1]
        dev = frames.device
        scale = 1.0 / 255.0 if frames.dtype == torch.uint8 else 1.0
        fc = _chunks(frames, chunk, dim=1)               # (n, k, chunk, ...)

        size = gsize * zone                      # canonical side (304)
        pad = pad_cells * zone                   # drift margin (16)
        E = size + 2 * pad                       # expanded canvas (336)
        lo = pad + zone / 2.0 - 0.5
        hi = pad + size - zone / 2.0 - 0.5
        anchors = square(lo, hi, dev)
        # Correlation window must stay under one cell (the lattice is
        # periodic) and inside the crop margin.
        S = min(pad - 2, int(round(TRACK_WIN_OFFSET * zone)))
        geom = _half_geometry(anchors, E, gsize)

        # The warp's lens: shared numbers as they are, or one row a frame.
        warp_lens = lenses
        if lenses is not None and isinstance(lenses.k1, torch.Tensor):
            warp_lens = as_table(lenses)[:, None].expand(n_streams, chunk, 5) \
                .reshape(-1, 5)

        seed = seeds.to(torch.float32)                             # (n, 4, 2)
        ref_col = ref_row = None
        out_canon, out_cs, out_sharp, out_align = [], [], [], []
        for j in range(fc.shape[1]):
            # Raw corners, a pinhole canvas: the lattice stays straight.
            H = homography_dlt(anchors,
                               undistort_pts(lenses, seed))      # (n, 3, 3)
            hmats = H[:, None].expand(n_streams, chunk, 3, 3) \
                .reshape(-1, 3, 3)
            rect = warp_frames(fc[:, j].reshape(-1, *fc.shape[3:]), hmats,
                               (E, E), scale, warp_lens)  # (n·chunk, E, E, 3)
            profiles = _split_profiles(
                rgb_to_gray(rect).reshape(n_streams, chunk, E, E), gsize)
            cols, rows = profiles[0], profiles[1]          # (n, chunk, E)
            if ref_col is None:
                ref_col, ref_row = cols[:, 0], rows[:, 0]
            dx, dy, theta, sigma, sharp, ok = _held_measure(
                profiles, ref_col, ref_row, S, geom, gsize)

            # Absolute lattice lock: here the seed-implied comb is exactly the
            # static anchors (teeth at lo + k·zone), one pitch for both axes.
            e_lock = _abs_lock_update(cols[:, 0], rows[:, 0], lo, lo,
                                      float(zone), float(zone), dx[:, 0],
                                      dy[:, 0], ok[:, 0],
                                      dx.new_zeros(2, n_streams), S, gsize)
            dx = dx + e_lock[0][:, None]
            dy = dy + e_lock[1][:, None]

            # Canonical crop at the integer offset, then sub-pixel shift by
            # the fractional remainder. The offset is clamped to the pad−1
            # integer headroom + the ±2 px shift range FIRST: dx =
            # correlation (≤ S) + lattice lock can exceed pad−1, and an
            # unclamped remainder would saturate inside the shift,
            # mis-cropping the chunk. Beyond the clamp the canvas does not
            # contain the needed pixels; the corner outputs keep the true
            # measurement and the next re-anchor recovers.
            dc = torch.clamp(torch.stack([dx, dy], -1), -(pad + 1.0),
                             pad + 1.0)
            ic = torch.clamp(torch.round(dc), -(pad - 1), pad - 1)
            canon = _shifted_crop(rect, pad + ic.reshape(-1, 2).long(), size,
                                  (dc - ic).reshape(-1, 2))
            out_canon.append(
                canon.reshape(n_streams, chunk, *canon.shape[1:]))

            cs = distort_pts(lenses, apply_homography(
                H[:, None], _apply_similarity(anchors, dx, dy, theta, sigma)))
            out_cs.append(cs)
            out_sharp.append(sharp)
            out_align.append(
                _align_quality(cols, rows, anchors, dx, dy, sigma, gsize))
            # The next chunk re-anchors at the last frame's corners: its
            # lattice lands back at ``anchors``, so the old reference needs no
            # shift and the last profile realigns by its own translation.
            seed = cs[:, -1]
            ref_col = (1 - TRACK_REF_EMA) * ref_col \
                + TRACK_REF_EMA * _profile_shift(cols[:, -1], dx[:, -1])
            ref_row = (1 - TRACK_REF_EMA) * ref_row \
                + TRACK_REF_EMA * _profile_shift(rows[:, -1], dy[:, -1])
        return (torch.cat(out_canon, 1)[:, :b], torch.cat(out_cs, 1)[:, :b],
                torch.cat(out_sharp, 1)[:, :b], torch.cat(out_align, 1)[:, :b],
                seed)


# ---------------------------------------------------------------------------
# Host finder class (the cvconf-registered algorithm; SURVEY §2.1 bf_auto),
# copied from camkifu_tpu/board/bf_auto.py. Its trip-wires, EMA and bump
# rules are the reference's numpy float32 arithmetic, line for line; the
# device calls are this module's, and the host reads what it needs of a
# batch in one ``core.feeder.host_read``.
# ---------------------------------------------------------------------------

from camkifu_tpu_torch.board.boardfinder import BoardFinder  # noqa: E402
from camkifu_tpu_torch.core.feeder import host_read, to_device  # noqa: E402


class BoardFinderAuto(BoardFinder):
    """Automatic goban localization with temporal stabilization: per-batch
    detections accumulate into an EMA once confident; isolated outlier
    detections are rejected (the reference's accumulate-until-stable).

    Once a confident detection exists, every batch is additionally TRACKED
    (track_corners_batch): per-frame corners are measured from each frame's
    own pixels and published through ``corners_batch`` for stones finders
    that accept them; full detection re-runs at bf_period cadence (and
    immediately when tracking sharpness collapses) to re-anchor against
    rotation/scale drift the translation tracker does not model.

    ``frames`` are the manager's (B, H, W, 3) uint8 tensor on the device.
    ``track_seed`` lives there too; ``corners_batch``, ``_estimate``,
    ``_prev_tracked_last`` and ``_align_anchor`` are host values.
    """

    label = "automatic"

    def __init__(self, vmanager):
        super().__init__(vmanager)
        self._estimate: np.ndarray | None = None
        self.track_seed = None             # device (4, 2), batch-fresh
        #: Radial lens model (ops/lens.py), calibrated once at the first
        #: successful anchor — a physical property of the camera, so it
        #: never re-estimates mid-session. None = pinhole. Stones finders
        #: read it (getattr(bf, "lens", None)) and compose it into their
        #: warps; corners everywhere stay raw frame coordinates.
        self.lens = None
        self._lens_checked = False
        self._align_anchor: float | None = None  # align at last re-anchor
        self._prev_tracked_last: np.ndarray | None = None  # (4, 2) continuity
        #: True while this batch's tracking hit a discontinuity (jump trip):
        #: stones finders must not trust readings made with these corners.
        self.suspect_batch = False
        #: True while this batch adopted a fresh full detection (first
        #: anchor, bf_period re-anchor, or post-trip recovery). Stones
        #: finders that know the committed game cross-check the new pose
        #: against it (SfMeta pose veto) and may reject_anchor().
        self.fresh_anchor = False

    def _doframe(self, frames, n: int | None = None) -> None:
        self.suspect_batch = False
        super()._doframe(frames, n)        # periodic _detect + publish
        self.fresh_anchor = self._since_detect == 0
        if not self.ready():
            self.corners_batch = None
            self.track_seed = None
            return
        if self.track_seed is not None and self._since_detect == 0:
            # A fresh full detection just ran. Rotation/scale drift is
            # invisible to translation tracking, so ALWAYS pull the seed
            # toward the detection: a blend bounds the held drift to ~one
            # detection cadence while halving detection's own corner noise;
            # a jump beyond a cell is a camera bump — hard re-anchor.
            est = np.asarray(self.corners_array, np.float32)
            seed_np, = host_read(self.track_seed)
            cell = np.linalg.norm(est[1] - est[0]) / (self.gsize - 1)
            if np.abs(seed_np - est).max() > 1.0 * cell:
                self.track_seed = None
            else:
                self.track_seed = to_device(
                    np.asarray(0.5 * seed_np + 0.5 * est, np.float32),
                    frames.device)
            # A fresh anchor resets the alignment baseline and the
            # frame-to-frame continuity reference (a legitimate re-anchor
            # step must not read as a discontinuity).
            self._align_anchor = None
            self._prev_tracked_last = None
        if self.track_seed is None:
            self.track_seed = to_device(
                np.asarray(self.corners_array, np.float32), frames.device)
            self._align_anchor = None
            self._prev_tracked_last = None
        sf = getattr(self.vmanager, "stones_finder", None)
        if getattr(sf, "fused_tracking", False):
            # The stones finder tracks inside its fused rectify+classify
            # pass and reports back through report_tracking.
            return
        cs, sharp, align, new_seed = track_corners_batch(
            frames, self.track_seed, gsize=self.gsize, lens=self.lens)
        cs, sharp, align = host_read(cs, sharp, align)
        self.report_tracking(cs, new_seed, float(sharp.mean()),
                             self.batch_align(align, sharp))

    @staticmethod
    def batch_align(align, sharp) -> float:
        """Batch lattice-alignment summary: mean over the frames whose
        correlation was sharp (occluded/blurred frames report held offsets —
        their align says nothing about geometric drift)."""
        align = np.asarray(align)
        good = np.asarray(sharp) >= TRACK_MIN_SHARPNESS
        return float(align[good].mean() if good.any() else align.mean())

    def report_tracking(self, corners_batch: np.ndarray, new_seed,
                        mean_sharp: float,
                        mean_align: float | None = None) -> None:
        """Adopt a batch's per-frame tracking result (own or the fused
        stones-finder pass). Three independent trip-wires force a full
        re-detection on the next batch:

        - sharpness collapse — tracking lost outright (bump, occlusion);
        - lattice-alignment decay vs the baseline recorded at the last
          re-anchor — slow model-mismatch drift (out-of-plane perspective
          change) that stays correlation-sharp because the reference EMA
          adapts along with it (the r2 rotation probe's failure mode).
          The baseline is a running MAX since the last re-anchor — never
          EMA-adapted, so arbitrarily slow decay still trips, but a later
          cleaner batch can raise a pin depressed by a partially occluded
          first batch (which would otherwise put the trip threshold out of
          reach of real drift);
        - frame-to-frame discontinuity (TRACK_JUMP_TRIP) — a camera bump.
          Neither other wire can see it: after a knock the correlation
          locks onto a whole-cell-shifted alias of the periodic lattice
          that is both sharp and well-aligned, silently relocating every
          stone. A step this large is also beyond the correlation window,
          so the tracked batch is untrustworthy by construction — drop it
          and flag it suspect so stones finders discard the batch too.
        """
        cb = np.asarray(corners_batch)
        seq = cb if self._prev_tracked_last is None else \
            np.concatenate([self._prev_tracked_last[None], cb])
        steps = np.linalg.norm(np.diff(seq, axis=0), axis=-1)      # (S-1, 4)
        cell = np.linalg.norm(cb[-1, 1] - cb[-1, 0]) / (self.gsize - 1)
        max_step = float(steps.max()) if steps.size else 0.0
        self.metadata["track_step"] = round(max_step, 2)
        jump = cell > 1.0 and max_step > TRACK_JUMP_TRIP * cell
        if jump:
            # A discontinuity is a LEVEL SHIFT, not a spike: after a real
            # bump the lattice stays at the new position, while a 1–2-frame
            # measurement excursion (deep AE dip + shot noise + glare on a
            # dark board — the r4 gauntlet's combination, which stays just
            # above the sharpness gate) returns home. Trip only when the
            # median of the following frames remains displaced from the
            # pre-jump pose; a confirmed spike is absorbed (votes already
            # smooth the one misaligned reading). A jump too close to the
            # batch tail to verify defers: the continuity reference stays
            # at the pre-jump pose, so the next batch re-evaluates it with
            # full evidence.
            j = int(np.argmax(
                (np.max(steps, axis=-1) > TRACK_JUMP_TRIP * cell)))
            after = seq[j + 2:j + 6]
            if len(after) >= 2:
                disp = np.linalg.norm(np.median(after, axis=0) - seq[j],
                                      axis=-1).max()
                if disp <= TRACK_JUMP_TRIP * cell:
                    jump = False                      # spike: absorbed
                    self._prev_tracked_last = cb[-1]
                    self.metadata["track_spike"] = round(max_step, 2)
            else:
                jump = False                          # defer to next batch
                self._prev_tracked_last = seq[j]
            if not jump:
                self.corners_batch = corners_batch
                self.track_seed = new_seed
                self.metadata["track_sharpness"] = round(mean_sharp, 2)
                return
        if jump:
            self._since_detect = 10 ** 9      # force re-detect next batch
            self.track_seed = None
            self.corners_batch = None
            self._align_anchor = None
            self._prev_tracked_last = None
            # The pose history is the thing the trip disproved: the next
            # detection must re-anchor FRESH, not EMA-blend into the
            # pre-bump estimate (measured: a 1-cell knock below _detect's
            # hard-reset threshold crawled at 0.8^k toward the new pose,
            # re-seeding every re-anchor ~0.5 cell stale and pinning the
            # tracker at sharpness ~1.6 for the rest of the game).
            self._estimate = None
            self.suspect_batch = True
            self.metadata["track_trip"] = "jump"
            sf = getattr(self.vmanager, "stones_finder", None)
            if sf is not None:
                sf.on_tracking_discontinuity()
            return
        self._prev_tracked_last = cb[-1]
        self.corners_batch = corners_batch
        self.track_seed = new_seed
        self.metadata["track_sharpness"] = round(mean_sharp, 2)
        if mean_align is not None:
            self.metadata["track_align"] = round(mean_align, 3)
            if self._align_anchor is None or mean_align > self._align_anchor:
                self._align_anchor = mean_align
            elif (self._align_anchor > 0.02
                  and mean_align < TRACK_ALIGN_TRIP * self._align_anchor):
                self._since_detect = 10 ** 9      # force re-detect next batch
                self._estimate = None     # re-anchor fresh (see jump trip)
        if mean_sharp < TRACK_MIN_SHARPNESS:
            self._since_detect = 10 ** 9
            self.track_seed = None
            self.corners_batch = None
            self._align_anchor = None
            self._prev_tracked_last = None
            self._estimate = None         # re-anchor fresh (see jump trip)

    def reject_anchor(self) -> None:
        """A stones finder vetoed the freshly adopted pose (its readings
        wholesale contradict the committed game — SfMeta pose veto): the
        detection was confidently wrong, which full detection CAN be on
        stone-saturated boards rotated ≥~14° in-plane (measured: 3–8 cells
        off at score 0.27–0.35; the 1D combs cannot represent that basin
        and the 2D evidence prior picks a shrunk impostor). Drop the pose
        and every derived state; detection re-runs each batch until a pose
        consistent with the game appears. The alternative — accepting the
        pose — lets bulk self-correction rewrite the entire kifu onto the
        impostor lattice (the pre-trip-wire bump disaster, resurrected
        through the recovery path itself)."""
        self._since_detect = 10 ** 9
        self.track_seed = None
        self.corners_batch = None
        self._align_anchor = None
        self._prev_tracked_last = None
        self._estimate = None             # the pose history is disproved
        self.fresh_anchor = False
        self.suspect_batch = True
        # Unpublish: a vetoed pose must not serve the classic fixed-corner
        # path (or the GUI overlay) while re-anchoring.
        self.corners.clear()
        self.mtx = None
        self.metadata["track_trip"] = "pose_veto"

    def _detect(self, frames) -> bool:
        # Detection costs tens of ms a frame — sample up to 4 frames of the
        # batch for the median rather than detecting on all of them.
        b = frames.shape[0]
        step = max(1, b // 4)
        sample = frames[::step][:4]
        if self.lens is not None:
            # Straight-line detection on pinhole-resampled frames; the
            # per-frame results are bent back to raw coordinates below.
            sample = _undistort_batch(sample, self.lens)
        corners_all, scores = detect_batch(sample, gsize=self.gsize)
        if self.lens is not None:
            corners_all = distort_pts(self.lens, corners_all)
        # The median of an even count averages the two middle values, as
        # jnp.median does (torch.median would return the lower one); NaN
        # propagates to the isfinite check.
        det, scores = host_read(torch.quantile(corners_all, 0.5, dim=0),
                                scores)
        if not np.isfinite(det).all() or scores.max() < DETECT_MIN_SCORE:
            return False
        if not self._lens_checked:
            # First successful board sighting: calibrate the (fixed,
            # physical) lens once, and re-run this batch's detection if a
            # lens was found — the pinhole detection that just succeeded
            # is up to ~1.25 cells off at webcam-typical k1.
            k1, gain = estimate_lens_k1(sample[len(sample) // 2],
                                        gsize=self.gsize)
            self._lens_checked = True
            self.metadata["lens_k1"] = k1
            if k1 != 0.0:
                h, w = frames.shape[1], frames.shape[2]
                self.lens = make_lens(k1, (h, w))
                return self._detect(frames)
        if self._estimate is None:
            self._estimate = det
        else:
            jump = np.abs(det - self._estimate).max()
            cell = np.linalg.norm(self._estimate[1] - self._estimate[0]) \
                / (self.gsize - 1)
            if jump > 1.0 * cell:
                # Camera bump: restart accumulation from the new detection.
                # Detection corner noise measures ≤0.3 cell — a detection a
                # full cell away from the estimate is a moved camera, and
                # EMA-blending it would publish a pose between the two
                # (measured: a 1.05-cell knock crawled at 0.8^k for 5+
                # batches, each published pose wrong by ~0.5 cell).
                self._estimate = det
            else:
                self._estimate = 0.8 * self._estimate + 0.2 * det
        self.corners.clear()
        for p in self._estimate:
            self.corners.add(p)
        return self.corners.ready()


def _probe_main(argv=None) -> int:
    """Golden-input probe (SURVEY §4), the reference's ``__main__``: detect
    the board on one image file and print its corners and score; with a
    second path, save the image with a ring at each corner. The image is
    read and written on the host through cv2; detection runs on
    ``--device`` (default the card). The rings are the port's own
    anti-aliased ones (``core.imgutil.draw_circles``, radius 6, one pixel
    wide), where the reference draws two-pixel rings through cv2."""
    import argparse
    import sys

    import cv2

    from camkifu_tpu_torch.core.imgutil import draw_circles

    ap = argparse.ArgumentParser(prog="bf_auto",
                                 description=_probe_main.__doc__)
    ap.add_argument("image")
    ap.add_argument("overlay", nargs="?", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    img = cv2.imread(args.image)
    if img is None:
        sys.exit(f"cannot read image: {args.image}")
    frame = to_device(img[:, :, ::-1].copy(), args.device)
    det, score = detect_corners(frame)
    det = det.cpu().numpy()
    print("corners (tl,tr,br,bl):", det.round(1).tolist())
    print("score:", float(score))
    if args.overlay:
        drawn = draw_circles(frame.clone(), det, radius=6,
                             color=(255, 0, 0))
        cv2.imwrite(args.overlay, drawn.cpu().numpy()[:, :, ::-1])
        print("overlay saved:", args.overlay)
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(_probe_main())
