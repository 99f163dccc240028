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
from camkifu_tpu_torch.ops.color import rgb_to_gray_u8
from camkifu_tpu_torch.ops.edges import edge_map_batch, percentile
from camkifu_tpu_torch.ops.filters import edge_pad, sobel
from camkifu_tpu_torch.ops.hough import hough_accumulate, top_k, \
    topk_edge_points
from camkifu_tpu_torch.ops.warp import _inv3, apply_homography, \
    homography_dlt, warp_frames
from camkifu_tpu_torch.ops.zones import median_u8

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


def _f32(values, device) -> torch.Tensor:
    return torch.tensor(values, dtype=torch.float32, device=device)


def _at(x: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """``x[i]`` for a 0-d index tensor without waiting for the device:
    indexing with a 0-d tensor reads it on the host, a 1-element index
    tensor does not."""
    return x[i.reshape(1)][0]


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


def _interp1d_hat(profile: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """Linear interpolation of a 1D profile at positions ``pos`` as a
    hat-weight contraction: Σ_b max(0, 1−|b−p|)·profile[b]."""
    n = profile.shape[0]
    p = torch.clamp(pos, 0.0, n - 1.001)
    bins = torch.arange(n, dtype=torch.float32, device=profile.device)
    w = torch.clamp(1.0 - torch.abs(bins - p[..., None]), min=0.0)
    return w @ profile


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


def _snap_to_peaks(profile: torch.Tensor, teeth: torch.Tensor, pitch,
                   n_off: int):
    """Move each expected tooth position to its sub-pixel profile peak
    within ±pitch/3 → (snapped positions (g,), peak strengths (g,))."""
    offs = torch.linspace(-1.0, 1.0, n_off, device=profile.device) \
        * (pitch / 3.0)
    win = _interp1d_hat(profile, teeth[:, None] + offs[None, :])  # (g, n_off)
    best = torch.argmax(win, dim=1)
    gi = torch.arange(teeth.shape[0], device=profile.device)
    bm1 = win[gi, torch.clamp(best - 1, 0, n_off - 1)]
    bp1 = win[gi, torch.clamp(best + 1, 0, n_off - 1)]
    b0 = win[gi, best]
    den = bm1 - 2 * b0 + bp1
    delta = torch.where(torch.abs(den) > 1e-9, 0.5 * (bm1 - bp1) / den, 0.0)
    step = offs[1] - offs[0]
    snapped = teeth + offs[best] + torch.clamp(delta, -1.0, 1.0) * step
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
    profile window are disqualified."""
    n = profile.shape[0]
    idx = torch.arange(gsize, dtype=torch.float32, device=profile.device)
    mid = idx[:-1] + 0.5
    q = _interp1d_hat(profile, o + s * idx).mean() \
        - _interp1d_hat(profile, o + s * mid).mean()
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
    unit = _f32([[0.0, 0.0], [res - 1.0, 0.0], [res - 1.0, res - 1.0],
                 [0.0, res - 1.0]], quad.device)
    return homography_dlt(unit, equad)


def _sample_rect(gray: torch.Tensor, H: torch.Tensor,
                 res: int) -> torch.Tensor:
    """Rectify the (H, W) gray frame through ``H`` → (res, res) float32,
    in [0, 1] for uint8 gray. Runs the warp kernel on the card."""
    scale = 1.0 / 255.0 if gray.dtype == torch.uint8 else 1.0
    rect = warp_frames(gray[None, :, :, None], H, (res, res), scale)
    return rect[0, :, :, 0]


def _prep_profile(profile: torch.Tensor, gsize: int) -> torch.Tensor:
    """Condition a raw 1D energy profile into a normalized lattice signal:
    clip spikes at the 90th percentile, high-pass at the cell scale,
    max-normalize."""
    p = torch.minimum(profile, percentile(profile, 90))
    n = p.shape[0]
    r = max(2, n // (2 * gsize))
    c = torch.cumsum(edge_pad(p, r + 1, r, 0), dim=0)
    local_mean = (c[2 * r + 1:] - c[:n]) / (2 * r + 1)
    p = torch.clamp(p - local_mean, min=0.0)
    return p / torch.clamp(p.max(), min=1e-6)


def _wood_deviation(rect: torch.Tensor) -> torch.Tensor:
    """|rect − wood level|, the wood level being the radix-select median of
    a 4×-subsampled view."""
    wood = median_u8(rect[::4, ::4].reshape(1, -1))[0]
    return torch.abs(rect - wood)


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
    """Full + half-split lattice profiles: (col_full, row_full, col_top,
    col_bot, row_left, row_right)."""
    res = rect.shape[0]
    gx, gy = sobel(rect)
    i0, i1, mid = res // 8, res - res // 8, res // 2
    dev = _wood_deviation(rect)
    agx, agy = torch.abs(gx), torch.abs(gy)

    def colp(a, b):
        return _prep_profile(agx[a:b, :].mean(dim=0), gsize) \
            + _prep_profile(dev[a:b, :].mean(dim=0), gsize)

    def rowp(a, b):
        return _prep_profile(agy[:, a:b].mean(dim=1), gsize) \
            + _prep_profile(dev[:, a:b].mean(dim=1), gsize)

    return (colp(i0, i1), rowp(i0, i1), colp(i0, mid), colp(mid, i1),
            rowp(i0, mid), rowp(mid, i1))


def _fit_combs_multi(H: torch.Tensor, col_profile: torch.Tensor,
                     row_profile: torch.Tensor, gsize: int,
                     gap_weights=(1.0, 0.0)):
    """Comb-fit both axes under several gap-weight scorings in one pass →
    (seeds (G, 4, 2), variant corners (G*9, 4, 2), variant qualities
    (G*9,)); the 9 variants per scoring are the ±1-tooth-shifted basins."""
    grid_x = _comb_scores(col_profile, gsize)
    grid_y = _comb_scores(row_profile, gsize)
    span = gsize - 1.0
    shifts = (-1.0, 0.0, 1.0)
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
        qxs = [_comb_quality(col_profile, ox + d * sx, sx, gsize)
               for d in shifts]
        qys = [_comb_quality(row_profile, oy + d * sy, sy, gsize)
               for d in shifts]
        for i, dx in enumerate(shifts):
            for j, dy in enumerate(shifts):
                x0, y0 = ox + dx * sx, oy + dy * sy
                x1, y1 = x0 + span * sx, y0 + span * sy
                rc = torch.stack([torch.stack([x0, y0]),
                                  torch.stack([x1, y0]),
                                  torch.stack([x1, y1]),
                                  torch.stack([x0, y1])])
                var_corners.append(apply_homography(H, rc))
                var_q.append(qxs[i] + qys[j])
        seeds.append(var_corners[-5])          # this scoring's (0, 0) comb
    return torch.stack(seeds), torch.stack(var_corners), torch.stack(var_q)


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
    matrices, their 2B edge maps are one edge-kernel launch on the card,
    and ``_coarse_from_mag`` takes every frame at once (one Hough launch).
    """
    b, h, w = frames.shape[0], frames.shape[1], frames.shape[2]
    grays = rgb_to_gray_u8(frames)
    fscale = 1.0 / 255.0 if frames.dtype == torch.uint8 else 1.0
    smalls = resize_bilinear(grays.to(torch.float32) / 255.0, (res, res))
    chromas = resize_bilinear(
        (frames[..., 0].to(torch.float32) - frames[..., 2].to(torch.float32))
        * fscale, (res, res))
    mags = edge_map_batch(torch.cat([smalls, chromas]))
    quads, scores = _coarse_from_mag(mags[:b], mags[b:])
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


def _shared_route_body(grays, quads, scores, gsize: int):
    """Shared-canvas refine + validity verdict for ONE chunk, all on the
    device: every frame line-dominated, the stage-1 quads within
    SHARED_REFINE_SPREAD cells of the chunk median, no derotate trip, and
    finite corners fold into one boolean."""
    # The median of an even count averages the two middle values, as
    # jnp.median does; torch.median would return the lower one.
    med = torch.quantile(quads, 0.5, dim=0)
    cell = torch.linalg.vector_norm(med[1] - med[0]) / max(gsize - 1, 1)
    ok = torch.isfinite(quads).all() & (scores > 0.55).all() \
        & (cell > 1e-6) \
        & ((quads - med).abs().amax() <= SHARED_REFINE_SPREAD * cell)
    corners, deltas, concs = _refine_shared_batch(grays, med, quads, gsize)
    trip = ((torch.abs(deltas * (2.0 / 3.0)) > DEROTATE_TRIP)
            & (concs > DEROTATE_MIN_CONC)).any()
    ok = ok & ~trip & torch.isfinite(corners).all()
    return corners, ok


def _chunked_route(grays, quads, scores, gsize: int, chunk: int):
    """The batch through per-chunk shared-canvas refines → (corners
    (B, 4, 2), verdicts (B // chunk,) bool), both left on the device. The
    reference's jitted entry points around it (``_route_and_refine_chunked``,
    ``_route_and_refine_shared`` for one chunk, and ``_detect_batch_fused``
    with stage 1 ahead of it) are this function here: eager PyTorch needs
    no separate entry point."""
    out = [_shared_route_body(grays[lo:lo + chunk], quads[lo:lo + chunk],
                              scores[lo:lo + chunk], gsize)
           for lo in range(0, grays.shape[0], chunk)]
    return (torch.cat([c for c, _ in out]),
            torch.stack([ok for _, ok in out]))


def _detect_batch_routed(grays, quads, scores, gsize: int):
    """Route a batch through per-chunk shared-canvas refines; None if every
    chunk fell back. One host wait: the verdict fetch."""
    b = grays.shape[0]
    if b < 2:
        return None
    chunk = SHARED_CHUNK if b % SHARED_CHUNK == 0 else b
    corners, oks = _chunked_route(grays, quads, scores, gsize, chunk)
    return _merge_routed(grays, quads, scores, corners, oks.cpu().numpy(),
                         chunk, gsize)


def _merge_routed(grays, quads, scores, corners, oks_host: np.ndarray,
                  chunk: int, gsize: int):
    """Shared-canvas chunks where the verdict holds, per-frame refines of
    the failed chunks (``_detect_refine``, the reference's ``_refine_one``);
    None when no chunk validated."""
    if not oks_host.any():
        return None
    if oks_host.all():
        return corners
    out = []
    for c, ok in enumerate(oks_host):
        lo, hi = c * chunk, (c + 1) * chunk
        if ok:
            out.append(corners[lo:hi])
        else:
            out.append(torch.stack([
                _detect_refine(grays[i], quads[i], scores[i], gsize)
                for i in range(lo, hi)]))
    return torch.cat(out)


def detect_batch(frames: torch.Tensor, res: int = cvconf.bf_resolution,
                 gsize: int = 19):
    """Per-frame detection over a batch (B, H, W, 3) → (corners (B, 4, 2),
    scores (B,)).

    Stage 1 runs batched; with two frames or more, each chunk of
    ``SHARED_CHUNK`` frames (or the whole batch where B is not a multiple)
    is refined on its own shared canvas and validated on the device. The
    host fetches the verdicts once; chunks that fail validation are
    refined frame by frame, as ``detect_corners`` refines.
    """
    grays, quads, scores = _detect_prepare_batch(frames, res)
    merged = _detect_batch_routed(grays, quads, scores, gsize)
    if merged is not None:
        return merged, scores
    corners = [_detect_refine(grays[i], quads[i], scores[i], gsize)
               for i in range(frames.shape[0])]
    return torch.stack(corners), scores


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
