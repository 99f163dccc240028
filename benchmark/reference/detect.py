"""Plain PyTorch reference of batched board detection: the port's
``board.bf_auto.detect_batch`` at its defaults (detection at 256², the
refine canvases at 320²).

A frozen copy of the arithmetic the program runs, written out here so
that it imports nothing of the program and a later change to the program
cannot move it:

1. stage 1 for the whole batch: uint8 luma and an R−B chroma channel,
   both resized by the same separable weight matrices; each map's
   Gaussian blur, Sobel gradients and non-maximum suppression; the
   hysteresis at fractions of each map's 99.5th percentile of a
   2×-strided view; the union of the two normalized maps, the edge
   density and its clutter component (max-pool label propagation), the
   four corner top-k's and their medians, and the score from the density
   contrast and the Hough accumulator's peakedness;
2. the routes of stages 2–3: chunks of ``SHARED_CHUNK`` frames (or the
   whole batch) refined on one shared canvas each and validated; where a
   chunk fails, each of its frames through the per-frame refine (comb
   races, 2D lattice evidence, the sub-pixel pin, the saturated board's
   seeded races and evidence polish).

Departures from the program, each of which leaves the arithmetic as it
is: the edge and hysteresis kernels are their plain versions (the
kernels are bitwise those); the Hough votes are splatted as the program's
are and summed in float64 (the kernel adds in 64-bit fixed point, its
plain version in float32 one-hot sums), so a score may differ in its last
bits; the warp is ``scan.warp``'s
explicit taps; every route decision the program reads on the host
(``bool`` of a device scalar) is read the same way here. ``lowered`` (the
control) rounds the resized maps, the edge maps and every rectified
canvas to bfloat16 as they are made.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference.scan import _bf16, apply_homography, \
    homography_dlt, inv3, median_u8, rgb_to_gray, square, warp
from benchmark.reference.tracker import _conv1d, comb_quality, edge_pad, \
    prep_profile, snap_to_peaks, sobel, split_profiles

# -- the configuration the port states (``config/cvconf.py``, ``bf_auto``) ---
RES = 256
REFINE_RES = 320
HOUGH_TOPK = 4096
HOUGH_THETAS = 128
HOUGH_RHOS = 256
CLUTTER_COMP_KEEP = 0.30
DEROTATE_TRIP = float(np.deg2rad(0.7))
DEROTATE_MIN_CONC = 0.12
SHARED_REFINE_SPREAD = 0.55
SHARED_CHUNK = 8
MIN_SCORE = 0.1


#: Weight matrices made once per shape and device (``_cached``).
_MATRICES: dict = {}


def _same(x):
    return x


def _cached(make, *key):
    """``make(*key)``, made once per key."""
    if key not in _MATRICES:
        _MATRICES[key] = make(*key)
    return _MATRICES[key]


def _at(x: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    return x[i.reshape(1)][0]


def _f32(values, device) -> torch.Tensor:
    return torch.tensor(values, dtype=torch.float32, device=device)


def percentile(x: torch.Tensor, q: float, dim: int | None = None):
    if dim is None:
        x, dim = x.reshape(-1), 0
    return torch.quantile(x, q / 100.0, dim=dim, interpolation="linear")


# -- stage 1: the maps -------------------------------------------------------

def rgb_to_gray_u8(frame: torch.Tensor) -> torch.Tensor:
    return torch.clamp(rgb_to_gray(frame) + 0.5, 0.0, 255.0).to(torch.uint8)


def _resize_matrix(n_in: int, n_out: int, device) -> torch.Tensor:
    """(n_in, n_out) weights of an antialiased bilinear resize along one
    axis, each output sample's triangle widened by the downscale factor
    and normalized."""
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


def resize_bilinear(img: torch.Tensor, out_hw) -> torch.Tensor:
    h, w = img.shape[-2:]
    wh = _cached(_resize_matrix, h, out_hw[0], img.device)
    ww = _cached(_resize_matrix, w, out_hw[1], img.device)
    return wh.T @ img @ ww


def gaussian_blur(img: torch.Tensor, sigma: float = 1.4) -> torch.Tensor:
    radius = max(1, int(3.0 * sigma + 0.5))
    x = np.arange(-radius, radius + 1, dtype=np.float32)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    k = (k / k.sum()).astype(np.float32)
    return _conv1d(_conv1d(img, k, 0), k, 1)


def nms_magnitude(gx: torch.Tensor, gy: torch.Tensor) -> torch.Tensor:
    """Gradient magnitude kept where it is the largest of its two
    neighbours across the edge (4 sectors by ratio tests), neighbours
    wrapping at the border."""
    def shift(img, dy, dx):
        return torch.roll(img, shifts=(dy, dx), dims=(-2, -1))

    mag = torch.sqrt(gx * gx + gy * gy)
    t1, t2 = float(np.tan(np.pi / 8)), float(np.tan(3 * np.pi / 8))
    ax, ay = gx.abs(), gy.abs()
    sector = torch.where(
        ay < t1 * ax, 0,
        torch.where(ay > t2 * ax, 2, torch.where(gx * gy >= 0, 1, 3)))
    n1 = torch.stack([shift(mag, 0, 1), shift(mag, 1, 1),
                      shift(mag, 1, 0), shift(mag, 1, -1)])
    n2 = torch.stack([shift(mag, 0, -1), shift(mag, -1, -1),
                      shift(mag, -1, 0), shift(mag, -1, 1)])
    sel1 = torch.gather(n1, 0, sector[None])[0]
    sel2 = torch.gather(n2, 0, sector[None])[0]
    keep = (mag >= sel1) & (mag >= sel2)
    return torch.where(keep, mag, 0.0)


def hysteresis(mag: torch.Tensor, low, high, iters: int) -> torch.Tensor:
    strong = mag >= high
    weak = mag >= low
    reach = strong
    for _ in range(iters):
        dil = reach
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                if dy or dx:
                    dil = dil | torch.roll(reach, shifts=(dy, dx),
                                           dims=(-2, -1))
        reach = dil & weak
    return torch.where(reach | strong, mag, 0.0)


def edge_maps(grays: torch.Tensor, sigma: float = 1.4,
              low_frac: float = 0.15, high_frac: float = 0.4,
              iters: int = 4) -> torch.Tensor:
    """(N, H, W) maps in [0, 1] → NMS edge magnitudes after a hysteresis
    at fractions of each map's 99.5th percentile (of a 2×-strided view)."""
    gx, gy = sobel(gaussian_blur(grays, sigma))
    mags = nms_magnitude(gx, gy)
    n = mags.shape[0]
    ref = percentile(mags[:, ::2, ::2].reshape(n, -1), 99.5,
                     dim=1)[:, None, None]
    return hysteresis(mags, low_frac * ref, high_frac * ref, iters)


def box_blur(img: torch.Tensor, radius: int) -> torch.Tensor:
    def along(a, dim):
        c = torch.cumsum(a, dim=dim)
        n = a.shape[dim]
        cp = edge_pad(c, radius + 1, radius, dim)
        hi = cp.narrow(dim, 2 * radius + 1, n)
        lo = cp.narrow(dim, 0, n)
        return (hi - lo) / (2 * radius + 1)
    return along(along(img, img.ndim - 2), img.ndim - 1)


def top_k(x: torch.Tensor, k: int):
    """The k largest of the last axis, ties in index order."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def hough_accumulate(points: torch.Tensor, weights: torch.Tensor,
                     rho_max: float) -> torch.Tensor:
    """Points (B, K, 2) with weights (B, K) voted into (B, n_θ, n_ρ):
    ρ = x·cosθ + y·sinθ splatted bilinearly into the ρ bins, θ at
    (i + 0.5)·π/n_θ. The votes are summed in float64 and rounded once to
    float32, as exact as the kernel's 64-bit fixed point, in whatever
    order the adds land."""
    n_theta, n_rho = HOUGH_THETAS, HOUGH_RHOS
    b, k = weights.shape
    dev = points.device
    thetas = (torch.arange(n_theta, dtype=torch.float32, device=dev)
              + 0.5) * float(np.pi / n_theta)
    f32 = np.float32
    rho_scale = float(f32(n_rho - 1) / (f32(2.0) * f32(rho_max)))
    pos_hi = float(f32(n_rho - 1.001))
    rho = points[:, None, :, 0] * torch.cos(thetas)[None, :, None] \
        + points[:, None, :, 1] * torch.sin(thetas)[None, :, None]
    pos = torch.clamp((rho + rho_max) * rho_scale, 0.0, pos_hi)
    lo = torch.floor(pos)
    frac = pos - lo
    w = weights[:, None, :].to(torch.float64)
    row = (torch.arange(b * n_theta, device=dev) * n_rho).reshape(
        b, n_theta, 1)
    at = row + lo.to(torch.int64)                          # (B, n_θ, K)
    acc = torch.zeros(b * n_theta * n_rho, dtype=torch.float64, device=dev)
    acc.index_add_(0, at.reshape(-1), ((1.0 - frac) * w).reshape(-1))
    acc.index_add_(0, (at + 1).reshape(-1), (frac * w).reshape(-1))
    return acc.reshape(b, n_theta, n_rho).to(torch.float32)


def order_quad(pts_xy: torch.Tensor) -> torch.Tensor:
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


def coarse_from_mag(mag: torch.Tensor, mag_c: torch.Tensor):
    """Edge maps (B, res, res) of luma and chroma → (quads (B, 4, 2) in
    detection pixels, scores (B,))."""
    b, res = mag.shape[0], mag.shape[-1]
    dev = mag.device

    def norm(m):
        ref = percentile(m[:, ::2, ::2].reshape(b, -1), 99.5, dim=1)
        return m / torch.clamp(ref, min=1e-6)[:, None, None]
    mag = torch.maximum(norm(mag), norm(mag_c))
    density = box_blur((mag > 0).to(torch.float32), radius=7)
    mask = density > 0.06

    # The clutter component: max-pool label propagation on the eroded
    # core at half resolution, the components' sizes, the largest kept.
    core = box_blur(mask.to(torch.float32), 2) > 0.999
    h2 = res // 2
    n_ids = h2 * h2 + 1
    core2 = core[:, :h2 * 2, :h2 * 2].reshape(b, h2, 2, h2, 2) \
        .all(dim=4).all(dim=2)
    idx0 = torch.arange(1, n_ids, dtype=torch.float32,
                        device=dev).reshape(h2, h2)
    ids = torch.where(core2, idx0, 0.0)[:, None]
    for _ in range(2 * h2):
        ids = torch.where(core2[:, None],
                          F.max_pool2d(ids, 5, stride=1, padding=2), 0.0)
    ids = ids[:, 0].to(torch.int64).reshape(b, -1)
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
    comp = (box_blur(comp.to(torch.float32), 3) > 1e-6) & mask
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
        _, idx = top_k(p, k)
        return torch.stack([torch.median(xs_flat[idx], dim=1).values,
                            torch.median(ys_flat[idx], dim=1).values], -1)

    quad = order_quad(torch.stack([
        corner(-(xs + ys)), corner(xs - ys), corner(xs + ys),
        corner(ys - xs)], dim=1))

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
    w = mag.shape[-1]
    vals, idx = top_k(mag.reshape(b, -1), HOUGH_TOPK)
    pts = torch.stack([(idx % w).to(torch.float32),
                       (idx // w).to(torch.float32)], dim=-1)
    wts = (vals > 0).to(torch.float32) * torch.sqrt(vals.clamp(min=0.0))
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


def prepare(frames: torch.Tensor, low=_same):
    """Stage 1: (B, H, W, 3) → (grays u8 (B, H, W), quads (B, 4, 2) in
    frame pixels, scores (B,))."""
    h, w = frames.shape[1], frames.shape[2]
    b = frames.shape[0]
    grays = rgb_to_gray_u8(frames)
    fscale = 1.0 / 255.0 if frames.dtype == torch.uint8 else 1.0
    smalls = low(resize_bilinear(grays.to(torch.float32) / 255.0,
                                 (RES, RES)))
    chromas = low(resize_bilinear(
        (frames[..., 0].to(torch.float32) - frames[..., 2].to(torch.float32))
        * fscale, (RES, RES)))
    mags = low(edge_maps(torch.cat([smalls, chromas.reshape(smalls.shape)])))
    quads, scores = coarse_from_mag(mags[:b], mags[b:])
    scale = _f32([(w - 1) / (RES - 1), (h - 1) / (RES - 1)], frames.device)
    return grays, quads * scale, scores


# -- stages 2–3: comb races, evidence and the pin ---------------------------

def _comb_matrices(n: int, gsize: int, n_offsets: int, n_spacings: int,
                   device):
    spacings = np.linspace(0.70 * n / gsize, 1.02 * n / (gsize - 1),
                           n_spacings, dtype=np.float32)
    offsets = np.linspace(0.0, 0.30 * n, n_offsets, dtype=np.float32)
    idx = np.arange(gsize, dtype=np.float32)
    mid = np.arange(gsize - 1, dtype=np.float32) + 0.5
    pos = offsets[:, None, None] + spacings[None, :, None] * idx
    gaps = offsets[:, None, None] + spacings[None, :, None] * mid
    valid = pos[..., -1] <= n - 1.0

    def interp_matrix(positions, teeth):
        flat = np.clip(positions.reshape(-1, teeth), 0.0, n - 1.001)
        bins = np.arange(n, dtype=np.float32)
        w = np.maximum(0.0, 1.0 - np.abs(bins - flat[..., None]))
        return w.mean(axis=1).astype(np.float32)

    return tuple(torch.as_tensor(a, device=device) for a in (
        offsets, spacings, interp_matrix(pos, gsize),
        interp_matrix(gaps, gsize - 1), valid))


def comb_scores(profile: torch.Tensor, gsize: int, n_offsets: int = 64,
                n_spacings: int = 48):
    offsets, spacings, a_teeth, a_gaps, valid = _cached(
        _comb_matrices, profile.shape[0], gsize, n_offsets, n_spacings,
        profile.device)
    teeth_score = (a_teeth @ profile).reshape(n_offsets, n_spacings)
    gap_score = (a_gaps @ profile).reshape(n_offsets, n_spacings)
    return offsets, spacings, teeth_score, gap_score, valid


def snap_teeth(profile: torch.Tensor, o, s, gsize: int):
    idx = torch.arange(gsize, dtype=torch.float32, device=profile.device)
    snapped, b0 = snap_to_peaks(profile, o + s * idx, s, n_off=21)
    w = torch.clamp(b0, min=1e-6)
    sw = w.sum()
    mi = (w * idx).sum() / sw
    mp = (w * snapped).sum() / sw
    var = (w * (idx - mi) ** 2).sum()
    s2 = (w * (idx - mi) * (snapped - mp)).sum() / torch.clamp(var, min=1e-9)
    o2 = mp - s2 * mi
    ok = (torch.abs(s2 - s) < 0.2 * s) & (torch.abs(o2 - o) < 0.5 * s)
    return torch.where(ok, o2, o), torch.where(ok, s2, s)


def snap_quadratic(profile: torch.Tensor, o, s, gsize: int):
    idx = torch.arange(gsize, dtype=torch.float32, device=profile.device)
    snapped, b0 = snap_to_peaks(profile, o + s * idx, s, n_off=21)
    w = torch.clamp(b0, min=1e-6)
    ic = idx - (gsize - 1) / 2.0
    X = torch.stack([torch.ones_like(ic), ic, ic * ic], dim=-1)

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


def rect_H(quad: torch.Tensor, margin: float, res: int) -> torch.Tensor:
    ctr = quad.mean(dim=0)
    equad = ctr + (quad - ctr) * (1.0 + margin)
    return homography_dlt(square(0.0, res - 1.0, quad.device), equad)


def sample_rect(gray: torch.Tensor, H: torch.Tensor, res: int,
                low=_same) -> torch.Tensor:
    scale = 1.0 / 255.0 if gray.dtype == torch.uint8 else 1.0
    return low(warp(gray[None, :, :, None], H[None], (res, res),
                    scale)[0, :, :, 0])


def pin_corners_on_rect(rect: torch.Tensor, H: torch.Tensor,
                        quad: torch.Tensor, gsize: int):
    res = rect.shape[0]
    _, _, ct, cb, rl, rr = split_profiles(rect, gsize)
    rc = apply_homography(inv3(H), quad)
    ox = 0.5 * (rc[0, 0] + rc[3, 0])
    xh = 0.5 * (rc[1, 0] + rc[2, 0])
    oy = 0.5 * (rc[0, 1] + rc[1, 1])
    yh = 0.5 * (rc[2, 1] + rc[3, 1])
    sx = (xh - ox) / (gsize - 1)
    sy = (yh - oy) / (gsize - 1)
    x0t, x1t = snap_quadratic(ct, ox, sx, gsize)
    x0b, x1b = snap_quadratic(cb, ox, sx, gsize)
    y0l, y1l = snap_quadratic(rl, oy, sy, gsize)
    y0r, y1r = snap_quadratic(rr, oy, sy, gsize)

    h1, h2 = 0.3125 * res, 0.6875 * res
    span = h2 - h1
    y_top = 0.5 * (y0l + y0r)
    y_bot = 0.5 * (y1l + y1r)
    x_left = 0.5 * (x0t + x0b)
    x_right = 0.5 * (x1t + x1b)

    def at(v1, v2, pos):
        return v1 + (pos - h1) * (v2 - v1) / span

    def guard(v1, v2, pitch):
        bad = torch.abs(v2 - v1) > 0.5 * pitch
        m = 0.5 * (v1 + v2)
        return torch.where(bad, m, v1), torch.where(bad, m, v2)

    x0t, x0b = guard(x0t, x0b, sx)
    x1t, x1b = guard(x1t, x1b, sx)
    y0l, y0r = guard(y0l, y0r, sy)
    y1l, y1r = guard(y1l, y1r, sy)

    rc2 = torch.stack([
        torch.stack([at(x0t, x0b, y_top), at(y0l, y0r, x_left)]),
        torch.stack([at(x1t, x1b, y_top), at(y0l, y0r, x_right)]),
        torch.stack([at(x1t, x1b, y_bot), at(y1l, y1r, x_right)]),
        torch.stack([at(x0t, x0b, y_bot), at(y1l, y1r, x_left)]),
    ])
    return apply_homography(H, rc2)


def pin_corners(gray: torch.Tensor, quad: torch.Tensor, gsize: int,
                low=_same):
    H = rect_H(quad, 0.10, REFINE_RES)
    rect = sample_rect(gray, H, REFINE_RES, low)
    return pin_corners_on_rect(rect, H, quad, gsize)


def wood_deviation(rect: torch.Tensor) -> torch.Tensor:
    sub = rect[..., ::4, ::4]
    wood = median_u8(sub.reshape(*rect.shape[:-2], -1))
    return torch.abs(rect - wood[..., None, None])


def profiles_of(rect: torch.Tensor, gsize: int):
    """(col_profile, row_profile) of one canvas: gradient energy plus
    luma deviation from the wood level, each conditioned on its own."""
    res = rect.shape[0]
    gx, gy = sobel(rect)
    i0, i1 = res // 8, res - res // 8
    dev = wood_deviation(rect)
    col_profile = prep_profile(torch.abs(gx)[i0:i1, :].mean(dim=0), gsize) \
        + prep_profile(dev[i0:i1, :].mean(dim=0), gsize)
    row_profile = prep_profile(torch.abs(gy)[:, i0:i1].mean(dim=1), gsize) \
        + prep_profile(dev[:, i0:i1].mean(dim=1), gsize)
    return col_profile, row_profile


def rect_profiles_rect(gray: torch.Tensor, quad: torch.Tensor, gsize: int,
                       margin: float, low=_same):
    H = rect_H(quad, margin, REFINE_RES)
    rect = sample_rect(gray, H, REFINE_RES, low)
    col_profile, row_profile = profiles_of(rect, gsize)
    return H, col_profile, row_profile, rect


def comb_variants(H: torch.Tensor, col_profile: torch.Tensor,
                  row_profile: torch.Tensor, ox, sx, oy, sy, gsize: int):
    span = gsize - 1.0
    shifts = (-1.0, 0.0, 1.0)
    qxs = [comb_quality(col_profile, ox + d * sx, sx, gsize) for d in shifts]
    qys = [comb_quality(row_profile, oy + d * sy, sy, gsize) for d in shifts]
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


def fit_combs_multi(H: torch.Tensor, col_profile: torch.Tensor,
                    row_profile: torch.Tensor, gsize: int,
                    gap_weights=(1.0, 0.0)):
    grid_x = comb_scores(col_profile, gsize)
    grid_y = comb_scores(row_profile, gsize)
    var_corners = []
    for gw in gap_weights:
        def pick(grid):
            offsets, spacings, teeth, gap, valid = grid
            scores = torch.where(valid, teeth - gw * gap, float("-inf"))
            flat = torch.argmax(scores)
            n_sp = spacings.shape[0]
            return _at(offsets, flat // n_sp), _at(spacings, flat % n_sp)
        ox, sx = pick(grid_x)
        oy, sy = pick(grid_y)
        ox, sx = snap_teeth(col_profile, ox, sx, gsize)
        oy, sy = snap_teeth(row_profile, oy, sy, gsize)
        vc, _ = comb_variants(H, col_profile, row_profile, ox, sx, oy, sy,
                              gsize)
        var_corners.append(vc)
    return torch.cat(var_corners)


def side_insets(corners: torch.Tensor, slab: torch.Tensor) -> torch.Tensor:
    dists = []
    for i in range(4):
        p0 = slab[i]
        e = slab[(i + 1) % 4] - p0
        n = torch.stack([-e[1], e[0]])
        n = n / torch.clamp(torch.linalg.vector_norm(n), min=1e-6)
        dists.append(((corners - p0) @ n).min(dim=-1).values)
    return torch.stack(dists, dim=-1)


def evidence_map(rect: torch.Tensor, gsize: int) -> torch.Tensor:
    res = rect.shape[0]
    dev = wood_deviation(rect)
    gx, gy = sobel(rect)
    edge = torch.abs(gx) + torch.abs(gy)
    s_cell = res / (gsize + 1.0)
    r_in = max(1, int(s_cell * 0.18))
    r_out = max(r_in + 2, int(s_cell * 0.6))
    cs_dev = box_blur(dev, r_in) - box_blur(dev, r_out)
    cs_edge = box_blur(edge, r_in) - box_blur(edge, r_out)
    return (torch.clamp(cs_dev, min=0.0)
            / torch.clamp(torch.abs(cs_dev).max(), min=1e-9)
            + torch.clamp(cs_edge, min=0.0)
            / torch.clamp(torch.abs(cs_edge).max(), min=1e-9))


def grid_evidence_rc(E: torch.Tensor, rc: torch.Tensor,
                     grid: torch.Tensor) -> torch.Tensor:
    res = E.shape[0]
    unit = _f32([[0.0, 0.0], [1.0, 0.0], [1.0, 1.0], [0.0, 1.0]], E.device)
    P = apply_homography(homography_dlt(unit, rc), grid)
    px = torch.clamp(P[..., 0], 0.0, res - 1.001)
    py = torch.clamp(P[..., 1], 0.0, res - 1.001)
    x0f, y0f = torch.floor(px), torch.floor(py)
    fx, fy = px - x0f, py - y0f
    x0 = torch.nan_to_num(x0f, nan=0.0).long()
    y0 = torch.nan_to_num(y0f, nan=0.0).long()
    val = (E[y0, x0] * (1 - fx) * (1 - fy)
           + E[y0, x0 + 1] * fx * (1 - fy)
           + E[y0 + 1, x0] * (1 - fx) * fy
           + E[y0 + 1, x0 + 1] * fx * fy)
    ev = val.mean(dim=1)
    return torch.where(torch.isfinite(ev), ev, -1.0)


def lattice_evidence_rc(E: torch.Tensor, rc: torch.Tensor,
                        gsize: int) -> torch.Tensor:
    iu = torch.arange(gsize, dtype=torch.float32, device=E.device) \
        / (gsize - 1.0)
    gv, gu = torch.meshgrid(iu, iu, indexing="ij")
    grid = torch.stack([gu, gv], dim=-1).reshape(-1, 2)
    return grid_evidence_rc(E, rc, grid)


def evidence_polish(E: torch.Tensor, H: torch.Tensor, Hinv: torch.Tensor,
                    w: torch.Tensor, gsize: int,
                    spans=(0.45, 0.30, 0.15, 0.06), k: int = 5):
    rc = apply_homography(Hinv, w)
    cell = torch.linalg.vector_norm(rc[1] - rc[0]) / (gsize - 1.0)
    for span in spans:
        offs = torch.linspace(-span, span, k, device=E.device) * cell
        oi, oj = torch.meshgrid(offs, offs, indexing="ij")
        dxy = torch.stack([oi, oj], dim=-1).reshape(-1, 2)
        for i in range(4):
            cands = rc.expand(k * k, 4, 2).clone()
            cands[:, i] += dxy
            ev = lattice_evidence_rc(E, cands, gsize)
            rc = _at(cands, torch.argmax(ev))
    return apply_homography(H, rc)


def rank_evidence(cands: torch.Tensor, E: torch.Tensor, Hinv: torch.Tensor,
                  quad: torch.Tensor, cell, gsize: int) -> torch.Tensor:
    ev = lattice_evidence_rc(E, apply_homography(Hinv, cands), gsize)
    insets = side_insets(cands, quad).min(dim=-1).values
    rc = apply_homography(Hinv, cands)
    rslab = apply_homography(Hinv, quad)
    side = side_insets(rc, rslab)
    rcell = torch.linalg.vector_norm(rc[:, 1] - rc[:, 0], dim=1) \
        / (gsize - 1.0)
    asym = (torch.abs(side[:, 0] - side[:, 2])
            + torch.abs(side[:, 1] - side[:, 3])) \
        / torch.clamp(rcell, min=1e-3)
    return ev + torch.clamp(insets / cell - 0.25, max=0.0) \
        - 0.8 * torch.square(torch.clamp(asym - 0.6, min=0.0))


def resid_rotation(rect: torch.Tensor):
    gx = (rect[:, 2:] - rect[:, :-2])[1:-1, :]
    gy = (rect[2:, :] - rect[:-2, :])[:, 1:-1]
    m2 = gx * gx + gy * gy
    w = torch.minimum(m2, percentile(m2[::2, ::2], 99.0))
    phi4 = 4.0 * torch.atan2(gy, gx)
    s = (w * torch.sin(phi4)).sum()
    c = (w * torch.cos(phi4)).sum()
    conc = torch.sqrt(s * s + c * c) / torch.clamp(w.sum(), min=1e-9)
    return torch.atan2(s, c) / 4.0, conc


def refine_one(gray: torch.Tensor, quad: torch.Tensor, score, gsize: int,
               low=_same, refine_iters: int = 1):
    """The per-frame refine: de-rotation, the comb race ranked by 2D
    evidence and the pin (line-dominated boards, score > 0.55), else the
    seeded races and two evidence polishes. Two route tests read a device
    scalar on the host, as the program's do."""
    gap_weights = (1.0, 0.0)
    H, colp, rowp, rect = rect_profiles_rect(gray, quad, gsize, 0.10, low)
    raw_delta, conc = resid_rotation(rect)
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
        H, colp, rowp, rect = rect_profiles_rect(gray, quad, gsize, 0.10,
                                                 low)

    cell = torch.linalg.vector_norm(quad[1] - quad[0]) / (gsize + 0.0)
    vc1 = fit_combs_multi(H, colp, rowp, gsize, gap_weights)
    E = evidence_map(rect, gsize)
    Hinv = torch.linalg.inv_ex(H).inverse
    rank1 = rank_evidence(vc1, E, Hinv, quad, cell, gsize)
    w1 = _at(vc1, torch.argmax(rank1))
    pin1 = pin_corners(gray, w1, gsize, low)
    if bool(score > 0.55):
        return pin1.to(torch.float32)

    cands, ranks, w = vc1, rank1, w1
    for _ in range(max(refine_iters, 1)):
        H2, c2, r2, _ = rect_profiles_rect(gray, w, gsize, 0.10, low)
        vc2 = fit_combs_multi(H2, c2, r2, gsize, gap_weights)
        cands = torch.cat([cands, vc2])
        ranks = torch.cat(
            [ranks, rank_evidence(vc2, E, Hinv, quad, cell, gsize)])
        w = _at(cands, torch.argmax(ranks))
    pins = torch.stack([pin1, pin_corners(gray, w, gsize, low)])
    cands = torch.cat([cands, pins])
    ranks = torch.cat(
        [ranks, rank_evidence(pins, E, Hinv, quad, cell, gsize)])
    for _ in range(2):
        w3 = _at(cands, torch.argmax(ranks))
        pol = evidence_polish(E, H, Hinv, w3, gsize)[None]
        cands = torch.cat([cands, pol])
        ranks = torch.cat(
            [ranks, rank_evidence(pol, E, Hinv, quad, cell, gsize)])
    return _at(cands, torch.argmax(ranks)).to(torch.float32)


# -- the routes ---------------------------------------------------------------

def refine_shared(grays: torch.Tensor, shared_quad: torch.Tensor,
                  quads: torch.Tensor, gsize: int, low=_same):
    """The line-dominated refine of a chunk on one canvas shared by its
    frames, each frame measured on its own rectification → (corners
    (B, 4, 2), derotate deltas (B,), concentrations (B,))."""
    H = rect_H(shared_quad, 0.10, REFINE_RES)
    scale = 1.0 / 255.0 if grays.dtype == torch.uint8 else 1.0
    b = grays.shape[0]
    rects = low(warp(grays[..., None], H[None].expand(b, 3, 3).contiguous(),
                     (REFINE_RES, REFINE_RES), scale)[..., 0])
    Hinv = torch.linalg.inv_ex(H).inverse
    corners, deltas, concs = [], [], []
    for rect, quad in zip(rects, quads):
        colp, rowp = profiles_of(rect, gsize)
        vc1 = fit_combs_multi(H, colp, rowp, gsize, (1.0, 0.0))
        E = evidence_map(rect, gsize)
        cell = torch.linalg.vector_norm(quad[1] - quad[0]) / (gsize + 0.0)
        rank1 = rank_evidence(vc1, E, Hinv, quad, cell, gsize)
        w1 = _at(vc1, torch.argmax(rank1))
        corners.append(pin_corners_on_rect(rect, H, w1, gsize))
        delta, conc = resid_rotation(rect)
        deltas.append(delta)
        concs.append(conc)
    return (torch.stack(corners).to(torch.float32), torch.stack(deltas),
            torch.stack(concs))


def shared_route(grays, quads, scores, gsize: int, low=_same):
    """One chunk's shared refine and its verdict, on the device: every
    frame line-dominated, the quads within ``SHARED_REFINE_SPREAD`` cells
    of their median, no derotate trip, finite corners."""
    med = torch.quantile(quads, 0.5, dim=0)
    cell = torch.linalg.vector_norm(med[1] - med[0]) / max(gsize - 1, 1)
    ok = torch.isfinite(quads).all() & (scores > 0.55).all() \
        & (cell > 1e-6) \
        & ((quads - med).abs().amax() <= SHARED_REFINE_SPREAD * cell)
    corners, deltas, concs = refine_shared(grays, med, quads, gsize, low)
    trip = ((torch.abs(deltas * (2.0 / 3.0)) > DEROTATE_TRIP)
            & (concs > DEROTATE_MIN_CONC)).any()
    ok = ok & ~trip & torch.isfinite(corners).all()
    return corners, ok


def detect_batch(frames: torch.Tensor, gsize: int = 19,
                 lowered: bool = False):
    """(B, H, W, 3) frames → (corners (B, 4, 2) float32, scores (B,)):
    stage 1 for the batch; with two frames or more each chunk on its
    shared canvas, the failed chunks' frames refined one by one (all of
    them where no chunk validated)."""
    low = _bf16 if lowered else _same
    grays, quads, scores = prepare(frames, low)
    b = frames.shape[0]
    if b >= 2:
        chunk = SHARED_CHUNK if b % SHARED_CHUNK == 0 else b
        routed = [shared_route(grays[lo:lo + chunk], quads[lo:lo + chunk],
                               scores[lo:lo + chunk], gsize, low)
                  for lo in range(0, b, chunk)]
        oks = torch.stack([ok for _, ok in routed]).cpu().numpy()
        if oks.any():
            out = []
            for c, (corners, ok) in enumerate(routed):
                out.append(corners if ok else torch.stack([
                    refine_one(grays[i], quads[i], scores[i], gsize, low)
                    for i in range(c * chunk, (c + 1) * chunk)]))
            return torch.cat(out), scores
    return torch.stack([refine_one(grays[i], quads[i], scores[i], gsize, low)
                        for i in range(b)]), scores


def redetect_seeds(detected: torch.Tensor, scores: torch.Tensor,
                   seeds: torch.Tensor) -> torch.Tensor:
    """Each stream's detected corners where they are finite and its score
    reaches ``MIN_SCORE``, else its carried seed."""
    ok = torch.isfinite(detected).all(dim=-1).all(dim=-1) \
        & (scores >= MIN_SCORE)
    return torch.where(ok[:, None, None], detected.to(seeds.dtype), seeds)
