"""Plain PyTorch reference of the fixed-camera stream path: rectification,
the two classifiers and the temporal vote scan.

A frozen copy of the arithmetic the port runs for
``parallel.mesh.multistream_read_meta`` (the warp's plain version, the
zone statistics, the contour and k-means classifiers, the motion gate,
the background and the vote scan), written out here so that it imports
nothing of the program and a later change to the program cannot move it.
Every sum runs in the order the program's plain versions take, in
float32; the rectification is explicit tap indexing, not a kernel.

Inputs are the benchmark's own: uint8 frames and each stream's corners.
Everything the program derives from them (homographies, canonical images,
zone statistics, the scan's state) is worked out again here.
"""

from __future__ import annotations

import math

import numpy as np
import torch

LUMA = (0.299, 0.587, 0.114)

# -- the vision configuration the port states (``config/cvconf.py``) --------
VOTE_WINDOW = 7
VOTE_THRESHOLD = 4
VOTE_MIN_CONF = 0.25
AGITATION_THRESHOLD = 0.012
BACKGROUND_EMA = 0.05
TRUST_EMA = 0.08
TRUST_PROMOTE = 0.9
BG_FACTOR = 4

# -- the classifiers' constants ---------------------------------------------
EMPTY, BLACK, WHITE = 0, 1, 2
MIN_CLUSTER_CONTRAST = 0.15
INIT_CONTRAST = (-0.35, 0.0, 0.35)
KMEANS_ITERS = 8
PIXEL_CONTRAST = 0.13
MIN_DISC_FILL = 0.60
MAX_RING_FILL = 0.85
RING_OK_FILL = 0.66


def rgb_to_gray(frame: torch.Tensor) -> torch.Tensor:
    f = frame.to(torch.float32)
    return (f[..., 0] * LUMA[0] + f[..., 1] * LUMA[1]) + f[..., 2] * LUMA[2]


# -- homographies and the warp ------------------------------------------------

def square(lo: float, hi: float, device) -> torch.Tensor:
    return torch.tensor([[lo, lo], [hi, lo], [hi, hi], [lo, hi]],
                        dtype=torch.float32, device=device)


def canonical_corners(gsize: int, zone: int, device) -> torch.Tensor:
    return square(zone / 2.0 - 0.5, gsize * zone - zone / 2.0 - 0.5, device)


def _normalizer(pts: torch.Tensor) -> torch.Tensor:
    mean = pts.mean(dim=-2)
    rms = torch.sqrt(torch.mean(
        torch.sum((pts - mean[..., None, :]) ** 2, dim=-1), dim=-1))
    s = math.sqrt(2.0) / torch.clamp(rms, min=1e-6)
    zero = torch.zeros_like(s)
    one = torch.ones_like(s)
    return torch.stack([
        torch.stack([s, zero, -s * mean[..., 0]], dim=-1),
        torch.stack([zero, s, -s * mean[..., 1]], dim=-1),
        torch.stack([zero, zero, one], dim=-1)], dim=-2)


def inv3(M: torch.Tensor) -> torch.Tensor:
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    A = e * i - f * h
    B = c * h - b * i
    C = b * f - c * e
    D = f * g - d * i
    E = a * i - c * g
    F = c * d - a * f
    G = d * h - e * g
    H = b * g - a * h
    I = a * e - b * d
    det = a * A + b * D + c * G
    adj = torch.stack([torch.stack([A, B, C], dim=-1),
                       torch.stack([D, E, F], dim=-1),
                       torch.stack([G, H, I], dim=-1)], dim=-2)
    return adj / det[..., None, None]


def apply_homography(H: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    xy1 = torch.cat([pts, torch.ones_like(pts[..., :1])], dim=-1)
    out = xy1 @ H.transpose(-1, -2)
    return out[..., :2] / out[..., 2:3]


def homography_dlt(src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) H with dst ~ H @ src for 4 point pairs: Hartley
    normalization, the 8×8 system with h33 = 1 in float32."""
    src, dst = torch.broadcast_tensors(src.to(torch.float32),
                                       dst.to(torch.float32))
    t_src = _normalizer(src)
    t_dst = _normalizer(dst)
    src = apply_homography(t_src, src)
    dst = apply_homography(t_dst, dst)
    x, y = src[..., 0], src[..., 1]
    u, v = dst[..., 0], dst[..., 1]
    zeros = torch.zeros_like(x)
    ones = torch.ones_like(x)
    a_u = torch.stack([x, y, ones, zeros, zeros, zeros, -u * x, -u * y], -1)
    a_v = torch.stack([zeros, zeros, zeros, x, y, ones, -v * x, -v * y], -1)
    A = torch.cat([a_u, a_v], dim=-2)
    b = torch.cat([u, v], dim=-1)
    h = torch.linalg.solve_ex(A, b).result
    Hn = torch.cat([h, torch.ones_like(h[..., :1])], dim=-1)
    Hn = Hn.reshape(h.shape[:-1] + (3, 3))
    H = inv3(t_dst) @ Hn @ t_src
    return H / H[..., 2:3, 2:3]


def lens_fields(k1: torch.Tensor, frame_hw, like_ndim: int):
    """Each stream's radial lens (k1 (n,), its frame's centre and
    normalization) as float32 tensors shaped to meet points (n, ...)."""
    h, w = frame_hw
    s = min(h, w) / 2.0
    shape = k1.shape + (1,) * (like_ndim - k1.ndim)
    full = torch.stack([k1, torch.full_like(k1, w / 2.0),
                        torch.full_like(k1, h / 2.0), torch.full_like(k1, s),
                        torch.full_like(k1, s)], -1)
    return [f.reshape(shape) for f in full.unbind(-1)]


def distort_pts(lens, pts: torch.Tensor) -> torch.Tensor:
    """Pinhole → raw frame coordinates (..., 2) through ``lens``
    (``lens_fields``), or ``pts`` where there is none."""
    if lens is None:
        return pts
    k1, cx, cy, sx, sy = lens
    nx = (pts[..., 0] - cx) / sx
    ny = (pts[..., 1] - cy) / sy
    f = 1.0 + k1 * (nx * nx + ny * ny)
    return torch.stack([cx + nx * f * sx, cy + ny * f * sy], dim=-1)


def undistort_pts(lens, pts: torch.Tensor, iters: int = 8) -> torch.Tensor:
    """Raw frame → pinhole coordinates: Newton's method on the radius."""
    if lens is None:
        return pts
    k1, cx, cy, sx, sy = lens
    nx = (pts[..., 0] - cx) / sx
    ny = (pts[..., 1] - cy) / sy
    rd = torch.sqrt(nx * nx + ny * ny)
    r = rd
    for _ in range(iters):
        g = r * (1.0 + k1 * r * r) - rd
        dg = 1.0 + 3.0 * k1 * r * r
        dg = torch.where(torch.abs(dg) < 0.05,
                         torch.sign(dg) * 0.05 + (dg == 0) * 0.05, dg)
        r = r - g / dg
    f = torch.where(rd > 1e-9, r / torch.clamp(rd, min=1e-9), 1.0)
    return torch.stack([cx + nx * f * sx, cy + ny * f * sy], dim=-1)


def bilinear_sample(img: torch.Tensor, x: torch.Tensor,
                    y: torch.Tensor) -> torch.Tensor:
    """Frames (B, H, W, C) sampled at x[b], y[b], clamped to the edge."""
    h, w = img.shape[-3], img.shape[-2]
    x = torch.clamp(x, 0.0, w - 1.0)
    y = torch.clamp(y, 0.0, h - 1.0)
    x0f = torch.floor(x)
    y0f = torch.floor(y)
    fx = (x - x0f)[..., None]
    fy = (y - y0f)[..., None]
    x0 = torch.nan_to_num(x0f, nan=0.0).long()
    y0 = torch.nan_to_num(y0f, nan=0.0).long()
    x1 = torch.clamp(x0 + 1, max=w - 1)
    y1 = torch.clamp(y0 + 1, max=h - 1)
    bi = (torch.arange(img.shape[0], device=img.device)
          .reshape(-1, *[1] * (x.ndim - 1)),)
    p00 = img[bi + (y0, x0)].to(torch.float32)
    p01 = img[bi + (y0, x1)].to(torch.float32)
    p10 = img[bi + (y1, x0)].to(torch.float32)
    p11 = img[bi + (y1, x1)].to(torch.float32)
    top = p00 * (1 - fx) + p01 * fx
    bot = p10 * (1 - fx) + p11 * fx
    return top * (1 - fy) + bot * fy


#: Frames warped in one block: the taps are float32 copies of the output.
WARP_BLOCK = 64


def warp(frames: torch.Tensor, hmats: torch.Tensor, out_hw, scale: float,
         lens_table=None) -> torch.Tensor:
    """(B, H, W, C) frames through (B, 3, 3) homographies (output (u, v) →
    frame (x, y)), bent through a lens a frame ((B, 5) rows of k1, cx, cy,
    sx, sy) if given → (B, OH, OW, C) float32 × ``scale``, in blocks of
    frames (every output pixel is computed on its own)."""
    oh, ow = out_hw
    dev = frames.device
    v = torch.arange(oh, dtype=torch.float32, device=dev)[:, None]
    u = torch.arange(ow, dtype=torch.float32, device=dev)[None, :]
    out = torch.empty((frames.shape[0], oh, ow, frames.shape[-1]),
                      dtype=torch.float32, device=dev)
    for i in range(0, frames.shape[0], WARP_BLOCK):
        j = min(i + WARP_BLOCK, frames.shape[0])
        H = hmats[i:j, :, :, None, None]
        den = H[:, 2, 0] * u + H[:, 2, 1] * v + H[:, 2, 2]
        x = (H[:, 0, 0] * u + H[:, 0, 1] * v + H[:, 0, 2]) / den
        y = (H[:, 1, 0] * u + H[:, 1, 1] * v + H[:, 1, 2]) / den
        if lens_table is not None:
            fields = [f[:, None, None] for f in lens_table[i:j].unbind(-1)]
            src = distort_pts(fields, torch.stack([x, y], -1))
            x, y = src[..., 0], src[..., 1]
        out[i:j] = bilinear_sample(frames[i:j], x, y) * scale
    return out


def rectify_fixed(frames: torch.Tensor, corners: torch.Tensor, gsize: int,
                  zone: int) -> torch.Tensor:
    """Frames (n, B, H, W, 3) uint8 of n fixed cameras with corners (n, 4,
    2) → canonical images (n·B, S, S, 3) in [0, 1]."""
    n, b = frames.shape[0], frames.shape[1]
    size = gsize * zone
    H = homography_dlt(canonical_corners(gsize, zone, corners.device),
                       corners.to(torch.float32))
    hmats = H[:, None].expand(n, b, 3, 3).reshape(n * b, 3, 3).contiguous()
    return warp(frames.reshape(n * b, *frames.shape[2:]), hmats,
                (size, size), 1.0 / 255.0)


# -- zone statistics ------------------------------------------------------------

def disc_mask(zone: int, radius_frac: float = 0.42) -> np.ndarray:
    r = np.arange(zone, dtype=np.float32) - (zone - 1) / 2.0
    yy, xx = np.meshgrid(r, r, indexing="ij")
    return (np.sqrt(yy ** 2 + xx ** 2) <= radius_frac * zone) \
        .astype(np.float32)


def bg_indices(gsize: int, zone: int, frac: float = 0.36) -> np.ndarray:
    """(g, g, n) zone-pixel indices of the background median: the four
    corner patches, each outward-facing one at the board's border swapped
    for its inward mirror."""
    r = np.arange(zone, dtype=np.float32) - (zone - 1) / 2.0
    far = np.abs(r) > frac * zone
    lo, hi = far & (r < 0), far & (r > 0)
    patch = {(sy, sx): np.nonzero((my[:, None] & mx[None, :]).reshape(-1))[0]
             for sy, my in ((0, lo), (1, hi)) for sx, mx in ((0, lo), (1, hi))}
    out = np.empty((gsize, gsize, 4 * len(patch[0, 0])), np.int32)
    for i in range(gsize):
        for j in range(gsize):
            picks = []
            for sy in (0, 1):
                for sx in (0, 1):
                    y = 1 if (sy == 0 and i == 0) else \
                        0 if (sy == 1 and i == gsize - 1) else sy
                    x = 1 if (sx == 0 and j == 0) else \
                        0 if (sx == 1 and j == gsize - 1) else sx
                    picks.append(patch[y, x])
            out[i, j] = np.concatenate(picks)
    return out


def median_u8(x: torch.Tensor) -> torch.Tensor:
    """Lower median of the last axis at uint8 resolution (a binary search
    over the 256 levels)."""
    k = x.shape[-1] // 2
    q = torch.clamp(x * 255.0, 0.0, 255.0).to(torch.int32)
    v = torch.zeros(x.shape[:-1], dtype=torch.int32, device=x.device)
    for bit in range(7, -1, -1):
        t = v + (1 << bit)
        cnt = torch.sum(q < t[..., None], dim=-1)
        v = torch.where(cnt <= k, t, v)
    return v.to(torch.float32) / 255.0


def grid_median3(x: torch.Tensor, grid_dim: int) -> torch.Tensor:
    """3×3 median over the (g, g) dims at ``grid_dim``, edge-padded."""
    g0, g1 = x.shape[grid_dim], x.shape[grid_dim + 1]
    xp = torch.cat([x.narrow(grid_dim, 0, 1), x,
                    x.narrow(grid_dim, g0 - 1, 1)], dim=grid_dim)
    xp = torch.cat([xp.narrow(grid_dim + 1, 0, 1), xp,
                    xp.narrow(grid_dim + 1, g1 - 1, 1)], dim=grid_dim + 1)
    stack = torch.stack([
        xp.narrow(grid_dim, di, g0).narrow(grid_dim + 1, dj, g1)
        for di in range(3) for dj in range(3)])
    return torch.median(stack, dim=0).values


def zone_stats(canonical: torch.Tensor, gsize: int, zone: int) -> dict:
    """Per-intersection statistics of canonical images (..., S, S, 3)."""
    lead = canonical.shape[:-3]
    gd = len(lead)
    c = canonical.shape[-1]
    zones = canonical.reshape(*lead, gsize, zone, gsize, zone, c) \
        .transpose(-4, -3)
    dev = canonical.device
    mask_np = disc_mask(zone)
    mask = torch.as_tensor(mask_np, device=dev)
    bg_idx = torch.as_tensor(bg_indices(gsize, zone), dtype=torch.long,
                             device=dev)
    disc_idx = torch.as_tensor(np.nonzero(mask_np.reshape(-1) > 0.5)[0],
                               device=dev)
    inv = 1.0 / max(float(mask_np.sum()), 1.0)
    flat = zones.reshape(*lead, gsize, gsize, zone * zone, c)
    luma = rgb_to_gray(zones)
    luma_flat = luma.reshape(*lead, gsize, gsize, zone * zone)
    idx = bg_idx.expand(*lead, *bg_idx.shape)
    bg_px = torch.gather(flat, -2, idx[..., None].expand(*idx.shape, c))
    bg_luma = torch.gather(luma_flat, -1, idx)
    return {
        "zones": zones,
        "disc_mean_rgb": torch.einsum("...ghyxc,yx->...ghc", zones, mask)
        * inv,
        "bg_rgb": grid_median3(median_u8(bg_px.transpose(-1, -2)), gd),
        "bg_luma": grid_median3(median_u8(bg_luma), gd),
        "disc_med_luma": median_u8(luma_flat[..., disc_idx]),
        "disc_med_rgb": median_u8(flat[..., disc_idx, :].transpose(-1, -2)),
    }


# -- the classifiers ------------------------------------------------------------

def kmeans(x: torch.Tensor, init: torch.Tensor, k: int, iters: int):
    """Lloyd k-means on x (..., N, F) from ``init`` (k, F) → (centroids,
    labels int32); ties go to the lower cluster."""
    x = x.to(torch.float32)
    c = init.expand(*x.shape[:-2], k, x.shape[-1])

    def dists(cents):
        return torch.sum((x[..., :, None, :] - cents[..., None, :, :]) ** 2,
                         dim=-1)

    ks = torch.arange(k, device=x.device)
    for _ in range(iters):
        assign = (torch.argmin(dists(c), dim=-1)[..., None] == ks) \
            .to(torch.float32)
        counts = assign.sum(dim=-2)
        sums = assign.transpose(-1, -2) @ x
        new = sums / torch.clamp(counts[..., None], min=1e-6)
        c = torch.where(counts[..., None] > 0.5, new, c)
    labels = torch.argmin(dists(c), dim=-1).to(torch.int32)
    return c, labels


def classify_clustering(stats: dict):
    """Whole-board k-means of the local contrast → (labels int8, conf)."""
    contrast = stats["disc_mean_rgb"] - stats["bg_rgb"]
    g = contrast.shape[-2]
    lead = contrast.shape[:-3]
    contrast = contrast.reshape(*lead, g * g, 3)
    dev = contrast.device
    init = torch.tensor([[c, c, c] for c in INIT_CONTRAST],
                        dtype=torch.float32, device=dev)
    luma = torch.tensor(LUMA, dtype=torch.float32, device=dev)
    rank_to_label = torch.tensor([BLACK, EMPTY, WHITE], dtype=torch.int8,
                                 device=dev)
    cents, raw_labels = kmeans(contrast, init, 3, KMEANS_ITERS)
    raw = raw_labels.long()
    cluster_luma = cents @ luma
    rank = torch.argsort(torch.argsort(cluster_luma, dim=-1, stable=True),
                         dim=-1, stable=True)
    labels = rank_to_label[torch.gather(rank, -1, raw)]
    cluster_mag = torch.linalg.vector_norm(cents, dim=-1)
    member_strong = torch.gather(cluster_mag >= MIN_CLUSTER_CONTRAST, -1, raw)
    labels = torch.where(member_strong | (labels == EMPTY), labels,
                         torch.zeros_like(labels))
    mag = torch.linalg.vector_norm(contrast, dim=-1)
    conf_stone = torch.clamp((mag - MIN_CLUSTER_CONTRAST)
                             / (0.45 - MIN_CLUSTER_CONTRAST), 0.0, 1.0)
    conf_empty = torch.clamp(1.0 - mag / MIN_CLUSTER_CONTRAST, 0.0, 1.0)
    conf = torch.where(labels == EMPTY, conf_empty, conf_stone)
    return labels.reshape(*lead, g, g), conf.reshape(*lead, g, g)


def classify_contours(stats: dict, zone: int):
    """Disc fill against the ring, and the disc median's contrast →
    (labels int8, conf)."""
    dev = stats["zones"].device
    disc = torch.as_tensor(disc_mask(zone), device=dev)
    ring = 1.0 - disc
    disc_n = torch.clamp(disc.sum(), min=1.0)
    ring_n = torch.clamp(ring.sum(), min=1.0)
    med_diff = stats["disc_med_luma"] - stats["bg_luma"]
    med_mag = torch.abs(stats["disc_med_rgb"] - stats["bg_rgb"]).amax(dim=-1)
    diff = stats["zones"] - stats["bg_rgb"][..., None, None, :]
    active = (torch.abs(diff).amax(dim=-1) > PIXEL_CONTRAST) \
        .to(torch.float32)
    disc_fill = torch.einsum("...ghyx,yx->...gh", active, disc) / disc_n
    ring_fill = torch.einsum("...ghyx,yx->...gh", active, ring) / ring_n
    is_stone = (disc_fill > MIN_DISC_FILL) & (ring_fill < MAX_RING_FILL) \
        & (med_mag > PIXEL_CONTRAST)
    color = torch.where(med_diff < 0, BLACK, WHITE).to(torch.int8)
    labels = torch.where(is_stone, color, EMPTY).to(torch.int8)
    conf_stone = torch.clamp((disc_fill - MIN_DISC_FILL) / (1 - MIN_DISC_FILL),
                             0, 1) \
        * torch.clamp((MAX_RING_FILL - ring_fill)
                      / (MAX_RING_FILL - RING_OK_FILL), 0, 1)
    conf_empty = torch.clamp(1.0 - disc_fill / MIN_DISC_FILL, 0, 1)
    return labels, torch.where(is_stone, conf_stone, conf_empty)


# -- motion, background, votes ------------------------------------------------

def downsample_luma(luma: torch.Tensor, factor: int) -> torch.Tensor:
    s = luma.shape[-1]
    d = s // factor
    lead = luma.shape[:-2]
    return luma[..., :d * factor, :d * factor] \
        .reshape(*lead, d, factor, d, factor).mean(dim=(-3, -1))


def robust_gain(x: torch.Tensor, ref: torch.Tensor, lo: float = 0.7,
                hi: float = 1.4, nbins: int = 128,
                floor: float = 0.05) -> torch.Tensor:
    """Histogram median of the pixel ratio x/ref, one per leading index;
    bin edges lo·(1 − t) + hi·t in float32."""
    lead = x.shape[:-2]
    r = torch.clamp(x / torch.clamp(ref, min=floor), lo, hi) \
        .reshape(*lead, 1, -1)
    f32 = np.float32
    t = np.arange(nbins, dtype=f32) / f32(nbins)
    edges = torch.as_tensor(
        np.append(f32(lo) * (f32(1) - t) + f32(hi) * t, f32(hi))
        .astype(f32), device=x.device)
    hist = ((r >= edges[:-1, None]) & (r < edges[1:, None])).sum(dim=-1)
    hist[..., -1] += (r >= hi).sum(dim=(-2, -1))
    half = 0.5 * r.shape[-1]
    med_bin = torch.argmax((torch.cumsum(hist, dim=-1) >= half)
                           .to(torch.uint8), dim=-1)
    centers = 0.5 * (edges[:-1] + edges[1:])
    return torch.take(centers, med_bin)


def _zone_mean(x: torch.Tensor, gsize: int) -> torch.Tensor:
    f = x.shape[-1] // gsize
    lead = x.shape[:-2]
    return x[..., :gsize * f, :gsize * f] \
        .reshape(*lead, gsize, f, gsize, f).mean(dim=(-3, -1))


def zone_motion_gate(luma_small: torch.Tensor, prev: torch.Tensor,
                     gsize: int, flow_thresh: float = 1.0,
                     grad_floor: float = 0.02):
    gain = robust_gain(luma_small, prev)[..., None, None]
    dt = torch.abs(luma_small - gain * prev)
    gx = 0.5 * (torch.roll(luma_small, -1, -1) - torch.roll(luma_small, 1, -1))
    gy = 0.5 * (torch.roll(luma_small, -1, -2) - torch.roll(luma_small, 1, -2))
    grad = torch.sqrt(gx * gx + gy * gy)
    flow = dt / (grad + grad_floor)
    zone_flow = _zone_mean(flow, gsize)
    zone_dt = _zone_mean(dt, gsize)
    zone_grad = _zone_mean(grad, gsize)
    flat_occluded = zone_dt > torch.clamp(2.0 * zone_grad, min=0.06)
    calm = (zone_flow <= flow_thresh) & ~flat_occluded
    agitation = 1.0 - calm.to(torch.float32).mean(dim=(-2, -1))
    return calm.to(torch.float32), agitation


def vote_update(votes, stable, labels, conf, zone_calm):
    decay = 1.0 - 1.0 / VOTE_WINDOW
    onehot = (labels[..., None].to(torch.int64)
              == torch.arange(3, device=labels.device)).to(torch.float32)
    casts = (conf >= VOTE_MIN_CONF).to(torch.float32)
    new_votes = votes * decay + onehot * casts[..., None] \
        * zone_calm[..., None]
    top = new_votes.amax(dim=-1)
    top_label = torch.argmax(new_votes, dim=-1).to(torch.int8)
    runner = torch.sort(new_votes, dim=-1).values[..., 1]
    commit = (top >= VOTE_THRESHOLD) & (top >= 2.0 * runner)
    new_stable = torch.where(commit, top_label, stable)
    out_conf = torch.clamp(top / VOTE_WINDOW, 0.0, 1.0)
    return new_votes, new_stable, out_conf


def update_background(bg, luma_small, agitation):
    rate = torch.where(agitation > AGITATION_THRESHOLD, 0.1 * BACKGROUND_EMA,
                       BACKGROUND_EMA)[..., None, None]
    return bg * (1.0 - rate) + luma_small * rate


def init_states(n: int, gsize: int, zone: int, device) -> dict:
    """Fresh scan states of n streams."""
    s = gsize * zone // BG_FACTOR
    f32 = dict(dtype=torch.float32, device=device)
    return {"votes": torch.zeros((n, gsize, gsize, 3), **f32),
            "stable": torch.zeros((n, gsize, gsize), dtype=torch.int8,
                                  device=device),
            "bg": torch.full((n, s, s), -1.0, **f32),
            "prev": torch.full((n, s, s), -1.0, **f32),
            "trust": torch.zeros((n, 3, 3), **f32),
            "frame_count": torch.zeros((n,), dtype=torch.int32,
                                       device=device)}


def _regions(gsize: int, device):
    thirds = np.minimum(np.arange(gsize) * 3 // gsize, 2)
    region = (thirds[:, None] * 3 + thirds[None, :]).reshape(-1)
    counts = np.bincount(region, minlength=9).astype(np.float32)
    return (torch.as_tensor(region, dtype=torch.int64, device=device),
            torch.as_tensor(counts, device=device))


def _bf16(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to bfloat16 and back (the control's precision)."""
    return x.to(torch.bfloat16).to(x.dtype)


def scan(states: dict, canon: torch.Tensor, gsize: int, zone: int,
         lowered: bool = False):
    """Classifiers and the temporal vote scan over canonical frames (n, B,
    S, S, 3) of n streams → (states, labels (n, B, g, g) int8, conf (n, B,
    g, g), agitation (n, B)). ``lowered`` (the control): the canonical
    images, the classifiers' confidences, the small luma and every float
    the scan carries from frame to frame (votes, trust, background) are
    rounded to bfloat16 as they are made."""
    low = _bf16 if lowered else (lambda x: x)
    canon = low(canon)
    n, b = canon.shape[0], canon.shape[1]
    dev = canon.device
    flat = canon.reshape(n * b, *canon.shape[2:])
    luma_small = low(downsample_luma(rgb_to_gray(flat), BG_FACTOR))
    stats = zone_stats(flat, gsize, zone)
    lab_cont, conf_cont = classify_contours(stats, zone)
    lab_clus, conf_clus = classify_clustering(stats)
    conf_cont, conf_clus = low(conf_cont), low(conf_clus)
    del stats
    lab_cont, conf_cont, lab_clus, conf_clus = (
        x.reshape(n, b, gsize, gsize)
        for x in (lab_cont, conf_cont, lab_clus, conf_clus))
    lab_nn = torch.zeros_like(lab_cont)
    conf_nn = torch.full_like(conf_cont, -1.0)
    luma_small = luma_small.reshape(n, b, *luma_small.shape[1:])
    prev0 = torch.where(states["prev"][:, :1, :1] < 0, luma_small[:, 0],
                        states["prev"])
    prevs = torch.cat([prev0[:, None], luma_small[:, :-1]], dim=1)
    zone_calm, agitation = zone_motion_gate(luma_small, prevs, gsize)
    region, counts = _regions(gsize, dev)
    agree = (lab_cont == lab_clus).to(torch.float32).reshape(n, b, -1)
    region_agree = (torch.zeros((n, b, 9), dtype=torch.float32, device=dev)
                    .index_add_(2, region, agree) / counts) \
        .reshape(n, b, 3, 3)
    votes, stable, bg, trust = (states["votes"], states["stable"],
                                states["bg"], states["trust"])
    out_labels, out_conf = [], []
    for i in range(b):
        calm = (agitation[:, i] <= AGITATION_THRESHOLD)[:, None, None]
        trust = low(torch.where(
            calm, trust * (1 - TRUST_EMA) + region_agree[:, i] * TRUST_EMA,
            trust))
        trust_per = trust.reshape(n, 9)[:, region].reshape(n, gsize, gsize)
        ck_eff = torch.where(trust_per >= TRUST_PROMOTE, conf_clus[:, i],
                             -1.0)
        confs = torch.stack([conf_cont[:, i], ck_eff, conf_nn[:, i]])
        labs = torch.stack([lab_cont[:, i], lab_clus[:, i], lab_nn[:, i]])
        pick = torch.argmax(confs, dim=0, keepdim=True)
        labels = torch.gather(labs, 0, pick)[0]
        conf = torch.gather(confs, 0, pick)[0]
        votes, stable, new_conf = vote_update(votes, stable, labels, conf,
                                              zone_calm[:, i])
        votes, new_conf = low(votes), low(new_conf)
        bg = low(update_background(
            torch.where(bg[:, :1, :1] < 0, luma_small[:, i], bg),
            luma_small[:, i], agitation[:, i]))
        out_labels.append(stable)
        out_conf.append(new_conf)
    new_states = {"votes": votes, "stable": stable, "bg": bg,
                  "prev": luma_small[:, -1], "trust": trust,
                  "frame_count": states["frame_count"] + b}
    return new_states, torch.stack(out_labels, 1), \
        torch.stack(out_conf, 1), agitation
