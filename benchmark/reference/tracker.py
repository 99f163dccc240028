"""Plain PyTorch reference of the handheld stream path: per-frame board
tracking through each camera's lens, fused with rectification, then the
vote scan of ``scan.py``.

A frozen copy of the arithmetic the port runs for
``parallel.mesh.multistream_track_read`` (its ``rectify_track_streams``:
the lattice profiles, the correlation, the half-split teeth fits, the
absolute lattice lock, the canonical crop and the chunk hand-off), written
out here so that it imports nothing of the program. A batch starts from
the seeds it is given (each stream's first corners as the program found
them, or the program's seeds before a batch of the window: see
``checks.pairs``), the benchmark's uint8 frames and each camera's k1 (or
none), and works out every canvas, profile, fit and crop again.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from benchmark.reference.scan import apply_homography, distort_pts, \
    homography_dlt, lens_fields, median_u8, rgb_to_gray, square, \
    undistort_pts, warp

TRACK_WIN_OFFSET = 0.75
TRACK_MIN_SHARPNESS = 1.5
TRACK_REF_EMA = 0.15
TRACK_MAX_THETA = 0.12
TRACK_MAX_SIGMA = 0.08
TRACK_DIFF_AGREE = 0.015
TRACK_ABS_DEADBAND = 0.12
CHUNK = 16
PAD_CELLS = 1


def _col(v):
    return v[..., None] if isinstance(v, torch.Tensor) else v


def edge_pad(x: torch.Tensor, before: int, after: int,
             dim: int) -> torch.Tensor:
    moved = x.movedim(dim, -1)
    flat = moved.reshape(-1, 1, moved.shape[-1])
    padded = F.pad(flat, (before, after), mode="replicate")
    return padded.reshape(*moved.shape[:-1], -1).movedim(-1, dim)


def _conv1d(img: torch.Tensor, kernel, axis: int) -> torch.Tensor:
    r = (len(kernel) - 1) // 2
    img = img.to(torch.float32)
    dim = img.ndim - 2 + axis
    padded = edge_pad(img, r, r, dim)
    n = img.shape[dim]
    out = None
    for i, t in enumerate(kernel):
        sl = padded.narrow(dim, i, n)
        out = float(t) * sl if out is None else out + float(t) * sl
    return out


def sobel(img: torch.Tensor):
    smooth, diff = (1.0, 2.0, 1.0), (-1.0, 0.0, 1.0)
    gx = _conv1d(_conv1d(img, smooth, 0), diff, 1)
    gy = _conv1d(_conv1d(img, diff, 0), smooth, 1)
    return gx, gy


def interp1d_hat(profile: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """Σ_b max(0, 1−|b−p|)·profile[b], each profile (..., n) at its own
    positions (..., *rest)."""
    n = profile.shape[-1]
    p = torch.clamp(pos, 0.0, n - 1.001)
    bins = torch.arange(n, dtype=torch.float32, device=profile.device)
    w = torch.clamp(1.0 - torch.abs(bins - p[..., None]), min=0.0)
    if profile.ndim == 1:
        return w @ profile
    w = w.reshape(*profile.shape[:-1], -1, n)
    return (w @ profile[..., None])[..., 0].reshape(p.shape)


def prep_profile(profile: torch.Tensor, gsize: int) -> torch.Tensor:
    """Clip at the 90th percentile, high-pass at the cell scale,
    max-normalize, each profile (..., n) on its own."""
    p = torch.minimum(profile, torch.quantile(
        profile, 0.9, dim=-1, interpolation="linear")[..., None])
    n = p.shape[-1]
    r = max(2, n // (2 * gsize))
    c = torch.cumsum(edge_pad(p, r + 1, r, -1), dim=-1)
    local_mean = (c[..., 2 * r + 1:] - c[..., :n]) / (2 * r + 1)
    p = torch.clamp(p - local_mean, min=0.0)
    return p / torch.clamp(p.amax(dim=-1, keepdim=True), min=1e-6)


def split_profiles(rect: torch.Tensor, gsize: int):
    """(col_full, row_full, col_top, col_bot, row_left, row_right) of
    rectified images (..., res, res)."""
    res = rect.shape[-1]
    gx, gy = sobel(rect)
    i0, i1, mid = res // 8, res - res // 8, res // 2
    sub = rect[..., ::4, ::4]
    wood = median_u8(sub.reshape(*rect.shape[:-2], -1))
    dev = torch.abs(rect - wood[..., None, None])
    agx, agy = torch.abs(gx), torch.abs(gy)

    def colp(a, b):
        return [agx[..., a:b, :].mean(dim=-2), dev[..., a:b, :].mean(dim=-2)]

    def rowp(a, b):
        return [agy[..., :, a:b].mean(dim=-1), dev[..., :, a:b].mean(dim=-1)]

    raw = torch.stack(colp(i0, i1) + rowp(i0, i1) + colp(i0, mid)
                      + colp(mid, i1) + rowp(i0, mid) + rowp(mid, i1))
    p = prep_profile(raw, gsize)
    return tuple(p[0::2] + p[1::2])


def corr_shift(profiles: torch.Tensor, ref: torch.Tensor, S: int):
    """Per-frame sub-pixel translation of profiles (..., B, n) against
    (..., n), and the correlation peak's sharpness."""
    n = profiles.shape[-1]
    n_sh = 2 * S + 1
    shifted = F.pad(ref, (S, S)).unfold(-1, n, 1)
    corr = profiles @ shifted.transpose(-1, -2)
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


def hold_bad(d: torch.Tensor, ok: torch.Tensor) -> torch.Tensor:
    idx = torch.arange(d.shape[-1], device=d.device)
    last = torch.cummax(torch.where(ok, idx, -1), dim=-1).values
    return torch.where(last >= 0,
                       torch.gather(d, -1, torch.clamp(last, min=0)), 0.0)


def comb_quality(profile: torch.Tensor, o, s, gsize: int):
    n = profile.shape[-1]
    idx = torch.arange(gsize, dtype=torch.float32, device=profile.device)
    mid = idx[:-1] + 0.5
    q = interp1d_hat(profile, _col(o) + _col(s) * idx).mean(dim=-1) \
        - interp1d_hat(profile, _col(o) + _col(s) * mid).mean(dim=-1)
    out = (o < 0.0) | (o + s * (gsize - 1) > n - 1.0)
    return q - 10.0 * out


def lattice_offset(profile: torch.Tensor, first, pitch, gsize: int, S: int):
    n = profile.shape[-1]
    bins = torch.arange(n, dtype=torch.float32, device=profile.device)
    pos = _col(first) + pitch * torch.arange(gsize, dtype=torch.float32,
                                             device=profile.device)
    template = torch.clamp(
        1.0 - torch.abs(bins - pos[..., :, None]), min=0.0).sum(dim=-2)
    d, sh = corr_shift(profile[..., None, :], template, S)
    return d[..., 0], sh[..., 0]


def abs_lock_update(cols0, rows0, first_x, first_y, px, py, dx0, dy0, ok0,
                    e_lock, S: int, gsize: int):
    ex_m, sex = lattice_offset(cols0, first_x, px, gsize, S)
    ey_m, sey = lattice_offset(rows0, first_y, py, gsize, S)
    qx_with = comb_quality(cols0, first_x + ex_m, px, gsize)
    qx_without = comb_quality(cols0, first_x + dx0 + e_lock[0], px, gsize)
    qy_with = comb_quality(rows0, first_y + ey_m, py, gsize)
    qy_without = comb_quality(rows0, first_y + dy0 + e_lock[1], py, gsize)
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


def snap_to_peaks(profile: torch.Tensor, teeth: torch.Tensor, pitch,
                  n_off: int):
    offs = torch.linspace(-1.0, 1.0, n_off, device=profile.device) \
        * _col(pitch / 3.0)
    win = interp1d_hat(profile, teeth[..., :, None] + offs[..., None, :])
    best = torch.argmax(win, dim=-1, keepdim=True)
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


def teeth_fit(profile: torch.Tensor, first, pitch, gsize: int):
    """Per-tooth peaks, then an IRLS line through them → (centre offset,
    pitch, ok)."""
    idx = torch.arange(gsize, dtype=torch.float32, device=profile.device)
    snapped, b0 = snap_to_peaks(profile, _col(first) + _col(pitch) * idx,
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


def half_geometry(rc: torch.Tensor, n: int, gsize: int):
    h1, h2 = 0.3125 * n, 0.6875 * n

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


def track_measure(cf, rf, ct, cb, rl, rr, ref_col, ref_row, S: int, geom,
                  gsize: int):
    """Per-frame similarity (tx, ty, θ, σ) about the canvas centre, with
    its gates."""
    n = ct.shape[-1]
    fx_t, fx_b, sx_t, sx_b, fy_l, fy_r, sy_l, sy_r = geom
    tx, shxf = corr_shift(cf, ref_col, S)
    ty, shyf = corr_shift(rf, ref_row, S)
    sharp = torch.minimum(shxf, shyf)
    ok = sharp >= TRACK_MIN_SHARPNESS
    firsts = torch.stack([fx_t + tx, fx_b + tx, fy_l + ty, fy_r + ty])
    pitches = torch.stack([sx_t, sx_b, sy_l, sy_r]) \
        .reshape((4,) + (1,) * tx.ndim)
    (a_t, a_b, a_l, a_r), (b_t, b_b, b_l, b_r), (k_t, k_b, k_l, k_r) = \
        teeth_fit(torch.stack([ct, cb, rl, rr]), firsts, pitches, gsize)
    lo = 0.375 * n
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
    dbx = TRACK_ABS_DEADBAND * 0.5 * (sx_t + sx_b)
    dby = TRACK_ABS_DEADBAND * 0.5 * (sy_l + sy_r)
    cx = 0.5 * (a_t + a_b)
    cy = 0.5 * (a_l + a_r)
    tx = torch.where(v1 & (torch.abs(cx) >= dbx), tx + cx, tx)
    ty = torch.where(v2 & (torch.abs(cy) >= dby), ty + cy, ty)
    theta = torch.clamp(theta, -TRACK_MAX_THETA, TRACK_MAX_THETA)
    sigma = torch.clamp(sigma, -TRACK_MAX_SIGMA, TRACK_MAX_SIGMA)
    return tx, ty, theta, sigma, sharp, ok, rot_ok, scl_ok


def apply_similarity(rc_pts: torch.Tensor, dx, dy, theta, sigma):
    c = rc_pts.mean(dim=0)
    v = rc_pts - c
    cosT, sinT = torch.cos(theta), torch.sin(theta)
    vv = torch.stack([_col(cosT) * v[:, 0] - _col(sinT) * v[:, 1],
                      _col(sinT) * v[:, 0] + _col(cosT) * v[:, 1]], -1) \
        * (1.0 + sigma)[..., None, None]
    return c + vv + torch.stack([dx, dy], -1)[..., None, :]


def align_quality(cols, rows, rc_seed, dx, dy, sigma, gsize: int):
    c = rc_seed.mean(dim=0)
    ox = c[0] + (rc_seed[0, 0] - c[0]) * (1.0 + sigma) + dx
    oy = c[1] + (rc_seed[0, 1] - c[1]) * (1.0 + sigma) + dy
    sx = (rc_seed[1, 0] - rc_seed[0, 0]) * (1.0 + sigma) / (gsize - 1)
    sy = (rc_seed[3, 1] - rc_seed[0, 1]) * (1.0 + sigma) / (gsize - 1)
    return comb_quality(cols, ox, sx, gsize) \
        + comb_quality(rows, oy, sy, gsize)


def shifted_crop(src: torch.Tensor, origin: torch.Tensor, size: int,
                 offset: torch.Tensor) -> torch.Tensor:
    """A ``size``² window of each image at its integer ``origin`` (B, 2),
    its content moved by −``offset`` (B, 2) through the four bilinear
    shifts that carry weight, the window's edge replicated."""
    dev = src.device
    bi = torch.arange(src.shape[0], device=dev)[:, None, None]
    p = 2.0 + torch.clamp(offset, -2.0, 1.999)
    k = torch.floor(p)[:, None, :] \
        + torch.arange(2, dtype=p.dtype, device=dev)[:, None]
    w = torch.where(k <= 3.0,
                    torch.clamp(1.0 - torch.abs(p[:, None, :] - k), min=0.0),
                    0.0)
    idx = torch.clamp(torch.arange(size, device=dev)[:, None]
                      + (k.long()[:, :, None, :] - 2), 0, size - 1)
    idx = idx + origin[:, None, None, :]
    out = None
    for ty in (0, 1):
        for tx in (0, 1):
            term = (w[:, ty, 1] * w[:, tx, 0])[:, None, None, None] \
                * src[bi, idx[:, ty, :, 1, None], idx[:, tx, None, :, 0]]
            out = term if out is None else out + term
    return out


def rectify_track(frames: torch.Tensor, seeds: torch.Tensor, k1, gsize: int,
                  zone: int, frame_hw, lowered: bool = False):
    """One batch of n streams: frames (n, B, H, W, 3) uint8, seeds (n, 4,
    2), k1 (n,), or None for pinhole cameras → (canon (n, B, S, S, 3), corners (n, B, 4, 2), sharpness,
    align (n, B), new seeds (n, 4, 2)). ``lowered``: each canvas stored
    in bfloat16 (the control)."""
    n, b = frames.shape[0], frames.shape[1]
    if b % CHUNK:
        raise ValueError(f"batches of whole chunks of {CHUNK} frames only")
    dev = frames.device
    lens = lens_pts = table = None
    if k1 is not None:
        lens = lens_fields(k1, frame_hw, 2)             # (n, 1) fields
        lens_pts = lens_fields(k1, frame_hw, 3)         # (n, 1, 1) fields
        table = torch.stack([f[:, 0] for f in lens], -1)[:, None] \
            .expand(n, CHUNK, 5).reshape(-1, 5)
    size = gsize * zone
    pad = PAD_CELLS * zone
    E = size + 2 * pad
    lo = pad + zone / 2.0 - 0.5
    hi = pad + size - zone / 2.0 - 0.5
    anchors = square(lo, hi, dev)
    S = min(pad - 2, int(round(TRACK_WIN_OFFSET * zone)))
    geom = half_geometry(anchors, E, gsize)
    seed = seeds.to(torch.float32)
    ref_col = ref_row = None
    out_canon, out_cs, out_sharp, out_align = [], [], [], []
    for j in range(b // CHUNK):
        fc = frames[:, j * CHUNK:(j + 1) * CHUNK]
        H = homography_dlt(anchors, undistort_pts(lens, seed))
        hmats = H[:, None].expand(n, CHUNK, 3, 3).reshape(-1, 3, 3) \
            .contiguous()
        rect = warp(fc.reshape(-1, *fc.shape[2:]), hmats, (E, E),
                    1.0 / 255.0, table)
        if lowered:
            rect = rect.to(torch.bfloat16).to(torch.float32)
        profiles = split_profiles(
            rgb_to_gray(rect).reshape(n, CHUNK, E, E), gsize)
        cols, rows = profiles[0], profiles[1]
        if ref_col is None:
            ref_col, ref_row = cols[:, 0], rows[:, 0]
        tx, ty, theta, sigma, sharp, ok, rot_ok, scl_ok = track_measure(
            *profiles, ref_col, ref_row, S, geom, gsize)
        dx, dy = hold_bad(tx, ok), hold_bad(ty, ok)
        theta = hold_bad(theta, rot_ok & ok)
        sigma = hold_bad(sigma, scl_ok & ok)
        e_lock = abs_lock_update(cols[:, 0], rows[:, 0], lo, lo, float(zone),
                                 float(zone), dx[:, 0], dy[:, 0], ok[:, 0],
                                 dx.new_zeros(2, n), S, gsize)
        dx = dx + e_lock[0][:, None]
        dy = dy + e_lock[1][:, None]
        dc = torch.clamp(torch.stack([dx, dy], -1), -(pad + 1.0), pad + 1.0)
        ic = torch.clamp(torch.round(dc), -(pad - 1), pad - 1)
        canon = shifted_crop(rect, pad + ic.reshape(-1, 2).long(), size,
                             (dc - ic).reshape(-1, 2))
        out_canon.append(canon.reshape(n, CHUNK, *canon.shape[1:]))
        cs = distort_pts(lens_pts, apply_homography(
            H[:, None], apply_similarity(anchors, dx, dy, theta, sigma)))
        out_cs.append(cs)
        out_sharp.append(sharp)
        out_align.append(align_quality(cols, rows, anchors, dx, dy, sigma,
                                       gsize))
        seed = cs[:, -1]
        ref_col = (1 - TRACK_REF_EMA) * ref_col \
            + TRACK_REF_EMA * _profile_shift(cols[:, -1], dx[:, -1])
        ref_row = (1 - TRACK_REF_EMA) * ref_row \
            + TRACK_REF_EMA * _profile_shift(rows[:, -1], dy[:, -1])
    return (torch.cat(out_canon, 1), torch.cat(out_cs, 1),
            torch.cat(out_sharp, 1), torch.cat(out_align, 1), seed)


def _profile_shift(profile: torch.Tensor, delta) -> torch.Tensor:
    n = profile.shape[-1]
    return interp1d_hat(
        profile,
        torch.arange(n, dtype=torch.float32, device=profile.device)
        + _col(delta))
