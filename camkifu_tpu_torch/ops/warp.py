"""Perspective rectification: DLT homography + bilinear inverse warp (port
of camkifu_tpu/ops/warp.py: one fixed camera, or corners per frame).

Coordinate convention: OpenCV's — integer coordinate i is the center of
pixel i. Corners are (..., 4, 2) float (x, y), ordered tl/tr/br/bl.
Intersection (r, c) of the canonical board sits at ((c + 0.5) z - 0.5,
(r + 0.5) z - 0.5), so zone extraction downstream is a reshape.

Every function here takes leading batch dims where the reference vmaps.
The frame warp runs the CUDA kernel on a CUDA tensor and its plain version
on the CPU (``warp_frames``). With a ``lens`` (``ops/lens.py``) corners
stay raw frame positions: the homography is built on their pinhole
positions and the warp bends its sample grid back through the lens.
"""

from __future__ import annotations

import functools
import math

import torch

from camkifu_tpu_torch.config import cvconf, guiconf
from camkifu_tpu_torch.ops.lens import Lens, check_lens, undistort_pts


@functools.lru_cache(maxsize=32)
def square(lo: float, hi: float, device=None) -> torch.Tensor:
    """The corners tl/tr/br/bl (4, 2) float32 of the square [lo, hi]² on
    ``device``, made once: a tensor built from Python numbers is a copy
    the host waits for. Read only."""
    return torch.tensor([[lo, lo], [hi, lo], [hi, hi], [lo, hi]],
                        dtype=torch.float32, device=device)


def canonical_corners(gsize: int = guiconf.gsize,
                      zone: int = cvconf.zone_size,
                      device=None) -> torch.Tensor:
    """Canonical (x, y) targets of the 4 corner intersections, tl/tr/br/bl
    (read only: one tensor per size and device)."""
    return square(zone / 2.0 - 0.5, gsize * zone - zone / 2.0 - 0.5, device)


def _normalizer(pts: torch.Tensor) -> torch.Tensor:
    """Hartley normalization (..., N, 2) → (..., 3, 3): centroid → origin,
    RMS radius → √2."""
    mean = pts.mean(dim=-2)
    rms = torch.sqrt(torch.mean(
        torch.sum((pts - mean[..., None, :]) ** 2, dim=-1), dim=-1))
    s = math.sqrt(2.0) / torch.clamp(rms, min=1e-6)
    zero = torch.zeros_like(s)
    one = torch.ones_like(s)
    return torch.stack([
        torch.stack([s, zero, -s * mean[..., 0]], dim=-1),
        torch.stack([zero, s, -s * mean[..., 1]], dim=-1),
        torch.stack([zero, zero, one], dim=-1),
    ], dim=-2)


def _inv3(M: torch.Tensor) -> torch.Tensor:
    """Closed-form (..., 3, 3) inverse (adjugate)."""
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


def homography_dlt(src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) homographies H with dst ~ H @ src for 4 point pairs.

    src, dst: (..., 4, 2) float (x, y), broadcast against each other.
    Hartley-normalizes both point sets, solves the 8×8 system with h33 = 1
    in float32, then denormalizes. A degenerate quad gives a non-finite H,
    as the reference's elimination does, and no error: callers score such
    candidates out (and no device→host sync checks the solve).
    """
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
    # Rows for u: [x y 1 0 0 0 -ux -uy], rows for v: [0 0 0 x y 1 -vx -vy]
    a_u = torch.stack([x, y, ones, zeros, zeros, zeros, -u * x, -u * y], -1)
    a_v = torch.stack([zeros, zeros, zeros, x, y, ones, -v * x, -v * y], -1)
    A = torch.cat([a_u, a_v], dim=-2)                    # (..., 8, 8)
    b = torch.cat([u, v], dim=-1)                        # (..., 8)
    h = torch.linalg.solve_ex(A, b).result
    Hn = torch.cat([h, torch.ones_like(h[..., :1])], dim=-1)
    Hn = Hn.reshape(h.shape[:-1] + (3, 3))
    H = _inv3(t_dst) @ Hn @ t_src
    return H / H[..., 2:3, 2:3]


def apply_homography(H: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Apply (..., 3, 3) H to (..., N, 2) points (x, y)."""
    xy1 = torch.cat([pts, torch.ones_like(pts[..., :1])], dim=-1)
    out = xy1 @ H.transpose(-1, -2)
    return out[..., :2] / out[..., 2:3]


def bilinear_sample(img: torch.Tensor, x: torch.Tensor,
                    y: torch.Tensor) -> torch.Tensor:
    """Sample img (H, W, C) at float coords; out-of-bounds clamps to edge.

    x, y: any matching shape. Returns shape x.shape + (C,), float32. Only
    the four taps are converted to float32, never the whole image. A batch
    img (B, H, W, C) takes x, y of shape (B or 1, ...), frame b sampled at
    x[b] (the plain version of the warp kernel's taps).
    """
    h, w = img.shape[-3], img.shape[-2]
    x = torch.clamp(x, 0.0, w - 1.0)
    y = torch.clamp(y, 0.0, h - 1.0)
    x0f = torch.floor(x)
    y0f = torch.floor(y)
    fx = (x - x0f)[..., None]
    fy = (y - y0f)[..., None]
    # A NaN coordinate (degenerate homography) reads pixel 0 with a NaN
    # weight, so its sample is NaN, as in the reference, not an index fault.
    x0 = torch.nan_to_num(x0f, nan=0.0).long()
    y0 = torch.nan_to_num(y0f, nan=0.0).long()
    x1 = torch.clamp(x0 + 1, max=w - 1)
    y1 = torch.clamp(y0 + 1, max=h - 1)
    if img.ndim == 4:
        bi = torch.arange(img.shape[0], device=img.device)
        idx = (bi.reshape(-1, *[1] * (x.ndim - 1)),)
    else:
        idx = ()
    p00 = img[idx + (y0, x0)].to(torch.float32)
    p01 = img[idx + (y0, x1)].to(torch.float32)
    p10 = img[idx + (y1, x0)].to(torch.float32)
    p11 = img[idx + (y1, x1)].to(torch.float32)
    top = p00 * (1 - fx) + p01 * fx
    bot = p10 * (1 - fx) + p11 * fx
    return top * (1 - fy) + bot * fy


def warp_frames(frames: torch.Tensor, hmats: torch.Tensor,
                out_hw: tuple[int, int], scale: float = 1.0,
                lens: Lens | torch.Tensor | None = None) -> torch.Tensor:
    """(B, H, W, C) frames → (B, OH, OW, C) float32 samples ×``scale``:
    output pixel (u, v) samples the frame at ``hmats`` @ (u, v, 1), bent
    through ``lens`` if one is given.

    ``hmats`` is one (3, 3) homography shared by the batch or (B, 3, 3).
    ``lens`` is a ``Lens`` of numbers shared by the batch, or a (B, 5)
    table (``ops.lens.as_table`` of a stacked lens), a lens a frame. A CUDA
    tensor goes through the warp kernel (uint8 only), a CPU tensor through
    its plain version.
    """
    from camkifu_tpu_torch.ops.cuda import warp_kernel

    if lens is not None and not isinstance(lens, torch.Tensor):
        check_lens(lens)
        lens = tuple(lens)
    hmats = hmats.contiguous()
    args = (frames, hmats, out_hw, scale) + (() if lens is None else (lens,))
    if frames.is_cuda:
        return warp_kernel.warp_homography(*args)
    return warp_kernel.warp_homography_ref(*args)


def warp_batch_fixed(frames: torch.Tensor, corners: torch.Tensor,
                     gsize: int = guiconf.gsize,
                     zone: int = cvconf.zone_size,
                     scale: float = 1.0,
                     lens: Lens | None = None) -> torch.Tensor:
    """(B, H, W, C) frames + one fixed (4, 2) corner set (raw frame
    positions) → (B, S, S, C), S = gsize·zone, in the frame's scale times
    ``scale``."""
    if corners.ndim != 2:
        raise ValueError(f"warp_batch_fixed takes one (4, 2) corner set, got "
                         f"{tuple(corners.shape)}; per-frame corners go "
                         f"through warp_batch_chunked")
    size = gsize * zone
    # Solved as a batch of one: a batch of streams' corners solves the
    # same way (``parallel.mesh``), and a stream then warps to the same
    # bits as it does alone (a batched 3×3 product rounds unlike a lone
    # one on the CPU).
    H = homography_dlt(canonical_corners(gsize, zone, corners.device),
                       undistort_pts(lens, corners)[None])[0]
    return warp_frames(frames, H, (size, size), scale, lens)


def warp_to_canonical(frame: torch.Tensor, corners: torch.Tensor,
                      gsize: int = guiconf.gsize,
                      zone: int = cvconf.zone_size,
                      lens: Lens | None = None) -> torch.Tensor:
    """Rectify one frame (H, W, C) to the canonical (gsize·zone)² image."""
    return warp_batch_fixed(frame[None], corners, gsize, zone, lens=lens)[0]


def warp_batch(frames: torch.Tensor, corners: torch.Tensor,
               gsize: int = guiconf.gsize,
               zone: int = cvconf.zone_size,
               lens: Lens | None = None) -> torch.Tensor:
    """(B, H, W, C) frames + (B, 4, 2) per-frame corners (raw frame
    positions) → (B, S, S, C) in the frame's scale: each frame through its
    own homography, one warp launch for the batch on the card."""
    size = gsize * zone
    H = homography_dlt(canonical_corners(gsize, zone, corners.device),
                       undistort_pts(lens, corners.to(torch.float32)))
    return warp_frames(frames, H, (size, size), lens=lens)


def _shifted_crop(src: torch.Tensor, origin: torch.Tensor | None, size: int,
                  offset: torch.Tensor) -> torch.Tensor:
    """Crop a ``size``² window of each (B, Hs, Ws, C) image at its own
    integer ``origin`` ((B, 2) int64 (x, y); None for (0, 0)), and
    translate the window's content by −``offset`` ((B, 2) float (dx, dy),
    clamped to [−2, 1.999] px), replicating the window's own edge.

    The reference blends the 16 static integer shifts of the edge-padded
    window with bilinear hat weights, of which at most four are non-zero.
    Only those four are gathered here, in the same order, so the sums are
    the same (the other twelve terms add exact zeros): four gathers through
    per-frame row and column index tensors, no value read on the host.
    """
    dev = src.device
    bi = torch.arange(src.shape[0], device=dev)[:, None, None]
    p = 2.0 + torch.clamp(offset, -2.0, 1.999)            # (B, 2), in [0, 4)
    # The two shifts with weight on each axis: (B, tap, axis), of the 0..3
    # the reference blends. Shift 4 is not among them: it has no term.
    k = torch.floor(p)[:, None, :] \
        + torch.arange(2, dtype=p.dtype, device=dev)[:, None]
    w = torch.where(k <= 3.0,
                    torch.clamp(1.0 - torch.abs(p[:, None, :] - k), min=0.0),
                    0.0)
    # Source index of every window pixel under each shift: (B, tap, size,
    # axis), clamped to the window (its replicated edge), then moved to it.
    idx = torch.clamp(torch.arange(size, device=dev)[:, None]
                      + (k.long()[:, :, None, :] - 2), 0, size - 1)
    if origin is not None:
        idx = idx + origin[:, None, None, :]
    out = None
    for ty in (0, 1):
        for tx in (0, 1):
            term = (w[:, ty, 1] * w[:, tx, 0])[:, None, None, None] \
                * src[bi, idx[:, ty, :, 1, None], idx[:, tx, None, :, 0]]
            out = term if out is None else out + term
    return out


def _subpixel_shift(img: torch.Tensor, offset: torch.Tensor) -> torch.Tensor:
    """Translate (S, S, C) content by −offset (offset = (dx, dy) float,
    clamped to [−2, 1.999] px), replicating the image's edge; (B, S, S, C)
    images take (B, 2) offsets, one per image.

    As in the reference, an offset above 1 px fades the image: the blend
    has no shift beyond +1, so the weights no longer sum to 1."""
    if img.ndim == 3:
        return _subpixel_shift(img[None], offset[None])[0]
    return _shifted_crop(img, None, img.shape[1], offset)


def warp_batch_chunked(frames: torch.Tensor, corners: torch.Tensor,
                       gsize: int = guiconf.gsize,
                       zone: int = cvconf.zone_size, chunk: int = 8,
                       scale: float = 1.0,
                       lens: Lens | None = None) -> torch.Tensor:
    """(B, H, W, C) frames + (B, 4, 2) per-frame corners → (B, S, S, C),
    in the frame's scale times ``scale``.

    Each ``chunk`` consecutive frames are warped through the homography of
    their median corners, one warp launch per chunk, and each frame's
    residual camera motion is then removed by shifting its canonical image
    by the mean displacement of its own corners in that view (a sub-pixel
    translation, ``_subpixel_shift``). B need not be a multiple of
    ``chunk``: the last frame is repeated and the repeats dropped. With a
    ``lens`` both the chunk's homography and the landed corners are taken
    on pinhole positions.
    """
    b = frames.shape[0]
    corners = corners.to(torch.float32)
    pad = (-b) % chunk
    if pad:
        frames = torch.cat([frames, frames[-1:].expand(pad, *frames.shape[1:])])
        corners = torch.cat([corners, corners[-1:].expand(pad, 4, 2)])
    k = frames.shape[0] // chunk
    size = gsize * zone
    cb = corners.reshape(k, chunk, 4, 2)
    # The median of an even count averages the two middle values, as
    # jnp.median does; torch.median would return the lower one.
    cc = torch.quantile(cb, 0.5, dim=1)                      # (k, 4, 2)
    ideal = canonical_corners(gsize, zone, corners.device)
    hmats = homography_dlt(ideal, undistort_pts(lens, cc))   # (k, 3, 3)
    canon = torch.cat([
        warp_frames(frames[i * chunk:(i + 1) * chunk], hmats[i], (size, size),
                    scale, lens) for i in range(k)])
    # Where each frame's true corners land in its chunk's canonical view;
    # their mean displacement from the ideal anchors is the residual camera
    # translation.
    landed = apply_homography(_inv3(hmats)[:, None],
                              undistort_pts(lens, cb))       # (k, chunk, 4, 2)
    offsets = (landed - ideal).mean(dim=2).reshape(k * chunk, 2)
    return _subpixel_shift(canon, offsets)[:b]
