"""Perspective rectification: DLT homography + bilinear inverse warp (port
of camkifu_tpu/ops/warp.py, fixed-camera path).

Coordinate convention: OpenCV's — integer coordinate i is the center of
pixel i. Corners are (..., 4, 2) float (x, y), ordered tl/tr/br/bl.
Intersection (r, c) of the canonical board sits at ((c + 0.5) z - 0.5,
(r + 0.5) z - 0.5), so zone extraction downstream is a reshape.

Every function here takes leading batch dims where the reference vmaps.
The frame warp runs the CUDA kernel on a CUDA tensor and its plain version
on the CPU (``warp_frames``).
"""

from __future__ import annotations

import math

import torch

from camkifu_tpu.config import cvconf, guiconf


def canonical_corners(gsize: int = guiconf.gsize,
                      zone: int = cvconf.zone_size,
                      device=None) -> torch.Tensor:
    """Canonical (x, y) targets of the 4 corner intersections, tl/tr/br/bl."""
    lo = zone / 2.0 - 0.5
    hi = gsize * zone - zone / 2.0 - 0.5
    return torch.tensor([[lo, lo], [hi, lo], [hi, hi], [lo, hi]],
                        dtype=torch.float32, device=device)


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
                out_hw: tuple[int, int], scale: float = 1.0) -> torch.Tensor:
    """(B, H, W, C) frames → (B, OH, OW, C) float32 samples ×``scale``:
    output pixel (u, v) samples the frame at ``hmats`` @ (u, v, 1).

    ``hmats`` is one (3, 3) homography shared by the batch or (B, 3, 3).
    A CUDA tensor goes through the warp kernel (uint8 only), a CPU tensor
    through its plain version.
    """
    from camkifu_tpu_torch.ops.cuda import warp_kernel

    hmats = hmats.contiguous()
    if frames.is_cuda:
        return warp_kernel.warp_homography(frames, hmats, out_hw, scale)
    return warp_kernel.warp_homography_ref(frames, hmats, out_hw, scale)


def warp_batch_fixed(frames: torch.Tensor, corners: torch.Tensor,
                     gsize: int = guiconf.gsize,
                     zone: int = cvconf.zone_size,
                     scale: float = 1.0) -> torch.Tensor:
    """(B, H, W, C) frames + one fixed (4, 2) corner set → (B, S, S, C),
    S = gsize·zone, in the frame's scale times ``scale``."""
    if corners.ndim != 2:
        raise NotImplementedError(
            "per-frame (B, 4, 2) corners belong to the tracking slice "
            "(warp_batch_chunked), which is not ported yet")
    size = gsize * zone
    H = homography_dlt(canonical_corners(gsize, zone, corners.device),
                       corners)
    return warp_frames(frames, H, (size, size), scale)


def warp_to_canonical(frame: torch.Tensor, corners: torch.Tensor,
                      gsize: int = guiconf.gsize,
                      zone: int = cvconf.zone_size) -> torch.Tensor:
    """Rectify one frame (H, W, C) to the canonical (gsize·zone)² image."""
    return warp_batch_fixed(frame[None], corners, gsize, zone)[0]
