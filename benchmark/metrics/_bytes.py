"""The bytes a rectification needs, from the cell's shapes and each
frame's true corners, whatever implements it.

A canonical image of side S = gsize·zone is written once as float32 RGB,
and each source pixel that its bilinear taps touch is read once as uint8
RGB. The taps are those of the canonical warp through the true corners
(bent through the camera's lens): the pixels any implementation has to
read to produce the image. Counted as distinct pixels, a source pixel
shared by several taps counts once.
"""

from __future__ import annotations

import torch

from benchmark.reference import scan

#: Frames counted in one block (a (block, H·W) mask of the taps).
BLOCK = 32


def tap_pixels(corners: torch.Tensor, k1: torch.Tensor, frame_hw,
               gsize: int, zone: int) -> torch.Tensor:
    """(N,) int64: the distinct source pixels the canonical warp of each
    frame reads, for corners (N, 4, 2) as the frame shows them and each
    frame's lens k1 (N,) (0 for a pinhole)."""
    h, w = frame_hw
    size = gsize * zone
    dev = corners.device
    out = []
    v = torch.arange(size, dtype=torch.float32, device=dev)[:, None]
    u = torch.arange(size, dtype=torch.float32, device=dev)[None, :]
    for i in range(0, corners.shape[0], BLOCK):
        c = corners[i:i + BLOCK].to(torch.float32)
        lens = scan.lens_fields(k1[i:i + BLOCK].to(torch.float32), frame_hw,
                                2)
        H = scan.homography_dlt(scan.canonical_corners(gsize, zone, dev),
                                scan.undistort_pts(lens, c))[:, :, :, None,
                                                             None]
        den = H[:, 2, 0] * u + H[:, 2, 1] * v + H[:, 2, 2]
        x = (H[:, 0, 0] * u + H[:, 0, 1] * v + H[:, 0, 2]) / den
        y = (H[:, 1, 0] * u + H[:, 1, 1] * v + H[:, 1, 2]) / den
        bent = scan.distort_pts(scan.lens_fields(k1[i:i + BLOCK], frame_hw,
                                                 3),
                                torch.stack([x, y], -1))
        x = torch.clamp(bent[..., 0], 0.0, w - 1.0)
        y = torch.clamp(bent[..., 1], 0.0, h - 1.0)
        x0 = torch.floor(x).long()
        y0 = torch.floor(y).long()
        x1 = torch.clamp(x0 + 1, max=w - 1)
        y1 = torch.clamp(y0 + 1, max=h - 1)
        n = c.shape[0]
        mask = torch.zeros((n, h * w), dtype=torch.bool, device=dev)
        for yy in (y0, y1):
            for xx in (x0, x1):
                mask.scatter_(1, (yy * w + xx).reshape(n, -1), True)
        out.append(mask.sum(dim=1))
    return torch.cat(out)


#: Channels of a frame and of a canonical image (RGB).
CHANNELS = 3


def warp_bytes(taps: torch.Tensor, gsize: int, zone: int) -> float:
    """Bytes of the rectification of frames whose taps are ``taps``
    (``tap_pixels``): every source pixel read once, every canonical
    float32 pixel written once."""
    size = gsize * zone
    n = taps.numel()
    return float(taps.sum()) * CHANNELS + n * size * size * CHANNELS * 4


def step_bytes(taps: torch.Tensor, gsize: int) -> float:
    """Bytes a step needs at the least: the board pixels read once and
    each frame's labels (int8, g × g) written once."""
    return float(taps.sum()) * CHANNELS + taps.numel() * gsize * gsize
