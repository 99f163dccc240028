"""Intersection zone extraction + per-zone statistics (port of
camkifu_tpu/ops/zones.py).

Canonical images are (..., S, S, C): any leading dims are a batch, which
takes the place of the reference's vmap over frames.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from camkifu_tpu_torch.config import cvconf, guiconf
from camkifu_tpu_torch.ops.color import rgb_to_gray


def extract_zones(canonical: torch.Tensor, gsize: int = guiconf.gsize,
                  zone: int = cvconf.zone_size) -> torch.Tensor:
    """(..., S, S, C) canonical image → (..., g, g, zone, zone, C) patches."""
    lead = canonical.shape[:-3]
    c = canonical.shape[-1]
    z = canonical.reshape(*lead, gsize, zone, gsize, zone, c)
    return z.transpose(-4, -3)


def disc_mask(zone: int = cvconf.zone_size, radius_frac: float = 0.42
              ) -> np.ndarray:
    """(zone, zone) float mask ≈ the stone disc centered on the
    intersection."""
    r = np.arange(zone, dtype=np.float32) - (zone - 1) / 2.0
    yy, xx = np.meshgrid(r, r, indexing="ij")
    dist = np.sqrt(yy**2 + xx**2)
    return (dist <= radius_frac * zone).astype(np.float32)


def corner_indices(zone: int, frac: float = 0.36) -> np.ndarray:
    """Flat indices of the four corner patches of a zone (pixels with both
    |dx| and |dy| beyond frac·zone from the center)."""
    r = np.arange(zone, dtype=np.float32) - (zone - 1) / 2.0
    far = np.abs(r) > frac * zone
    sel = far[:, None] & far[None, :]
    return np.nonzero(sel.reshape(-1))[0]


def bg_indices(gsize: int, zone: int, frac: float = 0.36) -> np.ndarray:
    """(g, g, n) flat zone-pixel indices for the background median.

    Interior zones use all four corner patches; border zones swap each
    outward-facing patch for its inward mirror, so an edge zone never
    samples the table past the board slab.
    """
    r = np.arange(zone, dtype=np.float32) - (zone - 1) / 2.0
    far_lo = far_hi = np.abs(r) > frac * zone
    lo, hi = far_lo & (r < 0), far_hi & (r > 0)
    patch = {(sy, sx): np.nonzero((my[:, None] & mx[None, :]).reshape(-1))[0]
             for sy, my in ((0, lo), (1, hi)) for sx, mx in ((0, lo), (1, hi))}
    n = 4 * len(patch[0, 0])
    out = np.empty((gsize, gsize, n), np.int32)
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
    """Last-axis (lower) median of float values in [0, 1] at uint8
    resolution, by an 8-step binary search over the value domain.

    Not ``torch.median``: the reference quantizes to 1/255, and its inputs
    are bilinear samples, not exact uint8 values, so an exact median would
    move the backgrounds.
    """
    k = x.shape[-1] // 2                      # 0-indexed middle rank
    q = torch.clamp(x * 255.0, 0.0, 255.0).to(torch.int32)
    v = torch.zeros(x.shape[:-1], dtype=torch.int32, device=x.device)
    for bit in range(7, -1, -1):
        t = v + (1 << bit)
        cnt = torch.sum(q < t[..., None], dim=-1)
        v = torch.where(cnt <= k, t, v)
    return v.to(torch.float32) / 255.0


def _grid_median3(x: torch.Tensor, grid_dim: int = 0) -> torch.Tensor:
    """3×3 neighborhood median over the (g, g) grid dims starting at
    ``grid_dim``, edge-padded. Nine values: an odd count, so
    ``torch.median`` returns the middle one as ``jnp.median`` does."""
    g0, g1 = x.shape[grid_dim], x.shape[grid_dim + 1]
    xp = torch.cat([x.narrow(grid_dim, 0, 1), x,
                    x.narrow(grid_dim, g0 - 1, 1)], dim=grid_dim)
    xp = torch.cat([xp.narrow(grid_dim + 1, 0, 1), xp,
                    xp.narrow(grid_dim + 1, g1 - 1, 1)], dim=grid_dim + 1)
    stack = torch.stack([
        xp.narrow(grid_dim, di, g0).narrow(grid_dim + 1, dj, g1)
        for di in range(3) for dj in range(3)])
    return torch.median(stack, dim=0).values


@functools.lru_cache(maxsize=8)
def _zone_constants(gsize: int, zone: int, device):
    """(disc mask, background indices, disc indices) on ``device``, made
    once: the reference's trace-time constants."""
    mask = disc_mask(zone)
    return (torch.as_tensor(mask, device=device),
            torch.as_tensor(bg_indices(gsize, zone), dtype=torch.long,
                            device=device),
            torch.as_tensor(np.nonzero(mask.reshape(-1) > 0.5)[0],
                            device=device))


def zone_stats(canonical: torch.Tensor, gsize: int = guiconf.gsize,
               zone: int = cvconf.zone_size) -> dict:
    """Shared per-intersection statistics consumed by the stone classifier.

    canonical: (..., S, S, C). Keys: luma (..., g, g, z, z); disc_mean_rgb,
    disc_med_rgb, bg_rgb (..., g, g, C); bg_luma, disc_med_luma (..., g, g).
    """
    lead = canonical.shape[:-3]
    gd = len(lead)                                       # first grid dim
    zones = extract_zones(canonical, gsize, zone)        # (..., g,g,z,z,C)
    mask, bg_idx, disc_idx = _zone_constants(gsize, zone, canonical.device)
    inv = 1.0 / max(float(disc_mask(zone).sum()), 1.0)
    c = zones.shape[-1]
    flat = zones.reshape(*lead, gsize, gsize, zone * zone, c)
    luma = rgb_to_gray(zones)                            # (..., g,g,z,z)
    luma_flat = luma.reshape(*lead, gsize, gsize, zone * zone)
    idx = bg_idx.expand(*lead, *bg_idx.shape)
    bg_px = torch.gather(flat, -2, idx[..., None].expand(*idx.shape, c))
    bg_luma = torch.gather(luma_flat, -1, idx)
    return {
        "zones": zones,
        "luma": luma,
        "disc_mean_rgb": torch.einsum("...ghyxc,yx->...ghc", zones, mask)
        * inv,
        "bg_rgb": _grid_median3(median_u8(bg_px.transpose(-1, -2)), gd),
        "bg_luma": _grid_median3(median_u8(bg_luma), gd),
        "disc_med_luma": median_u8(luma_flat[..., disc_idx]),
        "disc_med_rgb": median_u8(flat[..., disc_idx, :].transpose(-1, -2)),
    }
