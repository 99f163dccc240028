"""Shape/contrast-based stone detection: the device functions of
camkifu_tpu/stone/sf_contours.py.

A dense per-zone disc test stands in for contour tracing: each zone's
pixels are thresholded against the corner-median background, and a stone
must fill the disc but not the surrounding ring. Leading dims are a batch
of frames, where the reference vmaps.
"""

from __future__ import annotations

import functools

import torch

from camkifu_tpu.config import cvconf, guiconf
from camkifu_tpu_torch.ops.zones import disc_mask, zone_stats

EMPTY, BLACK, WHITE = 0, 1, 2

#: |luma − background| for a pixel to count as "stone-like".
PIXEL_CONTRAST = 0.13

#: Fraction of disc pixels that must be active to call a stone.
MIN_DISC_FILL = 0.60

#: Maximum fraction of ring (outside-disc) pixels active.
MAX_RING_FILL = 0.85

#: Ring fill below this carries no confidence penalty; confidence then
#: falls linearly to 0 at MAX_RING_FILL.
RING_OK_FILL = 0.66


@functools.lru_cache(maxsize=8)
def _masks(zone: int, device):
    """(disc, ring, disc count, ring count) on ``device``."""
    disc = torch.as_tensor(disc_mask(zone), device=device)
    ring = 1.0 - disc
    return (disc, ring, torch.clamp(disc.sum(), min=1.0),
            torch.clamp(ring.sum(), min=1.0))


def classify_canonical(canonical: torch.Tensor, gsize: int = guiconf.gsize,
                       zone: int = cvconf.zone_size):
    """Canonical image(s) (..., S, S, 3) in [0, 1] → (labels (..., g, g)
    int8, conf (..., g, g))."""
    return classify_stats(zone_stats(canonical, gsize, zone), zone)


def classify_stats(stats: dict, zone: int = cvconf.zone_size):
    """Classify from shared zone statistics (ops.zones.zone_stats): the
    disc must be filled with pixels contrasting with the corner-median
    background, the ring mostly not, and the disc median must contrast
    too; the luma sign gives the color."""
    disc, ring, disc_n, ring_n = _masks(zone, stats["zones"].device)
    med_diff = stats["disc_med_luma"] - stats["bg_luma"]       # signed
    med_mag = torch.abs(stats["disc_med_rgb"]
                        - stats["bg_rgb"]).amax(dim=-1)

    diff = stats["zones"] - stats["bg_rgb"][..., None, None, :]
    active = (torch.abs(diff).amax(dim=-1) > PIXEL_CONTRAST) \
        .to(torch.float32)                                     # (..,g,g,z,z)
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
    conf = torch.where(is_stone, conf_stone, conf_empty)
    return labels, conf
