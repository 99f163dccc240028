"""Background model + agitation estimation (port of
camkifu_tpu/ops/background.py): an EMA luma background at reduced
resolution, a robust global exposure gain, and the fraction of changed
pixels. Leading dims are a batch of frames, where the reference vmaps.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from camkifu_tpu.config import cvconf


def downsample_luma(canonical_luma: torch.Tensor,
                    factor: int = 4) -> torch.Tensor:
    """(..., S, S) luma → (..., S/f, S/f) by average pooling (exact reshape
    mean)."""
    s = canonical_luma.shape[-1]
    d = s // factor
    lead = canonical_luma.shape[:-2]
    return canonical_luma[..., :d * factor, :d * factor] \
        .reshape(*lead, d, factor, d, factor).mean(dim=(-3, -1))


@functools.lru_cache(maxsize=8)
def _gain_edges(lo: float, hi: float, nbins: int, device) -> torch.Tensor:
    """``jnp.linspace(lo, hi, nbins + 1, dtype=float32)`` as the
    reference's jitted scan rounds it (lo·(1 − t) + hi·t with t = i / nbins,
    each step in float32), which is not how ``torch.linspace`` rounds: a
    pixel ratio on a bin edge must fall in the same bin in both."""
    f32 = np.float32
    t = np.arange(nbins, dtype=f32) / f32(nbins)
    edges = np.append(f32(lo) * (f32(1) - t) + f32(hi) * t, f32(hi))
    return torch.as_tensor(edges.astype(f32), device=device)


def robust_gain(x: torch.Tensor, ref: torch.Tensor, lo: float = 0.7,
                hi: float = 1.4, nbins: int = 128,
                floor: float = 0.05) -> torch.Tensor:
    """Global exposure gain between luma images (..., h, w): the histogram
    median of the per-pixel ratio x/ref, one per leading index."""
    lead = x.shape[:-2]
    r = torch.clamp(x / torch.clamp(ref, min=floor), lo, hi) \
        .reshape(*lead, 1, -1)                                  # (..., 1, N)
    edges = _gain_edges(lo, hi, nbins, x.device)
    hist = ((r >= edges[:-1, None]) & (r < edges[1:, None])).sum(dim=-1)
    # Clipping piles exact-lo/hi values on the boundary bins; the < test
    # drops exact-hi pixels, so count them into the last bin.
    hist[..., -1] += (r >= hi).sum(dim=(-2, -1))
    half = 0.5 * r.shape[-1]
    # argmax of the first bin reaching half; torch.argmax takes no bool.
    med_bin = torch.argmax((torch.cumsum(hist, dim=-1) >= half)
                           .to(torch.uint8), dim=-1)
    centers = 0.5 * (edges[:-1] + edges[1:])
    return torch.take(centers, med_bin)


def agitation_score(luma_small: torch.Tensor, bg: torch.Tensor,
                    pixel_thresh: float = 0.08) -> torch.Tensor:
    """Fraction of pixels whose |luma − background| exceeds pixel_thresh,
    per leading index."""
    return (torch.abs(luma_small - bg) > pixel_thresh) \
        .to(torch.float32).mean(dim=(-2, -1))


def update_background(bg: torch.Tensor, luma_small: torch.Tensor,
                      agitation: torch.Tensor,
                      ema: float = cvconf.background_ema) -> torch.Tensor:
    """EMA background update, slowed 10× while the scene is agitated;
    ``agitation`` has the leading dims of ``bg`` (..., h, w)."""
    rate = torch.where(agitation > cvconf.agitation_threshold, 0.1 * ema,
                       ema)[..., None, None]
    return bg * (1.0 - rate) + luma_small * rate
