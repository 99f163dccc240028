"""Shared temporal-vote machinery (port of camkifu_tpu/stone/votes.py): a
decayed per-intersection vote accumulator with confidence-gated casting,
local motion gating, and a commit rule (threshold + 2:1 dominance over the
runner-up).
"""

from __future__ import annotations

import torch

from camkifu_tpu_torch.config import cvconf
from camkifu_tpu_torch.ops import background


def vote_update(votes: torch.Tensor, stable: torch.Tensor,
                labels: torch.Tensor, conf: torch.Tensor,
                zone_calm: torch.Tensor,
                cfg: cvconf.VisionConfig = cvconf.DEFAULT):
    """One reading into the vote state.

    votes (g, g, 3), stable (g, g) int8, labels (g, g) int8, conf (g, g),
    zone_calm (g, g) in {0, 1}.
    Returns (new_votes, new_stable, out_conf).
    """
    decay = 1.0 - 1.0 / cfg.vote_window
    # One-hot by comparison (F.one_hot checks its range on the host).
    onehot = (labels[..., None].to(torch.int64)
              == torch.arange(3, device=labels.device)).to(torch.float32)
    casts = (conf >= cfg.vote_min_conf).to(torch.float32)
    new_votes = votes * decay + onehot * casts[..., None] \
        * zone_calm[..., None]

    top = new_votes.amax(dim=-1)
    # Ties keep the first label, as jnp.argmax does.
    top_label = torch.argmax(new_votes, dim=-1).to(torch.int8)
    runner = torch.sort(new_votes, dim=-1).values[..., 1]
    commit = (top >= cfg.vote_threshold) & (top >= 2.0 * runner)
    new_stable = torch.where(commit, top_label, stable)
    out_conf = torch.clamp(top / cfg.vote_window, 0.0, 1.0)
    return new_votes, new_stable, out_conf


def _zone_mean(x: torch.Tensor, gsize: int) -> torch.Tensor:
    """(..., h, w) → (..., g, g): the mean over each intersection's
    f × f block, f = h // g."""
    f = x.shape[-1] // gsize
    lead = x.shape[:-2]
    return x[..., :gsize * f, :gsize * f] \
        .reshape(*lead, gsize, f, gsize, f).mean(dim=(-3, -1))


def zone_motion_gate(luma_small: torch.Tensor, prev: torch.Tensor,
                     gsize: int, flow_thresh: float = 1.0,
                     grad_floor: float = 0.02):
    """Frame-to-frame motion pooled per intersection, for each leading
    index of (..., h, w) luma images: the exposure-compensated temporal
    difference over the local gradient (a one-step optical-flow magnitude),
    plus a flat-occluder term.

    Returns (zone_calm (..., g, g) float {0, 1}, agitation (...) = the
    fraction of moving zones).
    """
    gain = background.robust_gain(luma_small, prev)[..., None, None]
    dt = torch.abs(luma_small - gain * prev)
    gx = 0.5 * (torch.roll(luma_small, -1, -1) - torch.roll(luma_small, 1, -1))
    gy = 0.5 * (torch.roll(luma_small, -1, -2) - torch.roll(luma_small, 1, -2))
    grad = torch.sqrt(gx * gx + gy * gy)
    flow = dt / (grad + grad_floor)                 # ≈ |motion| in px
    zone_flow = _zone_mean(flow, gsize)
    # Flat-occluder term: mean dt per zone vs mean gradient per zone.
    zone_dt = _zone_mean(dt, gsize)
    zone_grad = _zone_mean(grad, gsize)
    flat_occluded = zone_dt > torch.clamp(2.0 * zone_grad, min=0.06)
    calm = (zone_flow <= flow_thresh) & ~flat_occluded
    agitation = 1.0 - calm.to(torch.float32).mean(dim=(-2, -1))
    return calm.to(torch.float32), agitation
