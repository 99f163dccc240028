"""SfBgSub (port of camkifu_tpu/stone/sf_bgsub.py): background-subtraction
stone detection.

Where SfContours compares a zone against a *spatial* background estimate
(corner wood), this finder learns the empty board's appearance
*temporally*: an EMA luma background of the canonical view, updated only
where the board is stably empty and motionless, so stones and hands never
melt into it. A stone is a persistent signed luma deviation of the disc
median from the remembered background.

As in the reference the warp runs on the whole batch; so do the luma, its
4× pooling, each frame's predecessor and the motion gate, which read no
carry. Only what reads the background is sequential: the reference's
``lax.scan`` becomes a Python loop over frames in which nothing waits for
the device.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from camkifu_tpu_torch.config import cvconf, guiconf
from camkifu_tpu_torch.ops import background
from camkifu_tpu_torch.ops.color import rgb_to_gray
from camkifu_tpu_torch.ops.warp import warp_batch_chunked, warp_batch_fixed
from camkifu_tpu_torch.ops.zones import _zone_constants, extract_zones, \
    median as disc_median
from camkifu_tpu_torch.stone.votes import vote_update, zone_motion_gate

EMPTY, BLACK, WHITE = 0, 1, 2

#: |disc-median luma − background| to call a stone.
PRESENCE_THRESH = 0.13

#: EMA rate of the empty-board background (per eligible frame).
BG_EMA = 0.08

#: Motion-gate pooling factor (canonical → small grid), as in sf_meta.
GATE_FACTOR = 4


class BgSubState(NamedTuple):
    votes: torch.Tensor        # (g, g, 3) float32
    stable: torch.Tensor       # (g, g) int8
    bg: torch.Tensor           # (S, S) float32 — empty-board luma
    prev: torch.Tensor         # (S/f, S/f) float32 — previous small luma
    frame_count: torch.Tensor  # () int32


def init_state(gsize: int = guiconf.gsize, zone: int = cvconf.zone_size,
               device="cuda") -> BgSubState:
    """A fresh carry on ``device`` (the card unless the caller asks for the
    CPU); ``bg`` and ``prev`` hold −1, "not seen yet"."""
    s = gsize * zone
    f32 = dict(dtype=torch.float32, device=device)
    return BgSubState(
        votes=torch.zeros((gsize, gsize, 3), **f32),
        stable=torch.zeros((gsize, gsize), dtype=torch.int8, device=device),
        bg=torch.full((s, s), -1.0, **f32),
        prev=torch.full((s // GATE_FACTOR, s // GATE_FACTOR), -1.0, **f32),
        frame_count=torch.zeros((), dtype=torch.int32, device=device),
    )


def _step(votes, stable, bg, luma, small, zone_calm, disc_idx, gsize: int,
          zone: int, cfg: cvconf.VisionConfig):
    """``step_frame`` after its motion gate: one frame's
    luma (S, S) and pooled luma against the carried background →
    (votes, stable, bg, out_conf)."""
    # The first frame initializes the background. Known limitation (the
    # reference's): stones already on the board then stay invisible to
    # this finder until they move.
    bg = torch.where(bg[:1, :1] < 0, luma, bg)
    # Exposure compensation: the frame normalized to the background's
    # exposure by one global gain, estimated on the pooled luma.
    bg_small = background.downsample_luma(bg, GATE_FACTOR)
    luma = luma / background.robust_gain(small, bg_small)

    # Presence: disc median of (luma − bg) per zone.
    zones_diff = extract_zones((luma - bg)[..., None], gsize, zone)[..., 0]
    flat = zones_diff.reshape(gsize, gsize, zone * zone)
    med_diff = disc_median(flat[..., disc_idx])              # (g, g)

    mag = torch.abs(med_diff)
    is_stone = mag > PRESENCE_THRESH
    color = torch.where(med_diff < 0, BLACK, WHITE).to(torch.int8)
    labels = torch.where(is_stone, color, EMPTY).to(torch.int8)
    conf = torch.where(
        is_stone,
        torch.clamp((mag - PRESENCE_THRESH) / (0.4 - PRESENCE_THRESH),
                    0.0, 1.0),
        torch.clamp(1.0 - mag / PRESENCE_THRESH, 0.0, 1.0))

    votes, stable, out_conf = vote_update(votes, stable, labels, conf,
                                          zone_calm, cfg)

    # Background learning: only pixels of zones that are stably EMPTY, read
    # empty *right now*, and are calm. Gating on the stable state alone
    # loses a race: a fresh stone needs ~6 frames of votes to commit, and
    # the EMA would absorb a third of its contrast meanwhile.
    empty_zone = (stable == EMPTY).to(torch.float32) \
        * (labels == EMPTY).to(torch.float32) * zone_calm
    pixel_mask = empty_zone[:, None, :, None] \
        .expand(gsize, zone, gsize, zone).reshape(gsize * zone, gsize * zone)
    rate = BG_EMA * pixel_mask
    bg = bg * (1.0 - rate) + luma * rate
    return votes, stable, bg, out_conf


def step_frame(state: BgSubState, canonical: torch.Tensor,
               gsize: int = guiconf.gsize, zone: int = cvconf.zone_size,
               cfg: cvconf.VisionConfig = cvconf.DEFAULT):
    """One frame of the scan: canonical (S, S, 3) in [0, 1] → (state,
    (labels (g, g) int8, conf (g, g), agitation ())). A loop of it over
    frames gives ``_scan_canonical``'s outputs, bitwise."""
    luma = rgb_to_gray(canonical)                            # (S, S)
    small = background.downsample_luma(luma, GATE_FACTOR)
    prev = torch.where(state.prev[:1, :1] < 0, small, state.prev)
    zone_calm, agitation = zone_motion_gate(small, prev, gsize)
    disc_idx = _zone_constants(gsize, zone, canonical.device)[2]
    votes, stable, bg, out_conf = _step(
        state.votes, state.stable, state.bg, luma, small, zone_calm,
        disc_idx, gsize, zone, cfg)
    new_state = BgSubState(votes=votes, stable=stable, bg=bg, prev=small,
                           frame_count=state.frame_count + 1)
    return new_state, (stable, out_conf, agitation)


def read_batch(state: BgSubState, frames: torch.Tensor,
               corners: torch.Tensor, gsize: int = guiconf.gsize,
               zone: int = cvconf.zone_size, valid_count: int | None = None,
               lens=None):
    """The background-subtraction finder over a batch of frames.

    frames: (B, H, W, 3) uint8 (or float in [0, 1]); corners: (4, 2) fixed
    or (B, 4, 2) per-frame, raw frame positions; lens: the camera's
    ``ops.lens.Lens`` or None. valid_count: a Python int, the frames at
    index ≥ it being capture padding: they read against the carry of the
    last real frame and leave every field of it untouched.
    Returns (state, labels (B, g, g) int8, conf (B, g, g), agitation (B,)).
    """
    scale = 1.0 / 255.0 if frames.dtype == torch.uint8 else 1.0
    warp = warp_batch_chunked if corners.ndim == 3 else warp_batch_fixed
    canon = warp(frames, corners.to(torch.float32), gsize, zone, scale=scale,
                 lens=lens)
    return _scan_canonical(state, canon, gsize, zone, valid_count)


def _scan_canonical(state: BgSubState, canon: torch.Tensor, gsize: int,
                    zone: int, valid_count: int | None = None):
    """``read_batch`` after its warp: canonical frames (B, S, S, 3) float
    in [0, 1] through the carry."""
    b = canon.shape[0]
    n_valid = b if valid_count is None else max(0, min(int(valid_count), b))
    dev = canon.device
    luma = rgb_to_gray(canon)                                # (B, S, S)
    small = background.downsample_luma(luma, GATE_FACTOR)    # (B, s, s)

    # Frame i's predecessor is the last real frame before it (padding
    # follows the last real one), the first's the carried one, or itself
    # while the carry holds its sentinel.
    before = torch.clamp(torch.arange(b, device=dev), max=n_valid) - 1
    first = torch.where(state.prev[:1, :1] < 0, small, state.prev)
    prevs = torch.where((before < 0)[:, None, None], first,
                        small[torch.clamp(before, min=0)])
    zone_calm, agitation = zone_motion_gate(small, prevs, gsize)

    disc_idx = _zone_constants(gsize, zone, dev)[2]
    cfg = cvconf.DEFAULT
    votes, stable, bg = state.votes, state.stable, state.bg
    out_labels, out_conf = [], []
    for i in range(b):
        new = _step(votes, stable, bg, luma[i], small[i], zone_calm[i],
                    disc_idx, gsize, zone, cfg)
        out_labels.append(new[1])
        out_conf.append(new[3])
        if i < n_valid:
            votes, stable, bg = new[:3]
    new_state = BgSubState(
        votes=votes, stable=stable, bg=bg,
        prev=small[n_valid - 1] if n_valid else state.prev,
        frame_count=state.frame_count + n_valid)
    return new_state, torch.stack(out_labels), torch.stack(out_conf), \
        agitation


def reset_votes(state: BgSubState, positions) -> BgSubState:
    """Invalidate votes (and the stable reading) at (row, col) positions."""
    votes = state.votes.clone()
    stable = state.stable.clone()
    for r, c in positions:
        votes[r, c] = 0.0
        stable[r, c] = 0
    return state._replace(votes=votes, stable=stable)


# ---------------------------------------------------------------------------
# Host finder class (cvconf-registered).
# ---------------------------------------------------------------------------

from camkifu_tpu_torch.core.feeder import host_read, to_device  # noqa: E402
from camkifu_tpu_torch.stone.stonesfinder import StonesFinder as _SF  # noqa: E402


class SfBgSub(_SF):
    """Background-subtraction finder host: carries the scan state across
    batches; corrections invalidate votes. Each batch's labels and
    agitation come to the host in one ``host_read``."""

    label = "bgsub"

    def __init__(self, vmanager):
        super().__init__(vmanager)
        self.state = init_state(gsize=self.gsize,
                                device=getattr(vmanager, "device", "cuda"))

    def _find(self, frames, corners):
        n = self._batch_valid
        vc = None if n is None or n >= frames.shape[0] else int(n)
        self.state, labels, conf, agitation = read_batch(
            self.state, frames,
            to_device(np.asarray(corners, np.float32), frames.device),
            gsize=self.gsize, valid_count=vc, lens=self._bf_lens())
        labels, agitation = host_read(labels, agitation)
        self.metadata["agitation"] = round(float(agitation.mean()), 4)
        return labels, conf

    def _invalidate(self, positions) -> None:
        self.state = reset_votes(self.state, positions)
