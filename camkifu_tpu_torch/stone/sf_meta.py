"""SfMeta's device half (port of camkifu_tpu/stone/sf_meta.py): contours
and clustering readings, per-region trust, motion gating and the temporal
vote scan over a batch of frames.

The classifiers and the motion gate are stateless per frame and run on the
whole batch at once. Only the carry (votes, stable board, background,
region trust) is sequential: the reference's ``lax.scan`` becomes a Python
loop over frames whose every branch is a ``torch.where``, so the loop
never waits for the device.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from camkifu_tpu_torch.config import cvconf, guiconf
from camkifu_tpu_torch.ops import background
from camkifu_tpu_torch.ops.color import rgb_to_gray
from camkifu_tpu_torch.ops.warp import warp_batch_fixed
from camkifu_tpu_torch.ops.zones import zone_stats
from camkifu_tpu_torch.stone import sf_clustering, sf_contours
from camkifu_tpu_torch.stone.votes import vote_update, zone_motion_gate

#: Region-trust EMA rate and the threshold above which a region switches
#: from contours to clustering (the reference's calibration→search promote).
TRUST_EMA = 0.08
TRUST_PROMOTE = 0.9

#: Background downsample factor (canonical → bg grid).
BG_FACTOR = 4


class MetaState(NamedTuple):
    """The scan carry: fixed-shape tensors on one device."""
    votes: torch.Tensor        # (g, g, 3) float32 decayed per-label votes
    stable: torch.Tensor       # (g, g) int8 — last committed board reading
    bg: torch.Tensor           # (S/f, S/f) float32 EMA luma background
    prev: torch.Tensor         # (S/f, S/f) float32 previous-frame luma
    trust: torch.Tensor        # (3, 3) float32 region agreement EMA
    frame_count: torch.Tensor  # () int32


_DTYPES = {"votes": torch.float32, "stable": torch.int8,
           "bg": torch.float32, "prev": torch.float32,
           "trust": torch.float32, "frame_count": torch.int32}


def init_state(gsize: int = guiconf.gsize, zone: int = cvconf.zone_size,
               device="cuda") -> MetaState:
    """A fresh scan carry on ``device`` (the card unless the caller asks
    for the CPU)."""
    s = gsize * zone // BG_FACTOR
    f32 = dict(dtype=torch.float32, device=device)
    return MetaState(
        votes=torch.zeros((gsize, gsize, 3), **f32),
        stable=torch.zeros((gsize, gsize), dtype=torch.int8, device=device),
        bg=torch.full((s, s), -1.0, **f32),      # -1 → "uninitialized"
        prev=torch.full((s, s), -1.0, **f32),
        trust=torch.zeros((3, 3), **f32),
        frame_count=torch.zeros((), dtype=torch.int32, device=device),
    )


def meta_state_from_numpy(state, device="cuda") -> MetaState:
    """A state on ``device`` from numpy-convertible arrays — a dict by field name or any
    object with the fields as attributes (the reference's ``MetaState``)
    — so a scan started elsewhere continues here."""
    get = state.__getitem__ if isinstance(state, dict) else \
        functools.partial(getattr, state)
    return MetaState(**{
        name: torch.as_tensor(np.array(get(name)), device=device)
        .to(dtype) for name, dtype in _DTYPES.items()})


def meta_state_to_numpy(state: MetaState) -> dict:
    """The state as a dict of numpy arrays, by field name."""
    return {name: getattr(state, name).cpu().numpy() for name in _DTYPES}


def _region_index(gsize: int) -> np.ndarray:
    """(g, g) int: which of the 3×3 sub-boards each intersection belongs to."""
    thirds = np.minimum(np.arange(gsize) * 3 // gsize, 2)
    return (thirds[:, None] * 3 + thirds[None, :]).astype(np.int32)


@functools.lru_cache(maxsize=8)
def _regions(gsize: int, device):
    """(flat region index (g·g,) int64, intersections per region (9,))."""
    region = _region_index(gsize).reshape(-1)
    counts = np.bincount(region, minlength=9).astype(np.float32)
    return (torch.as_tensor(region, dtype=torch.int64, device=device),
            torch.as_tensor(counts, device=device))


def read_batch(state: MetaState, frames: torch.Tensor,
               corners: torch.Tensor, gsize: int = guiconf.gsize,
               zone: int = cvconf.zone_size, neural_params=None,
               valid_count=None):
    """The meta state machine over a batch of frames.

    frames: (B, H, W, 3) uint8 (or float in [0, 1] on the CPU); corners:
    (4, 2), one fixed camera. valid_count: frames at index ≥ it are
    capture padding (repeats of the last real frame) and cast no votes.
    Returns (state, labels (B, g, g) int8, conf (B, g, g), agitation (B,)).
    """
    if corners.ndim == 3:
        raise NotImplementedError(
            "per-frame (B, 4, 2) corners belong to the tracking slice "
            "(warp_batch_chunked, rectify_track_batch), not ported yet")
    scale = 1.0 / 255.0 if frames.dtype == torch.uint8 else 1.0
    canon = warp_batch_fixed(frames, corners.to(torch.float32), gsize, zone,
                             scale=scale)
    return _scan_canonical(state, canon, gsize, zone, neural_params,
                           valid_count)


def _scan_canonical(state: MetaState, canon: torch.Tensor, gsize: int,
                    zone: int, neural_params=None, valid_count=None):
    """Classifiers + temporal vote scan over canonical frames (B, S, S, 3)
    float [0, 1]. Frames at index ≥ valid_count (if given) pass through
    without touching the carry."""
    if neural_params is not None:
        raise NotImplementedError(
            "the neural voter is ROADMAP Queue A item 8 (models/neural.py), "
            "not ported yet; no checkpoint ships")
    b = canon.shape[0]
    dev = canon.device
    luma_small = background.downsample_luma(rgb_to_gray(canon), BG_FACTOR)

    # One shared zone-statistics pass feeds both classifiers.
    stats = zone_stats(canon, gsize, zone)
    lab_cont, conf_cont = sf_contours.classify_stats(stats, zone)
    lab_clus, conf_clus = sf_clustering.classify_stats(stats)
    del stats
    lab_nn = torch.zeros_like(lab_cont)
    conf_nn = torch.full_like(conf_cont, -1.0)

    # Motion gates: prev of frame i is frame i−1 (the state carries the
    # batch boundary).
    prev0 = torch.where(state.prev[0, 0] < 0, luma_small[0], state.prev)
    prevs = torch.cat([prev0[None], luma_small[:-1]])
    zone_calm, agitation = zone_motion_gate(luma_small, prevs, gsize)

    region, counts = _regions(gsize, dev)
    agree = (lab_cont == lab_clus).to(torch.float32).reshape(b, -1)
    region_agree = (torch.zeros((b, 9), dtype=torch.float32, device=dev)
                    .index_add_(1, region, agree) / counts).reshape(b, 3, 3)

    cfg = cvconf.DEFAULT
    if valid_count is None:
        valid = torch.ones((b,), dtype=torch.bool, device=dev)
    else:
        valid = torch.arange(b, device=dev) < valid_count

    votes, stable, bg, trust = state.votes, state.stable, state.bg, \
        state.trust
    out_labels, out_conf = [], []
    for i in range(b):
        calm_scalar = agitation[i] <= cfg.agitation_threshold
        new_trust = torch.where(
            calm_scalar, trust * (1 - TRUST_EMA) + region_agree[i] * TRUST_EMA,
            trust)
        trust_per = new_trust.reshape(-1)[region].reshape(gsize, gsize)
        # Eligible readings compete by confidence: contours always,
        # clustering once its region's trust promotes.
        ck_eff = torch.where(trust_per >= TRUST_PROMOTE, conf_clus[i], -1.0)
        confs = torch.stack([conf_cont[i], ck_eff, conf_nn[i]])  # (3, g, g)
        labs = torch.stack([lab_cont[i], lab_clus[i], lab_nn[i]])
        pick = torch.argmax(confs, dim=0, keepdim=True)
        labels = torch.gather(labs, 0, pick)[0]
        conf = torch.gather(confs, 0, pick)[0]
        new_votes, new_stable, new_conf = vote_update(
            votes, stable, labels, conf, zone_calm[i], cfg)
        new_bg = background.update_background(
            torch.where(bg[0, 0] < 0, luma_small[i], bg), luma_small[i],
            agitation[i], cfg.background_ema)
        # Padded frames emit the current stable reading but leave the carry
        # untouched.
        old_conf = torch.clamp(votes.amax(dim=-1) / cfg.vote_window, 0.0, 1.0)
        v = valid[i]
        votes = torch.where(v, new_votes, votes)
        stable = torch.where(v, new_stable, stable)
        bg = torch.where(v, new_bg, bg)
        trust = torch.where(v, new_trust, trust)
        out_labels.append(stable)
        out_conf.append(torch.where(v, new_conf, old_conf))

    new_state = MetaState(
        votes=votes, stable=stable, bg=bg, prev=luma_small[-1], trust=trust,
        frame_count=state.frame_count + valid.sum().to(torch.int32))
    return new_state, torch.stack(out_labels), torch.stack(out_conf), \
        agitation


# -- host-side state surgery (human-correction feedback) ---------------------

def reset_votes(state: MetaState, positions) -> MetaState:
    """Invalidate votes (and the stable reading) at (row, col) positions so a
    corrected misread does not immediately re-suggest."""
    votes = state.votes.clone()
    stable = state.stable.clone()
    for r, c in positions:
        votes[r, c] = 0.0
        stable[r, c] = 0
    return state._replace(votes=votes, stable=stable)


def set_stable(state: MetaState, board: np.ndarray) -> MetaState:
    """Force the stable reading (e.g. on resume from an SGF: the loaded
    game's board state is ground truth) and clear the votes."""
    return state._replace(
        stable=torch.as_tensor(board.astype(np.int8),
                               device=state.stable.device),
        votes=torch.zeros_like(state.votes))
