"""SfMeta (port of camkifu_tpu/stone/sf_meta.py): contours and clustering
readings (and a trained net's, the opt-in third voter), per-region trust,
motion gating and the temporal vote scan over a batch of frames, and the
host finder class that carries the scan state across batches (the pose
veto, SGF resume, vote invalidation).

The classifiers and the motion gate are stateless per frame and run on the
whole batch at once. Only the carry (votes, stable board, background,
region trust) is sequential: the reference's ``lax.scan`` becomes
``ops.cuda.vote_scan_kernel.vote_scan``, one kernel launch for every
stream and frame on the card, and a Python loop over frames whose every
branch is a ``torch.where`` on the CPU. Neither waits for the device.
"""

from __future__ import annotations

import functools
import os
from typing import NamedTuple

import numpy as np
import torch

from camkifu_tpu_torch.board.bf_auto import rectify_track_batch
from camkifu_tpu_torch.config import cvconf, guiconf
from camkifu_tpu_torch.models import neural
from camkifu_tpu_torch.ops import background
from camkifu_tpu_torch.ops.color import rgb_to_gray
from camkifu_tpu_torch.ops.cuda.vote_scan_kernel import TRUST_PROMOTE, \
    regions, vote_scan
from camkifu_tpu_torch.ops.warp import warp_batch_chunked, warp_batch_fixed
from camkifu_tpu_torch.ops.zones import zone_stats
from camkifu_tpu_torch.stone import sf_clustering, sf_contours
from camkifu_tpu_torch.stone.sf_neural import zone_probs
from camkifu_tpu_torch.stone.votes import zone_motion_gate
from camkifu_tpu_torch.utils.profiling import span

#: Background downsample factor (canonical → bg grid).
BG_FACTOR = 4

#: Pose veto (SfMeta._pose_vetoed): minimum committed stones for the check
#: to be meaningful, and the minimum fraction of them a freshly anchored
#: pose's readings must reproduce. A correct anchor reads ≥~0.9 of the
#: committed stones even under capture lag / a hand in frame. An impostor
#: pose does NOT read them at ~⅓ chance: Go colors cluster spatially, so
#: on a saturated board a lattice several cells off still agrees on the
#: interior of every large group (measured in the reference: 0.69
#: agreement at 5 cells off, 200 stones, 17° camera) — only the group
#: boundaries scramble. 0.8 sits between the measured impostor ceiling and
#: the correct-anchor floor.
POSE_VETO_MIN_STONES = 15
POSE_VETO_MIN_AGREE = 0.8

#: The trained neural voter SfMeta picks up (``models.neural.DEFAULT_CKPT``).
NEURAL_CKPT = neural.DEFAULT_CKPT

#: Where the reference keeps its voter: an orbax directory, which the port
#: does not read (camkifu_tpu/models/neural.py ``DEFAULT_CKPT``).
JAX_NEURAL_CKPT = "~/.camkifu_tpu/sf_neural_ckpt"


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


def read_batch(state: MetaState, frames: torch.Tensor,
               corners: torch.Tensor, gsize: int = guiconf.gsize,
               zone: int = cvconf.zone_size, neural_params=None,
               valid_count=None, lens=None):
    """The meta state machine over a batch of frames.

    frames: (B, H, W, 3) uint8 (or float in [0, 1] on the CPU); corners:
    (4, 2), one fixed camera, or (B, 4, 2), one set per frame (a tracked
    camera, through ``warp_batch_chunked``), raw frame positions.
    neural_params: a trained ``models.neural.PatchNet``, the third voter,
    or None. valid_count: frames at index ≥ it are capture padding
    (repeats of the last real frame) and cast no votes. lens: an
    ``ops.lens.Lens`` of the camera, or None for a pinhole one.
    Returns (state, labels (B, g, g) int8, conf (B, g, g), agitation (B,)).
    """
    scale = 1.0 / 255.0 if frames.dtype == torch.uint8 else 1.0
    warp = warp_batch_chunked if corners.ndim == 3 else warp_batch_fixed
    canon = warp(frames, corners.to(torch.float32), gsize, zone, scale=scale,
                 lens=lens)
    return _scan_canonical(state, canon, gsize, zone, neural_params,
                           valid_count)


def _scan_canonical(state: MetaState, canon: torch.Tensor, gsize: int,
                    zone: int, neural_params=None, valid_count=None):
    """Classifiers + temporal vote scan over canonical frames (B, S, S, 3)
    float [0, 1]. Frames at index ≥ valid_count (if given) pass through
    without touching the carry. One stream of ``scan_streams``."""
    states = MetaState(*(x[None] for x in state))
    new_states, labels, conf, agitation = scan_streams(
        states, canon[None], gsize, zone, neural_params, valid_count)
    return MetaState(*(x[0] for x in new_states)), labels[0], conf[0], \
        agitation[0]


def scan_streams(states: MetaState, canon: torch.Tensor, gsize: int,
                 zone: int, neural_params=None, valid_count=None):
    """``_scan_canonical`` of n independent streams at once: states whose
    every field has a leading stream dim (``frame_count`` (n,)), canonical
    frames (n, B, S, S, 3). The classifiers and motion gate run on all n·B
    frames at once; the loop is over frames, each step updating every
    stream's carry. Returns (states, labels (n, B, g, g) int8, conf
    (n, B, g, g), agitation (n, B))."""
    if neural_params is not None \
            and not isinstance(neural_params, neural.PatchNet):
        raise TypeError("neural_params is a models.neural.PatchNet "
                        "(params_from_jax converts a flax tree)")
    n, b = canon.shape[0], canon.shape[1]
    dev = canon.device
    with span("camkifu.scan_streams.classify"):
        flat = canon.reshape(n * b, *canon.shape[2:])
        luma_small = background.downsample_luma(rgb_to_gray(flat), BG_FACTOR)

        # One shared zone-statistics pass feeds both classifiers.
        stats = zone_stats(flat, gsize, zone)
        lab_cont, conf_cont = sf_contours.classify_stats(stats, zone)
        lab_clus, conf_clus = sf_clustering.classify_stats(stats)
        del stats
        lab_cont, conf_cont, lab_clus, conf_clus = (
            x.reshape(n, b, gsize, gsize)
            for x in (lab_cont, conf_cont, lab_clus, conf_clus))
        if neural_params is not None:
            # Third voter (opt-in: only when a trained checkpoint exists). It
            # competes per intersection by confidence like the others; its
            # softmax max is discounted (CNNs are overconfident) so it breaks
            # ties rather than overruling a decisive classical read.
            probs = zone_probs(neural_params, flat, gsize, zone) \
                .reshape(n, b, gsize, gsize, 3)
            lab_nn = torch.argmax(probs, dim=-1).to(torch.int8)
            conf_nn = 0.85 * probs.amax(dim=-1)
        else:
            lab_nn = torch.zeros_like(lab_cont)
            conf_nn = torch.full_like(conf_cont, -1.0)
        luma_small = luma_small.reshape(n, b, *luma_small.shape[1:])

        # Motion gates: prev of frame i is frame i−1 (each stream's state
        # carries its batch boundary).
        prev0 = torch.where(states.prev[:, :1, :1] < 0, luma_small[:, 0],
                            states.prev)
        prevs = torch.cat([prev0[:, None], luma_small[:, :-1]], dim=1)
        zone_calm, agitation = zone_motion_gate(luma_small, prevs, gsize)

        region, counts = regions(gsize, dev)
        agree = (lab_cont == lab_clus).to(torch.float32).reshape(n, b, -1)
        region_agree = (torch.zeros((n, b, 9), dtype=torch.float32, device=dev)
                        .index_add_(2, region, agree) / counts) \
            .reshape(n, b, 3, 3)
        n_valid = b if valid_count is None else min(max(valid_count, 0), b)

    with span("camkifu.scan_streams.votes"):
        labels, conf, (votes, stable, bg, trust) = vote_scan(
            (lab_cont, lab_clus, lab_nn), (conf_cont, conf_clus, conf_nn),
            zone_calm, agitation, region_agree, luma_small,
            tuple(x.contiguous() for x in (states.votes, states.stable,
                                           states.bg, states.trust)),
            n_valid)
        new_states = MetaState(
            votes=votes, stable=stable, bg=bg, prev=luma_small[:, -1],
            trust=trust, frame_count=states.frame_count + n_valid)
        return new_states, labels, conf, agitation


def track_read_batch(state: MetaState, frames: torch.Tensor,
                     seed_corners: torch.Tensor,
                     gsize: int = guiconf.gsize,
                     zone: int = cvconf.zone_size, chunk: int = 16,
                     neural_params=None, valid_count=None, lens=None):
    """The handheld engine: fused per-frame board tracking + rectification
    (``bf_auto.rectify_track_batch``), then classification and the vote
    scan on its canonical images. Nothing in it waits for the device.

    frames: (B, H, W, 3); seed_corners: (4, 2) from a full detection or
    the previous batch's ``new_seed`` (a host re-detects at its own
    cadence and re-anchors the seed). lens: the camera's ``ops.lens.Lens``
    (``bf_auto.estimate_lens_k1`` calibrates k1), or None.
    Returns (state, labels, conf, agitation, corners (B, 4, 2),
    sharpness (B,), align (B,), new_seed (4, 2)).
    """
    canon, corners, sharp, align, new_seed = rectify_track_batch(
        frames, seed_corners, gsize=gsize, zone=zone, chunk=chunk, lens=lens)
    new_state, labels, conf, agitation = _scan_canonical(
        state, canon, gsize, zone, neural_params, valid_count)
    return new_state, labels, conf, agitation, corners, sharp, align, new_seed


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


# ---------------------------------------------------------------------------
# Host finder class (default algorithm; SURVEY §2.1 sf_meta), copied from
# camkifu_tpu/stone/sf_meta.py. ``state`` (MetaState) lives on the device;
# each batch's labels, corners, sharpness, alignment, agitation and trust
# come to the host in one ``core.feeder.host_read``.
# ---------------------------------------------------------------------------

from camkifu_tpu_torch.core.feeder import host_read, to_device  # noqa: E402
from camkifu_tpu_torch.stone.stonesfinder import StonesFinder as _SF  # noqa: E402


def _neural_params(device):
    """The opt-in third voter: the trained net at ``NEURAL_CKPT`` on
    ``device``, or None when none was trained. A reference checkpoint
    without a port one raises, rather than read with two voters where the
    reference reads with three."""
    model = neural.load_params(NEURAL_CKPT, device=device)
    if model is None and os.path.isdir(os.path.expanduser(JAX_NEURAL_CKPT)):
        raise RuntimeError(
            f"a neural voter checkpoint of the JAX package is at "
            f"{JAX_NEURAL_CKPT} (orbax), which the port does not read; "
            f"convert it to {NEURAL_CKPT}: np.savez(path, **{{'/'.join(k): v "
            f"for k, v in the flattened jax.device_get(params)}}), keys "
            f"such as 'params/Conv_0/kernel'")
    return model


class SfMeta(_SF):
    """The production finder host: carries the device scan state across
    batches; human corrections invalidate votes at the touched positions."""

    label = "meta"

    #: BoardFinderAuto skips its separate tracking pass for this finder:
    #: tracking runs fused with rectification+classification here
    #: (track_read_batch — one gather instead of two per frame).
    fused_tracking = True

    def __init__(self, vmanager):
        super().__init__(vmanager)
        device = getattr(vmanager, "device", "cuda")
        self.state = init_state(gsize=self.gsize, device=device)
        # Opt-in neural voter: participates only if the user trained a
        # checkpoint; absent checkpoint = classical ensemble only.
        self.neural_params = _neural_params(device)
        if self.neural_params is not None:
            self.metadata["neural"] = "on"
        # --sgf resume: the loaded game's board is ground truth (SURVEY §5).
        if self.controller is not None:
            board = self.controller.stones()
            if board.any():
                self.state = set_stable(self.state, board)
                self._resync()

    def _doframe(self, frames, n=None) -> None:
        """Use the fused track+rectify+classify+scan pass when the board
        finder maintains a tracking seed (BoardFinderAuto); otherwise the
        classic path (fixed/manual corners) via the base class."""
        bf = getattr(self.vmanager, "board_finder", None)
        seed = getattr(bf, "track_seed", None)
        if seed is None:
            return super()._doframe(frames, n)
        (self.state, labels, conf, agitation, corners, sharp, align,
         new_seed) = track_read_batch(
            self.state, frames, seed, gsize=self.gsize,
            neural_params=self.neural_params,
            valid_count=self._valid_arg(frames, n),
            lens=getattr(bf, "lens", None))
        corners, sharp, align, labels, agitation, trust = host_read(
            corners, sharp, align, labels, agitation, self.state.trust)
        bf.report_tracking(corners, new_seed, float(sharp.mean()),
                           bf.batch_align(align, sharp))
        if getattr(bf, "suspect_batch", False):
            # Jump trip fired on this batch: the labels were read through
            # discontinuous corners (on_tracking_discontinuity already
            # reset the scan state) — never diff them into moves.
            self.metadata["status"] = "re-anchoring"
            return
        if getattr(bf, "fresh_anchor", False) \
                and self._pose_vetoed(labels, bf):
            return
        self._report(agitation, trust)
        self._consume(labels, n)

    def _pose_vetoed(self, labels, bf) -> bool:
        """Cross-check a freshly anchored pose against the committed game.

        Full detection can be confidently WRONG — measured: stone-saturated
        boards rotated ≥~14° in-plane detect 3–8 cells off at score
        0.27–0.35 (the 1D combs cannot express that basin). A pose that is
        cells off reads the committed stones scrambled, and within a vote
        window the bulk self-correction machinery would rewrite the entire
        kifu onto the impostor lattice. The committed game is the one
        ground truth that survives any camera event: if this batch's
        readings disagree with ≥(1−POSE_VETO_MIN_AGREE) of the committed
        stones, reject the pose (bf.reject_anchor — detection then re-runs
        every batch until a consistent pose appears) and discard the
        poisoned vote state. Below POSE_VETO_MIN_STONES committed stones
        the check is off: sparse boards are the line-dominated regime where
        detection is reliable (±25° envelope), and a handful of points
        cannot distinguish pose error from capture lag or an occluding
        hand.
        """
        committed = self.controller.stones() if self.controller is not None \
            else self.extractor.state()
        nz = committed != 0
        if int(nz.sum()) < POSE_VETO_MIN_STONES:
            return False
        lab = np.asarray(labels)                       # (B, g, g)
        agree = float((lab[:, nz] == committed[nz]).mean())
        self.metadata["pose_agreement"] = round(agree, 3)
        if agree >= POSE_VETO_MIN_AGREE:
            return False
        bf.reject_anchor()
        # The batch already folded into the scan state before the veto
        # could fire — re-seed perception from the committed game, as with
        # any discontinuity.
        self.state = set_stable(self.state, committed)
        self.metadata["status"] = "re-anchoring"
        return True

    @staticmethod
    def _valid_arg(frames, n):
        """The valid count of a padded batch as a Python int, None when
        full: the scan compares it with a device ``arange``, so nothing
        waits for the card."""
        if n is None or n >= frames.shape[0]:
            return None
        return int(n)

    def _find(self, frames, corners):
        self.state, labels, conf, agitation = read_batch(
            self.state, frames,
            to_device(np.asarray(corners, np.float32), frames.device),
            gsize=self.gsize, neural_params=self.neural_params,
            valid_count=self._valid_arg(frames, self._batch_valid),
            lens=self._bf_lens())
        labels, agitation, trust = host_read(labels, agitation,
                                             self.state.trust)
        self._report(agitation, trust)
        return labels, conf

    def _report(self, agitation: np.ndarray, trust: np.ndarray) -> None:
        self.metadata["agitation"] = round(float(agitation.mean()), 4)
        self.metadata["regions_promoted"] = int((trust >= TRUST_PROMOTE).sum())

    def _invalidate(self, positions) -> None:
        self.state = reset_votes(self.state, positions)

    def on_tracking_discontinuity(self) -> None:
        """Camera bump: the batch just folded into the scan state was read
        through wrong corners (on the fused path the evidence lands before
        the trip can fire). Re-seed perception from the game model — the
        committed kifu is the surviving ground truth — and zero the votes,
        discarding the poisoned accumulation."""
        board = self.controller.stones() if self.controller is not None \
            else self.extractor.state()
        self.state = set_stable(self.state, board)
