"""Whole-board k-means color classification: the device functions of
camkifu_tpu/stone/sf_clustering.py.

Per-intersection local contrast (disc mean − corner-median background)
is clustered by fixed-iteration k-means into black / wood / white, ordered
by luminance; clusters with too little contrast are read as empty, and
every intersection carries a confidence. Leading dims are a batch of
frames, where the reference vmaps.
"""

from __future__ import annotations

import functools

import torch

from camkifu_tpu_torch.config import cvconf, guiconf
from camkifu_tpu_torch.ops.kmeans import kmeans
from camkifu_tpu_torch.ops.zones import zone_stats

# Labels follow the gamemodel convention: 0=E, 1=B, 2=W.
EMPTY, BLACK, WHITE = 0, 1, 2

_LUMA = (0.299, 0.587, 0.114)

#: Minimum RGB-contrast norm (on [0,1] scale) for a cluster to count as
#: stones.
MIN_CLUSTER_CONTRAST = 0.15

#: Initial centroids in contrast space (gray): black, wood, white.
INIT_CONTRAST = (-0.35, 0.0, 0.35)


@functools.lru_cache(maxsize=8)
def _constants(device):
    """(initial centroids (3, 3), luma weights (3,), label of each
    luminance rank (3,) int8) on ``device``, made once: a tensor built from
    Python numbers is a copy the host waits for. Read only."""
    return (torch.tensor([[c, c, c] for c in INIT_CONTRAST],
                         dtype=torch.float32, device=device),
            torch.tensor(_LUMA, dtype=torch.float32, device=device),
            torch.tensor([BLACK, EMPTY, WHITE], dtype=torch.int8,
                         device=device))


def _classify_contrast(contrast: torch.Tensor, g: int, iters: int = 8):
    """k-means classification of (..., g·g, 3) per-channel local contrast
    → (labels (..., g, g) int8, confidence (..., g, g))."""
    lead = contrast.shape[:-2]
    init, luma, rank_to_label = _constants(contrast.device)
    cents, raw_labels, _ = kmeans(contrast, init, k=3, iters=iters)
    raw = raw_labels.long()

    # Order clusters by luminance of their contrast: most negative = black.
    cluster_luma = cents @ luma                                  # (..., 3)
    rank = torch.argsort(torch.argsort(cluster_luma, dim=-1, stable=True),
                         dim=-1, stable=True)
    labels = rank_to_label[torch.gather(rank, -1, raw)]

    # A "stone" cluster whose centroid contrast norm is too weak is
    # degenerate (few/no stones of that color): its members are empty.
    cluster_mag = torch.linalg.vector_norm(cents, dim=-1)        # (..., 3)
    member_strong = torch.gather(cluster_mag >= MIN_CLUSTER_CONTRAST, -1, raw)
    labels = torch.where(member_strong | (labels == EMPTY), labels,
                         torch.zeros_like(labels))

    # Confidence from the sample's own contrast norm.
    mag = torch.linalg.vector_norm(contrast, dim=-1)             # (..., g*g)
    conf_stone = torch.clamp((mag - MIN_CLUSTER_CONTRAST)
                             / (0.45 - MIN_CLUSTER_CONTRAST), 0.0, 1.0)
    conf_empty = torch.clamp(1.0 - mag / MIN_CLUSTER_CONTRAST, 0.0, 1.0)
    conf = torch.where(labels == EMPTY, conf_empty, conf_stone)
    return labels.reshape(*lead, g, g), conf.reshape(*lead, g, g)


def classify_stats(stats: dict, iters: int = 8):
    """Classify from shared zone statistics (ops.zones.zone_stats)."""
    contrast = stats["disc_mean_rgb"] - stats["bg_rgb"]     # (..., g, g, 3)
    g = contrast.shape[-2]
    return _classify_contrast(
        contrast.reshape(*contrast.shape[:-3], g * g, 3), g, iters)


def classify_canonical(canonical: torch.Tensor, gsize: int = guiconf.gsize,
                       zone: int = cvconf.zone_size):
    """Canonical image(s) (..., S, S, 3) in [0, 1] → (labels, confidence)."""
    return classify_stats(zone_stats(canonical, gsize, zone))


# ---------------------------------------------------------------------------
# Host finder class (cvconf-registered; SURVEY §2.1 sf_clustering), copied
# from camkifu_tpu/stone/sf_clustering.py.
# ---------------------------------------------------------------------------

import numpy as np  # noqa: E402

from camkifu_tpu_torch.core.feeder import to_device  # noqa: E402
from camkifu_tpu_torch.stone.stonesfinder import StonesFinder as _SF  # noqa: E402


class SfClustering(_SF):
    """Whole-board k-means finder host: per-frame classification, no
    temporal state (the meta finder adds votes)."""

    label = "clustering"

    def _find(self, frames, corners):
        from camkifu_tpu_torch import pipeline

        return pipeline.read_board_batch(
            frames, to_device(np.asarray(corners, np.float32), frames.device),
            gsize=self.gsize, lens=self._bf_lens())
