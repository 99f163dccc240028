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


def classify_features(feats: torch.Tensor, iters: int = 8):
    """Classify all intersections from zone features (..., g, g, 7)
    (``ops.zones.zone_features``, values scaled to [0, 1]) → (labels
    (..., g, g) int8 ∈ {E, B, W}, confidence (..., g, g) in [0, 1])."""
    g = feats.shape[-2]
    contrast = feats[..., 0:3] - feats[..., 3:6]
    return _classify_contrast(
        contrast.reshape(*contrast.shape[:-3], g * g, 3), g, iters)


def _classify_contrast(contrast: torch.Tensor, g: int, iters: int = 8):
    """k-means classification of (..., g·g, 3) per-channel local contrast
    → (labels (..., g, g) int8, confidence (..., g, g))."""
    lead = contrast.shape[:-2]
    init, luma, rank_to_label = _constants(contrast.device)
    cents, raw_labels, _ = kmeans(contrast, k=3, iters=iters, init=init)
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


def _probe_main(argv=None) -> int:
    """Golden-input probe (SURVEY §4), the reference's ``__main__``: read
    the stones on one image file and print the board. The image is read on
    the host through cv2; corners come from the optional second argument
    (8 comma-separated floats, tl/tr/br/bl) or from ``bf_auto``'s
    detection, and everything after the read runs on ``--device``
    (default the card)."""
    import argparse
    import sys

    import cv2

    from camkifu_tpu_torch.board import bf_auto
    from camkifu_tpu_torch.ops.warp import warp_to_canonical
    from camkifu_tpu_torch.utils import board_to_ascii

    ap = argparse.ArgumentParser(prog="sf_clustering",
                                 description=_probe_main.__doc__)
    ap.add_argument("image")
    ap.add_argument("corners", nargs="?", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    img = cv2.imread(args.image)
    if img is None:
        sys.exit(f"cannot read image: {args.image}")
    frame = to_device(img[:, :, ::-1].copy(), args.device)
    if args.corners:
        vals = [float(v) for v in args.corners.split(",")]
        corners = to_device(np.array(vals, np.float32).reshape(4, 2),
                            args.device)
    else:
        corners, score = bf_auto.detect_corners(frame)
        print("auto-detected corners, score", float(score))
    canon = warp_to_canonical(frame, corners) / 255.0
    labels, conf = classify_canonical(canon)
    labels = labels.cpu().numpy()
    print(board_to_ascii(labels))
    print(f"stones: {int((labels != 0).sum())}, "
          f"min conf {float(conf.min()):.2f}")
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(_probe_main())
