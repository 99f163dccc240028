"""The vision pipeline on tensors: frame batches in, board readings out
(port of camkifu_tpu/pipeline.py, fixed-camera path).

  uint8 frames (B, H, W, 3)
    → warp to canonical (B, S, S, 3) float [0,1]     (ops.warp, CUDA kernel)
    → per-frame stone classify                        (stone.sf_clustering)
    → labels (B, g, g) int8, confidence (B, g, g)
"""

from __future__ import annotations

import torch

from camkifu_tpu_torch.config import cvconf, guiconf
from camkifu_tpu_torch.ops.warp import warp_batch_fixed
from camkifu_tpu_torch.stone import sf_clustering


def read_board_batch(frames: torch.Tensor, corners: torch.Tensor,
                     gsize: int = guiconf.gsize,
                     zone: int = cvconf.zone_size):
    """Fixed corners, per-frame clustering classification, no temporal
    state.

    frames: (B, H, W, 3) uint8 (or float in [0, 1] on the CPU).
    corners: (4, 2) float32, one fixed camera. Per-frame (B, 4, 2) corners
    belong to the tracking slice and raise NotImplementedError.
    Returns (labels (B, g, g) int8, confidence (B, g, g) float32).

    Everything runs in float32 (TF32 stays off): the homography and the
    zone statistics are small but accuracy-critical.
    """
    # Warp straight from uint8 (the kernel converts only its taps) and
    # fuse the 1/255 rescale into the warp's store.
    scale = 1.0 / 255.0 if frames.dtype == torch.uint8 else 1.0
    canon = warp_batch_fixed(frames, corners.to(torch.float32), gsize, zone,
                             scale=scale)
    return sf_clustering.classify_canonical(canon, gsize, zone)
