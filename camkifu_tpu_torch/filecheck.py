"""The recorded-video path on tensors (port of ``run_pipeline`` in
camkifu_tpu/filecheck.py, with the SfMeta vote scan and no neural voter).

  uint8 frames, in batches (host) → .to(device)
    → first batch only: bf_auto.detect_batch_stable → fixed corners (4, 2)
    → sf_meta.read_batch (warp kernel → zone stats → contours + clustering
      → motion gate → vote scan) → stable labels (B, g, g)
    → host MoveExtractor → moves

Batching and move extraction are the reference's host code, imported
as they are (they use numpy only). Reading a video file needs cv2, so the
port takes frames from any iterator of (H, W, 3) uint8 arrays.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from camkifu_tpu.config import cvconf, guiconf
from camkifu_tpu.core.gamesync import MoveExtractor
from camkifu_tpu.filecheck import batched
from camkifu_tpu_torch.board import bf_auto
from camkifu_tpu_torch.stone import sf_meta


def run_pipeline(frames_iter, corners: np.ndarray | None = None,
                 batch: int = cvconf.frame_batch,
                 gsize: int = guiconf.gsize,
                 extractor: MoveExtractor | None = None,
                 device="cpu"):
    """Drive the pipeline over all frames on ``device``; return (extractor,
    stats).

    corners=None → automatic board detection, once, on the first batch
    (``detect_batch_stable``: a fixed camera); otherwise the fixed (4, 2)
    corner set is used. The tail batch is padded by repeating its last
    frame, and the padding casts no votes.
    """
    device = torch.device(device)
    extractor = extractor or MoveExtractor(gsize=gsize)
    corners_dev = None if corners is None else torch.as_tensor(
        np.asarray(corners, np.float32), device=device)
    state = sf_meta.init_state(gsize=gsize, device=device)
    n_frames = 0
    t0 = time.perf_counter()
    for fb, n in batched(frames_iter, batch):
        frames = torch.from_numpy(fb).to(device)
        if corners_dev is None:
            corners_dev = bf_auto.detect_batch_stable(frames, gsize=gsize)
        state, labels, _conf, _agit = sf_meta.read_batch(
            state, frames, corners_dev, gsize=gsize,
            valid_count=n if n < frames.shape[0] else None)
        labels = labels.cpu().numpy()
        for i in range(n):
            extractor.advance(labels[i])
        n_frames += n
    dt = time.perf_counter() - t0
    return extractor, {"frames": n_frames, "seconds": dt,
                       "fps": n_frames / dt if dt > 0 else 0.0,
                       "corners": (None if corners_dev is None else
                                   corners_dev.cpu().numpy().tolist())}
