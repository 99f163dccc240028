"""A camera fixed over its board: every frame shows the board at the still
renderer's ``default_corners``."""

from __future__ import annotations

import numpy as np

from benchmark.traffic.generator import default_corners


def pinhole(cam: dict, frame_hw, n_frames: int, place: int,
            n_streams: int) -> np.ndarray:
    corners = default_corners(frame_hw, cam["perspective"])
    return np.broadcast_to(corners, (n_frames, 4, 2))
