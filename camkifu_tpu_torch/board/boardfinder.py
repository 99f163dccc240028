"""BoardFinder ABC + corner container.

Parity: ``camkifu/board/boardfinder.py`` (SURVEY §2.1) — the contract:
consume raw frames, produce a stable homography; supports re-detection after
a camera bump. ``GobanCorners`` auto-orders clicked/detected points into
tl/tr/br/bl via the convex-hull convention and reports readiness at 4.

Copied from camkifu_tpu/board/boardfinder.py. The published homography
``mtx`` is a host value (GUI overlay, fixed-corner readers): it is solved
on the CPU by the port's ``ops.warp.homography_dlt``.
"""

from __future__ import annotations

import numpy as np

import torch

from camkifu_tpu_torch.config import cvconf, guiconf
from camkifu_tpu_torch.core.video import VidProcessor
from camkifu_tpu_torch.ops.warp import canonical_corners, homography_dlt


def order_corners(pts: np.ndarray) -> np.ndarray:
    """Order 4 (x, y) points tl/tr/br/bl (hull walk, image y down)."""
    pts = np.asarray(pts, np.float32)
    ctr = pts.mean(axis=0)
    ang = np.arctan2(pts[:, 1] - ctr[1], pts[:, 0] - ctr[0])
    ordered = pts[np.argsort(ang)]
    roll = int(np.argmin(ordered.sum(axis=1)))
    ordered = np.roll(ordered, -roll, axis=0)
    if ordered[1, 0] < ordered[3, 0]:      # enforce clockwise on screen
        ordered = ordered[[0, 3, 2, 1]]
    return ordered


class GobanCorners:
    """Up to 4 corner points with auto-ordering and adjust-nearest."""

    def __init__(self, points=None):
        self._points: list[tuple[float, float]] = []
        if points is not None:
            for p in points:
                self.add(p)

    def add(self, point) -> None:
        x, y = float(point[0]), float(point[1])
        if len(self._points) == 4:
            # Click near an existing corner adjusts it (reference behavior).
            d = [np.hypot(px - x, py - y) for px, py in self._points]
            self._points[int(np.argmin(d))] = (x, y)
        else:
            self._points.append((x, y))

    def clear(self) -> None:
        self._points = []

    def ready(self) -> bool:
        return len(self._points) == 4

    def __len__(self) -> int:
        return len(self._points)

    @property
    def points(self) -> np.ndarray | None:
        if not self.ready():
            return None
        return order_corners(np.array(self._points, np.float32))


class BoardFinder(VidProcessor):
    """Base: periodically ``_detect`` and publish corners + homography."""

    label = "bf-base"

    def __init__(self, vmanager):
        super().__init__(vmanager)
        controller = getattr(vmanager, "controller", None)
        self.gsize = controller.kifu.gsize if controller is not None \
            else guiconf.gsize
        self.corners = GobanCorners()
        self.mtx: np.ndarray | None = None   # canonical→frame homography
        #: Per-frame corners (B, 4, 2) for the LAST processed batch, set by
        #: finders that measure them (BoardFinderAuto tracking); stones
        #: finders that accept a corner batch consume this instead of the
        #: fixed estimate (BASELINE config 4 runtime path).
        self.corners_batch: np.ndarray | None = None
        self._since_detect = 10 ** 9

    def ready(self) -> bool:
        return self.mtx is not None

    @property
    def corners_array(self) -> np.ndarray | None:
        return self.corners.points

    def _doframe(self, frames, n: int | None = None) -> None:
        # Padded tail frames are copies of the last real one (capture.
        # pad_batch), so detection may safely look at the whole batch.
        self._since_detect += 1
        if self.ready() and self._since_detect < cvconf.bf_period:
            return
        if self._detect(frames):
            self._since_detect = 0
            self._publish()

    def _detect(self, frames) -> bool:
        raise NotImplementedError

    def _publish(self) -> None:
        pts = self.corners.points
        if pts is None:
            return
        self.mtx = homography_dlt(
            canonical_corners(self.gsize, cvconf.zone_size),
            torch.from_numpy(pts)).numpy()
        self.metadata["corners"] = pts.round(1).tolist()
