"""BoardFinderManual — user-clicked corners, persisted per input file.

Parity: ``camkifu/board/bf_manual.py`` (SURVEY §2.1) — left-click places the
next corner, a click near an existing corner adjusts it, and manual corner
locations persist per video file so re-opening reuses them. The fallback
when auto detection fails, and the ground-truth tool (SURVEY §4).

Beyond parity: once all four corners are placed, the finder calibrates the
radial lens model from the next frame batch (bf_auto.estimate_lens_k1_corners
— the clicked corners are ground truth, so calibration needs no detection)
and publishes it on ``self.lens`` exactly as BoardFinderAuto does; stone
finders consume it via ``_bf_lens`` and compose it into their sample
coordinates. Without this, manual mode was pinhole-only and interior stones
drifted ~1 cell mid-edge at webcam-typical k1 = 0.08.

Copied from camkifu_tpu/board/bf_manual.py. The calibration frame is a
frame of the manager's batch on the device; the corners persist in the
port's own store (``PERSIST_PATH``), apart from the reference's.
"""

from __future__ import annotations

import json
import os

import numpy as np

from camkifu_tpu_torch.board.bf_auto import estimate_lens_k1_corners
from camkifu_tpu_torch.board.boardfinder import BoardFinder
from camkifu_tpu_torch.ops.lens import make_lens

PERSIST_PATH = os.path.expanduser("~/.camkifu_tpu_torch/corners.json")


def _load_store() -> dict:
    try:
        with open(PERSIST_PATH, encoding="utf-8") as f:
            return json.load(f)
    except (FileNotFoundError, json.JSONDecodeError):
        return {}


def _save_store(store: dict) -> None:
    os.makedirs(os.path.dirname(PERSIST_PATH), exist_ok=True)
    tmp = PERSIST_PATH + ".tmp"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(store, f)
    os.replace(tmp, PERSIST_PATH)


class BoardFinderManual(BoardFinder):
    label = "manual"

    def __init__(self, vmanager):
        super().__init__(vmanager)
        self.lens = None
        self._lens_dirty = True   # (re)calibrate at the next frame batch
        # Corners persist per path or camera index only: in-memory frames
        # (and no video) have no name that tells one session from another.
        video = getattr(vmanager, "video", None)
        self.key = str(video) if isinstance(video, (str, int)) else None
        if self.key:
            saved = _load_store().get(self.key)
            if saved:
                for x, y in np.array(saved, np.float32).reshape(4, 2):
                    self.corners.add((x, y))
                self._publish()

    # -- user input (wired to GUI clicks or called programmatically) --------

    def onclick(self, x: float, y: float) -> None:
        self.corners.add((x, y))
        if self.corners.ready():
            self._publish()
            self._persist()
            self._lens_dirty = True

    def set_corners(self, points) -> None:
        """Set all four corners at once (tests, CLI --corners)."""
        self.corners.clear()
        for p in np.asarray(points, np.float32).reshape(4, 2):
            self.corners.add(p)
        self._publish()
        self._persist()
        self._lens_dirty = True

    def clear(self) -> None:
        self.corners.clear()
        self.mtx = None
        self.lens = None
        self._lens_dirty = True

    def _persist(self) -> None:
        if self.key and self.corners.ready():
            store = _load_store()
            store[self.key] = self.corners.points.reshape(-1).tolist()
            _save_store(store)

    # Manual mode does not detect anything per-frame, but it calibrates the
    # lens once per corner placement (the corners are user ground truth; the
    # probe needs only a frame with a visible lattice). Runs in the vision
    # worker thread like any detection; re-runs whenever corners change.
    def _detect(self, frames) -> bool:
        if self.corners.ready() and self._lens_dirty:
            frame = frames[len(frames) // 2]
            k1, gain = estimate_lens_k1_corners(
                frame, self.corners.points, gsize=self.gsize)
            self._lens_dirty = False
            self.metadata["lens_k1"] = k1
            self.lens = make_lens(
                k1, (frame.shape[0], frame.shape[1])) if k1 else None
        return self.corners.ready()
