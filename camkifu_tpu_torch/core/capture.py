"""Frame capture: the read interface, batch padding and in-memory frames.

Parity: the capture wrapper in ``camkifu/core/vmanager.py`` (SURVEY §2.1) —
bounds cropping, and the two read disciplines: **film mode** (recorded video:
every frame is delivered exactly once, never dropped) vs **live mode**
(camera: always-latest wins, stale frames dropped). The reference hands one
frame at a time to two threads; here consumers pull *batches* for the
device pipeline, which subsumes the synchronized fan-out.

Copied from camkifu_tpu/core/capture.py: ``CaptureBase``, ``pad_batch``,
``_crop`` and ``ArrayCapture``. The reference's decoders (``FileCapture``,
``ParallelFileCapture``, ``LiveCapture``) read files and cameras through
cv2, which the port does not use: it takes frames as arrays, and
``open_capture`` refuses a camera index or a path.
"""

from __future__ import annotations

import numpy as np


class CaptureBase:
    """Read interface: read_batch(n) → (frames (k≤n, H, W, 3) RGB, done)."""

    def read_batch(self, n: int):
        raise NotImplementedError

    def release(self) -> None:
        pass

    @property
    def frame_size(self):  # (H, W)
        raise NotImplementedError

    def set_position(self, frac: float) -> None:
        """Seek to a relative position (file mode only)."""
        raise NotImplementedError

    def get_position(self) -> float:
        return 0.0


def pad_batch(frames: np.ndarray, size: int):
    """Pad a (k, H, W, 3) batch to the static batch ``size`` by repeating
    the last frame → (padded (size, H, W, 3), valid_count k).

    Every consumer of capture batches must go through this: a live-camera
    ring delivers however many frames it holds, and one batch shape keeps
    every device call at one shape (in the reference, one jit
    specialization; here, one set of pinned buffers and kernel launch
    sizes). The valid count must accompany the
    batch: stateless per-frame classifiers simply trim their outputs, while
    the vote scan masks padded frames out of its state updates (a duplicate
    frame is NOT harmless there — each copy would cast an independent vote,
    amplifying a single transient misread by the pad count).
    """
    k = frames.shape[0]
    if k == 0 or k >= size:
        return frames[:size], min(k, size)
    reps = np.repeat(frames[-1:], size - k, axis=0)
    return np.concatenate([frames, reps], axis=0), k


def _crop(frame: np.ndarray, bounds: tuple[float, float]) -> np.ndarray:
    if bounds == (0.0, 1.0):
        return frame
    h = frame.shape[0]
    return frame[int(bounds[0] * h):int(bounds[1] * h)]


class ArrayCapture(CaptureBase):
    """Film-mode capture over in-memory frames (tests, synthetic games)."""

    def __init__(self, frames, bounds: tuple[float, float] = (0.0, 1.0)):
        self.frames = [
            _crop(np.asarray(f, dtype=np.uint8), bounds) for f in frames]
        self.pos = 0

    def read_batch(self, n: int):
        chunk = self.frames[self.pos:self.pos + n]
        self.pos += len(chunk)
        done = self.pos >= len(self.frames)
        return (np.stack(chunk) if chunk else
                np.zeros((0, 1, 1, 3), np.uint8)), done

    @property
    def frame_size(self):
        return self.frames[0].shape[:2] if self.frames else (0, 0)

    def set_position(self, frac: float) -> None:
        self.pos = int(frac * len(self.frames))

    def get_position(self) -> float:
        return self.pos / len(self.frames) if self.frames else 0.0


def open_capture(video, bounds=(0.0, 1.0)) -> CaptureBase:
    """The reference's ``-v`` semantics for the sources the port reads:
    in-memory frames (a list or an array) give an ``ArrayCapture``. A
    camera index or a file path needs the reference's cv2 decoders, which
    are not ported: it raises rather than read as an empty stream."""
    if isinstance(video, (list, np.ndarray)):
        return ArrayCapture(video, bounds)
    raise NotImplementedError(
        f"cannot open {video!r}: camera and video-file capture decode "
        f"through cv2 (camkifu_tpu/core/capture.py FileCapture, "
        f"ParallelFileCapture, LiveCapture), which the port has not "
        f"ported; pass the frames as arrays")
