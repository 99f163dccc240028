"""Frame capture: the read interface, batch padding and in-memory frames.

Parity: the capture wrapper in ``camkifu/core/vmanager.py`` (SURVEY §2.1) —
bounds cropping, and the two read disciplines: **film mode** (recorded video:
every frame is delivered exactly once, never dropped) vs **live mode**
(camera: always-latest wins, stale frames dropped). The reference hands one
frame at a time to two threads; here consumers pull *batches* for the
device pipeline, which subsumes the synchronized fan-out.

Copied from camkifu_tpu/core/capture.py: ``CaptureBase``, ``pad_batch``,
``_crop``, ``ArrayCapture`` and ``LiveCapture`` (its ring, batch wait and
arrival times), which reads any camera object with cv2's
``VideoCapture`` interface handed to it. The reference's file decoders
(``FileCapture``, ``ParallelFileCapture``) and its default camera
(``cv2.VideoCapture(index)``) need cv2, which the port does not use:
``open_capture`` takes arrays and refuses a camera index or a path.
"""

from __future__ import annotations

import threading
import time

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


class LiveCapture(CaptureBase):
    """Live mode: a grabber thread keeps only the latest frames (ring buffer,
    latest-wins — the reference's always-latest semantics for webcams).

    ``camera`` is any object with the cv2.VideoCapture read interface
    (isOpened/read/release), delivering BGR host frames — a paced mock for
    latency runs and demos; without one the reference opens
    ``cv2.VideoCapture(cam_index)``, which the port does not use.
    ``max_wait_s`` bounds how long a read waits for a FULL batch before
    dispatching a partial one: live mode's latency/throughput knob.

    Every delivered frame's arrival time (``time.perf_counter()`` at grab)
    rides along in ``last_batch_arrivals``, aligned with the last
    ``read_batch`` result — the runtime uses it for the end-to-end latency
    metadata.
    """

    def __init__(self, cam_index: int = 0,
                 bounds: tuple[float, float] = (0.0, 1.0), ring: int = 64,
                 camera=None, max_wait_s: float = 2.0):
        if camera is None:
            raise NotImplementedError(
                f"camera {cam_index}: opening a camera goes through "
                f"cv2.VideoCapture (camkifu_tpu/core/capture.py "
                f"LiveCapture), which the port does not use; pass a camera "
                f"object with isOpened/read/release as camera=")
        self.cap = camera
        if not self.cap.isOpened():
            raise RuntimeError(f"cannot open camera {cam_index}")
        self.bounds = bounds
        self.max_wait_s = max_wait_s
        self._ring: list[tuple[np.ndarray, float]] = []
        self._ring_max = ring
        self.last_batch_arrivals: np.ndarray | None = None
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._grab_loop, daemon=True)
        self._thread.start()

    def _grab_loop(self) -> None:
        while not self._stop.is_set():
            ok, frame = self.cap.read()
            if not ok:
                time.sleep(0.005)
                continue
            frame = _crop(frame[:, :, ::-1].copy(), self.bounds)
            with self._lock:
                self._ring.append((frame, time.perf_counter()))
                if len(self._ring) > self._ring_max:
                    del self._ring[:len(self._ring) - self._ring_max]

    def _take(self, n: int):
        frames = [f for f, _ in self._ring[-n:]]
        self.last_batch_arrivals = np.array(
            [t for _, t in self._ring[-n:]], np.float64)
        self._ring.clear()
        return np.stack(frames), False

    def read_batch(self, n: int):
        # Wait (bounded by max_wait_s) for a FULL batch; on timeout return
        # whatever arrived (consumers pad + mask the tail). The wait target
        # is clamped to the ring capacity — a batch larger than the ring
        # could otherwise never be satisfied.
        target = min(n, self._ring_max)
        deadline = time.time() + self.max_wait_s
        while time.time() < deadline:
            with self._lock:
                if len(self._ring) >= target:
                    return self._take(n)
            time.sleep(0.002)
        with self._lock:
            if self._ring:
                return self._take(n)
        self.last_batch_arrivals = None
        return np.zeros((0, 1, 1, 3), np.uint8), False

    @property
    def frame_size(self):
        with self._lock:
            if self._ring:
                return self._ring[-1][0].shape[:2]
        return (0, 0)

    def release(self) -> None:
        self._stop.set()
        self._thread.join(timeout=1.0)
        self.cap.release()


def open_capture(video, bounds=(0.0, 1.0)) -> CaptureBase:
    """The reference's ``-v`` semantics for the sources the port reads:
    in-memory frames (a list or an array) give an ``ArrayCapture``. A
    camera index or a file path needs cv2 (the reference's
    ``LiveCapture(index)`` and file decoders), which the port does not
    use: it raises rather than read as an empty stream. A camera object
    is read by building ``LiveCapture(camera=...)`` directly."""
    if isinstance(video, (list, np.ndarray)):
        return ArrayCapture(video, bounds)
    raise NotImplementedError(
        f"cannot open {video!r}: camera and video-file capture go through "
        f"cv2 (camkifu_tpu/core/capture.py LiveCapture, FileCapture, "
        f"ParallelFileCapture), which the port does not use; pass the "
        f"frames as arrays")
