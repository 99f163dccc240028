"""Frame capture: file/camera decode with film vs live semantics.

Parity: the capture wrapper in ``camkifu/core/vmanager.py`` (SURVEY §2.1) —
bounds cropping, and the two read disciplines: **film mode** (recorded video:
every frame is delivered exactly once, never dropped) vs **live mode**
(camera: always-latest wins, stale frames dropped). The reference hands one
frame at a time to two threads; here consumers pull *batches* for the
device pipeline, which subsumes the synchronized fan-out.

Copied from camkifu_tpu/core/capture.py. Decode stays on the host, through
cv2, as there: the decoders and the camera import cv2 when they are built,
never when this module is imported, and raise ``ImportError`` without it.
Frames leave here as RGB numpy arrays; the managers copy them to the device
(``core.feeder``).
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


class FileCapture(CaptureBase):
    """Film mode: lossless sequential batches from a video file.

    ``_cap_lock`` serializes every touch of the underlying
    ``cv2.VideoCapture``: it is NOT thread-safe, and in the threaded
    runtime the device-feeder daemon read()s while the Tk thread seeks
    (VUI slider → 'vidpos' → set_position) — unsynchronized that yields
    garbled frames or a native crash.
    """

    def __init__(self, path: str, bounds: tuple[float, float] = (0.0, 1.0)):
        import cv2

        self._cv2 = cv2
        self.cap = cv2.VideoCapture(path)
        if not self.cap.isOpened():
            raise FileNotFoundError(f"cannot open video: {path}")
        self.path = path
        self.bounds = bounds
        self.total = int(self.cap.get(cv2.CAP_PROP_FRAME_COUNT)) or -1
        self.pos = 0
        self._cap_lock = threading.Lock()

    def read_batch(self, n: int):
        frames = []
        with self._cap_lock:
            for _ in range(n):
                ok, frame = self.cap.read()
                if not ok:
                    break
                self.pos += 1
                frames.append(_crop(frame[:, :, ::-1], self.bounds))
        done = len(frames) < n
        return (np.stack(frames) if frames else
                np.zeros((0, 1, 1, 3), np.uint8)), done

    @property
    def frame_size(self):
        h = int(self.cap.get(self._cv2.CAP_PROP_FRAME_HEIGHT))
        w = int(self.cap.get(self._cv2.CAP_PROP_FRAME_WIDTH))
        h0 = int(self.bounds[0] * h)
        return (int(self.bounds[1] * h) - h0, w)

    def set_position(self, frac: float) -> None:
        if self.total > 0:
            idx = int(frac * self.total)
            with self._cap_lock:
                self.cap.set(self._cv2.CAP_PROP_POS_FRAMES, idx)
                self.pos = idx

    def get_position(self) -> float:
        return self.pos / self.total if self.total > 0 else 0.0

    def release(self) -> None:
        with self._cap_lock:
            self.cap.release()


class ParallelFileCapture(CaptureBase):
    """Film mode with multi-worker decode.

    One cv2 decoder on the host is far slower than the card reads frames
    (PERF.md has the rates measured with ``chip_smoke.py``), so the host
    decoder is the film-mode bottleneck. N workers each own their own
    cv2.VideoCapture on the same file and decode contiguous SEGMENTS
    (seeked by frame index, which OpenCV resolves keyframe-accurately);
    segments reassemble strictly in order with bounded lookahead, so the
    output frame sequence is byte-identical to sequential decode.

    Parity: the reference's film-mode capture discipline (every frame
    exactly once, in order — SURVEY §2.4 row 2); the parallelism is an
    upgrade of its single VideoCapture.
    """

    def __init__(self, path: str, bounds: tuple[float, float] = (0.0, 1.0),
                 workers: int = 4, segment: int = 32):
        import cv2

        self._cv2 = cv2
        probe = cv2.VideoCapture(path)
        if not probe.isOpened():
            raise FileNotFoundError(f"cannot open video: {path}")
        self.total = int(probe.get(cv2.CAP_PROP_FRAME_COUNT))
        self._h = int(probe.get(cv2.CAP_PROP_FRAME_HEIGHT))
        self._w = int(probe.get(cv2.CAP_PROP_FRAME_WIDTH))
        probe.release()
        if self.total <= 0:
            # Segment scheduling needs a trustworthy frame count (some
            # AVI/stream/VFR containers report 0/-1); callers fall back to
            # sequential FileCapture.
            raise ValueError(f"unknown frame count for {path!r}; "
                             "parallel decode needs a seekable file")
        self.path = path
        self.bounds = bounds
        self.segment = segment
        self.workers = max(1, workers)
        self.pos = 0                       # frames emitted so far
        self.dropped_frames = 0            # decode failures, after one retry
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._stop = threading.Event()
        self._released = False             # terminal, unlike a seek teardown
        self._gen = 0                      # pipeline generation (seek safety)
        self._buf: list[np.ndarray] = []   # decoded, in-order, not yet read
        self._start_pipeline(start_frame=0)

    # -- worker pipeline ---------------------------------------------------

    def _start_pipeline(self, start_frame: int) -> None:
        self._results: dict[int, list[np.ndarray]] = {}
        self._segments = list(range(start_frame, self.total, self.segment))
        self._claim = 0                    # next segment index to claim
        self._emit = 0                     # next segment index to emit
        # Lookahead bound: pending segments cap the decode-ahead memory
        # (workers+1 segments of `segment` frames).
        self._max_pending = self.workers + 1
        self._threads = [
            threading.Thread(target=self._worker, args=(self._gen,),
                             daemon=True, name=f"decode-{i}")
            for i in range(self.workers)]
        for t in self._threads:
            t.start()

    def _worker(self, gen: int) -> None:
        """Decode loop for pipeline generation `gen`: every claim/store is
        generation-checked so a worker that outlives a seek (join timeout)
        can never write old-position frames into the new pipeline."""
        cv2 = self._cv2
        cap = cv2.VideoCapture(self.path)
        try:
            if not cap.isOpened():
                return
            while True:
                with self._cond:
                    # Backpressure: don't run ahead of the reader.
                    while (gen == self._gen and not self._stop.is_set()
                           and self._claim - self._emit >= self._max_pending):
                        self._cond.wait(0.05)
                    if gen != self._gen or self._stop.is_set() \
                            or self._claim >= len(self._segments):
                        return
                    seg = self._claim
                    self._claim += 1
                    # Snapshot under the lock: a concurrent seek swaps
                    # self._segments for a (possibly shorter) list, and a
                    # stale-generation worker indexing the new list would
                    # die with IndexError instead of exiting cleanly via
                    # its generation check.
                    start = self._segments[seg]
                expected = min(self.segment, self.total - start)
                frames = self._decode_segment(cap, start, expected)
                if len(frames) < expected:
                    # One retry with a fresh seek: transient cv2 hiccups
                    # (mid-GOP read failures) usually recover. Beyond that
                    # the shortfall is counted in dropped_frames rather than
                    # silently violating the every-frame-once film contract.
                    retry = self._decode_segment(cap, start, expected)
                    if len(retry) > len(frames):
                        frames = retry
                # A short decode of the FILE'S LAST segment is (almost
                # always) the container header overstating the frame count
                # (CAP_PROP_FRAME_COUNT is an estimate on VFR streams) —
                # the stream simply ended. Counting it would report phantom
                # drops on every such file; genuine tail corruption is the
                # price of not lying on the common case.
                tail = seg == len(self._segments) - 1
                with self._cond:
                    if gen == self._gen:
                        self._results[seg] = frames
                        if not tail:
                            self.dropped_frames += expected - len(frames)
                        self._cond.notify_all()
        finally:
            cap.release()

    def _decode_segment(self, cap, start: int, expected: int):
        """Seek to `start` and decode up to `expected` frames; [] on error."""
        cv2 = self._cv2
        frames: list[np.ndarray] = []
        try:
            if int(cap.get(cv2.CAP_PROP_POS_FRAMES)) != start:
                cap.set(cv2.CAP_PROP_POS_FRAMES, start)
            for _ in range(expected):
                ok, frame = cap.read()
                if not ok:
                    break
                frames.append(_crop(frame[:, :, ::-1].copy(), self.bounds))
        except Exception:
            pass
        return frames

    # -- reader ------------------------------------------------------------

    def read_batch(self, n: int):
        with self._cond:
            while len(self._buf) < n and self._emit < len(self._segments):
                if self._emit in self._results:
                    self._buf.extend(self._results.pop(self._emit))
                    self._emit += 1
                    self._cond.notify_all()
                elif self._stop.is_set():
                    if self._released:
                        # Terminal teardown (release()): no new generation
                        # is coming — deliver what is buffered and report
                        # end-of-stream instead of waiting forever.
                        chunk, self._buf = self._buf[:n], self._buf[n:]
                        self.pos += len(chunk)
                        return (np.stack(chunk) if chunk else
                                np.zeros((0, 1, 1, 3), np.uint8)), True
                    # A concurrent seek (set_position) is tearing the
                    # pipeline down; wait for the new generation rather than
                    # mistaking the teardown for worker death.
                    self._cond.wait(0.05)
                elif not any(t.is_alive() for t in self._threads):
                    raise RuntimeError(
                        "all decode workers exited before segment "
                        f"{self._emit} was produced ({self.path!r})")
                else:
                    self._cond.wait(0.05)
            chunk, self._buf = self._buf[:n], self._buf[n:]
            done = self._emit >= len(self._segments) and not self._buf
        self.pos += len(chunk)
        return (np.stack(chunk) if chunk else
                np.zeros((0, 1, 1, 3), np.uint8)), done

    @property
    def frame_size(self):
        h0 = int(self.bounds[0] * self._h)
        return (int(self.bounds[1] * self._h) - h0, self._w)

    def set_position(self, frac: float) -> None:
        """Seek: tear the pipeline down and restart from the new frame.

        The generation bump makes any worker that outlives the bounded join
        (e.g. blocked in a slow cap.read) inert: it can neither claim new
        segments nor store results into the new pipeline."""
        self._stop.set()
        with self._cond:
            self._cond.notify_all()
        for t in self._threads:
            t.join(timeout=2.0)
        with self._cond:
            # Swap pipeline state atomically w.r.t. a concurrent read_batch:
            # the reader holds this lock between liveness checks, so it can
            # never observe dead old threads with the new stop flag unset.
            self._gen += 1
            self._stop = threading.Event()
            self._buf = []
            idx = int(frac * self.total) if self.total > 0 else 0
            self.pos = idx
            self._start_pipeline(start_frame=idx)

    def get_position(self) -> float:
        return self.pos / self.total if self.total > 0 else 0.0

    def release(self) -> None:
        self._released = True
        self._stop.set()
        with self._cond:
            self._cond.notify_all()
        for t in self._threads:
            t.join(timeout=2.0)


class LiveCapture(CaptureBase):
    """Live mode: a grabber thread keeps only the latest frames (ring buffer,
    latest-wins — the reference's always-latest semantics for webcams).

    ``camera`` injects any object with the cv2.VideoCapture read interface
    (isOpened/read/release) — a paced mock for latency tests and demos;
    without one, ``cv2.VideoCapture(cam_index)`` is opened.
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
            import cv2

            camera = cv2.VideoCapture(cam_index)
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


def open_capture(video, bounds=(0.0, 1.0), decoders: int = 1,
                 live_wait_s: float | None = None) -> CaptureBase:
    """The reference's ``-v`` semantics: an integer (or digit string) is a
    camera index, anything else a file path. ``decoders`` > 1 enables the
    multi-worker film decoder (ParallelFileCapture); ``live_wait_s`` is
    live mode's batch-fill wait bound (the latency/throughput knob)."""
    if isinstance(video, (list, np.ndarray)):
        return ArrayCapture(video, bounds)
    if isinstance(video, int) or (isinstance(video, str) and video.isdigit()):
        if live_wait_s is not None:
            return LiveCapture(int(video), bounds, max_wait_s=live_wait_s)
        return LiveCapture(int(video), bounds)
    if decoders > 1:
        try:
            return ParallelFileCapture(str(video), bounds, workers=decoders)
        except ValueError:
            pass                   # unknown frame count → sequential decode
    return FileCapture(str(video), bounds)
