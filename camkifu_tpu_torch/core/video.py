"""VidProcessor — the frame-batch processing engine finders inherit.

Parity: ``camkifu/core/video.py`` (SURVEY §2.1) — the abstract "process
frames forever" loop: synchronized read → ``_doframe`` → display metadata →
throttle, with clean interrupt, pause, and single-step debugging. TPU-first
difference: ``_doframe`` receives a *batch* (the jit granularity), and the
fps metadata counts frames, not loop turns.

Copied from camkifu_tpu/core/video.py (host code, no device). The batch a
finder reads comes from its manager's ``read_batch``, already on the
manager's device.
"""

from __future__ import annotations

import time


class VidProcessor:
    def __init__(self, vmanager):
        self.vmanager = vmanager
        self.interrupted = False
        self.paused = False
        self._step_once = False
        self.frame_period = 0.0          # seconds per batch; 0 = full speed
        self.full_speed = True
        self.metadata: dict[str, object] = {}   # overlaid on debug display
        self.total_frames = 0
        self._fps_window: list[tuple[float, int]] = []
        self.last_error: str | None = None

    # -- the loop --------------------------------------------------------

    def execute(self) -> None:
        """Run until interrupted or the source is exhausted."""
        self._prepare()
        while not self.interrupted:
            if self.paused and not self._step_once:
                time.sleep(0.02)
                continue
            self._step_once = False
            t0 = time.perf_counter()
            frames, n, done = self.read()
            if n:
                try:
                    self._doframe(frames, n)
                except Exception as exc:  # surface errors, don't kill the app
                    self.last_error = f"{type(exc).__name__}: {exc}"
                    self._on_error(exc)
                self._count(n)
            if done:
                break
            if not self.full_speed and self.frame_period > 0:
                leftover = self.frame_period - (time.perf_counter() - t0)
                if leftover > 0:
                    time.sleep(leftover)
        self._finalize()

    def read(self):
        return self.vmanager.read_batch()

    def _doframe(self, frames, n: int | None = None) -> None:
        """Process a batch. ``frames`` always has the static batch shape;
        ``n`` (≤ batch) is how many leading frames are real — the tail
        repeats the last real frame (core.capture.pad_batch)."""
        raise NotImplementedError

    def _prepare(self) -> None:
        pass

    def _finalize(self) -> None:
        pass

    def _on_error(self, exc: Exception) -> None:
        if self.vmanager is not None:
            self.vmanager.error_to_gui(self.last_error)

    # -- control ------------------------------------------------------------

    def interrupt(self) -> None:
        self.interrupted = True

    def pause(self, boolean: bool = True) -> None:
        self.paused = bool(boolean)

    def next(self) -> None:
        """Single-step: process one batch while paused."""
        self._step_once = True

    # -- metadata / fps --------------------------------------------------

    def _count(self, n: int) -> None:
        now = time.perf_counter()
        self.total_frames += n
        self._fps_window.append((now, n))
        cutoff = now - 3.0
        self._fps_window = [(t, k) for t, k in self._fps_window if t >= cutoff]
        self.metadata["fps"] = round(self.fps(), 1)
        self.metadata["frame"] = self.total_frames

    def fps(self) -> float:
        if len(self._fps_window) < 2:
            return 0.0
        span = self._fps_window[-1][0] - self._fps_window[0][0]
        frames = sum(k for _, k in self._fps_window[1:])
        return frames / span if span > 0 else 0.0
