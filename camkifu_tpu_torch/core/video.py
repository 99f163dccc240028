"""VidProcessor — the frame-batch processing state finders inherit.

Parity: ``camkifu/core/video.py`` (SURVEY §2.1) — interrupt, pause and
single-step control, display metadata and the fps window. TPU-first
difference: ``_doframe`` receives a *batch* (the jit granularity), and the
fps metadata counts frames, not loop turns.

Copied from camkifu_tpu/core/video.py (host code, no device), without the
reference's own read → ``_doframe`` → throttle loop (``execute``), which
no manager calls: ``VManagerSeq.run`` and ``VManager``'s worker feed the
finders' ``_doframe`` themselves.
"""

from __future__ import annotations

import time


class VidProcessor:
    def __init__(self, vmanager):
        self.vmanager = vmanager
        self.interrupted = False
        self.paused = False
        self._step_once = False
        self.metadata: dict[str, object] = {}   # overlaid on debug display
        self.total_frames = 0
        self._fps_window: list[tuple[float, int]] = []

    def _doframe(self, frames, n: int | None = None) -> None:
        """Process a batch. ``frames`` always has the static batch shape;
        ``n`` (≤ batch) is how many leading frames are real — the tail
        repeats the last real frame (core.capture.pad_batch)."""
        raise NotImplementedError

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
