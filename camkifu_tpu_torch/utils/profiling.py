"""Observability: structured per-batch stats and torch.profiler hooks.

``BatchStats`` is copied from camkifu_tpu/utils/profiling.py: every batch
can emit a structured record (fps, agitation, votes, detection status) to
an optional JSONL sink. ``profile_trace`` and ``annotate`` are the
reference's jax.profiler hooks on ``torch.profiler``: a trace of the host
and the card around any span, and a named range inside it.
"""

from __future__ import annotations

import contextlib
import json
import os
import time


class BatchStats:
    """Rolling per-batch statistics with an optional JSONL sink."""

    def __init__(self, sink_path: str | None = None, window_s: float = 5.0):
        self.sink_path = sink_path
        self.window_s = window_s
        self._events: list[tuple[float, int]] = []
        self._sink = None
        if sink_path:
            self._sink = open(sink_path, "a", encoding="utf-8")

    def record(self, frames: int, **fields) -> dict:
        now = time.perf_counter()
        self._events.append((now, frames))
        cutoff = now - self.window_s
        self._events = [(t, n) for t, n in self._events if t >= cutoff]
        rec = {"t": round(now, 4), "frames": frames,
               "fps": round(self.fps(), 2), **fields}
        if self._sink:
            self._sink.write(json.dumps(rec, default=float) + "\n")
            self._sink.flush()
        return rec

    def fps(self) -> float:
        if len(self._events) < 2:
            return 0.0
        span = self._events[-1][0] - self._events[0][0]
        n = sum(k for _, k in self._events[1:])
        return n / span if span > 0 else 0.0

    def close(self) -> None:
        if self._sink:
            self._sink.close()
            self._sink = None


@contextlib.contextmanager
def profile_trace(log_dir: str):
    """Trace the host and the card (torch.profiler) and write the trace as
    Chrome JSON under ``log_dir`` (view in Perfetto or chrome://tracing)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


@contextlib.contextmanager
def annotate(name: str):
    """Named span inside a profiler trace."""
    import torch

    with torch.profiler.record_function(name):
        yield
