"""Observability: per-batch stats, and the program's spans in a profiler
trace.

``BatchStats`` is copied from camkifu_tpu/utils/profiling.py: every batch
can emit a structured record (fps, agitation, votes, detection status) to
an optional JSONL sink.

``span(name)`` marks a stretch of the program's host code for whoever is
recording a ``torch.profiler`` trace. While a session records, it is a
``record_function`` range: a host event named ``name`` in the same Kineto
trace as the kernels, on the same clock, kept in memory with the rest of
the trace, its parent the span that encloses it on the thread. While none
records, it is one shared null context: one boolean read, no
``record_function``, no allocation, no clock read. The switch is the
profiler session itself; there is no flag of its own. Every span's name
starts with ``camkifu.``.
"""

from __future__ import annotations

import contextlib
import json
import time

import torch
from torch.autograd import profiler as _autograd_profiler

#: What ``span`` returns while no profiler session records.
_NULL_SPAN = contextlib.nullcontext()


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


def span(name: str):
    """A named host range in the profiler's trace while a session records
    (``torch.profiler.record_function``), else a shared null context."""
    if not _autograd_profiler._is_profiler_enabled:
        return _NULL_SPAN
    return torch.profiler.record_function(name)
