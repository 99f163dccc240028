"""The measured window, as a loop (``benchmark/loops/<loop>.py``) drives
it: its clock, each batch's time from its entry call to its labels on the
host, the profiled stretch of a traced run, and the batches kept for the
check (a reservoir drawn from the seed, so every batch of the window is
as likely to be compared)."""

from __future__ import annotations

import time

import numpy as np
import torch


class Recorder:
    def __init__(self, seconds: float, mix: dict, labels_shape, device,
                 trace: bool, activities, seed: int):
        self.seconds = seconds
        self.cuda = device.type == "cuda"
        self.host_bufs = [torch.empty(labels_shape, dtype=torch.int8,
                                      pin_memory=self.cuda)
                          for _ in range(mix["in_flight"] + 1)]
        self.trace, self.activities = trace, activities
        self.skip, self.n_traced = mix["trace_skip"], mix["trace_batches"]
        self.sampler = np.random.default_rng([seed % (2 ** 63), 2])
        self.keep_max = mix["check_batches"]
        self.kept = []           # (pool batch, state before it, outputs)
        self.latencies = []      # every batch's entry call → labels, s
        self.enqueue = []        # (s inside the entry call, in the stretch)
        self.pool_of = []        # pool batch of each window batch
        self.attempted = self.done_in_window = 0
        self.t0 = self.last_done = 0.0
        self.prof = None         # the profiler, once the stretch began
        self.in_stretch = False
        self.stretch_start = self.window_s = 0.0
        self.stretch_batches = []   # pool batches of a whole stretch

    def start(self) -> None:
        self.t0 = self.last_done = time.perf_counter()

    @staticmethod
    def clock() -> float:
        return time.perf_counter()

    def open(self) -> bool:
        return time.perf_counter() - self.t0 < self.seconds

    def at_stretch_edge(self, j: int) -> bool:
        """Whether window batch ``j`` begins or ends the traced stretch:
        the loop drains what is in flight there, so no work launched
        outside the stretch runs inside it."""
        if not self.trace:
            return False
        return (j == self.skip and self.prof is None) or \
            (self.in_stretch and j == self.skip + self.n_traced)

    def toggle_stretch(self, j: int) -> None:
        from torch.profiler import profile

        if not self.in_stretch:
            self.prof = profile(activities=self.activities)
            self.prof.__enter__()
            self.in_stretch = True
            self.stretch_start = time.perf_counter()
        else:
            self.window_s = time.perf_counter() - self.stretch_start
            self.prof.__exit__(None, None, None)
            self.in_stretch = False
            self.stretch_batches = self.pool_of[self.skip:j]

    def close_stretch(self, j: int) -> None:
        """After the last batch (drained): end a stretch that is whole;
        drop one that the window's close cut."""
        if self.in_stretch:
            if j >= self.skip + self.n_traced:
                self.toggle_stretch(j)
            else:
                self.prof.__exit__(None, None, None)
                self.in_stretch = False
                self.prof = None

    def enqueued(self, j: int, k: int, t_in: float, before: dict,
                 out: dict):
        """Window batch ``j`` (pool batch ``k``) was enqueued: its labels'
        copy to the host follows it. → its ticket for ``complete``."""
        buf = self.host_bufs[j % len(self.host_bufs)]
        buf.copy_(out["labels"], non_blocking=self.cuda)
        ev = None
        if self.cuda:
            ev = torch.cuda.Event()
            ev.record()
        self.enqueue.append((time.perf_counter() - t_in, self.in_stretch))
        self.attempted += 1
        self.pool_of.append(k)
        entry = (k, before, out)
        if len(self.kept) < self.keep_max:
            self.kept.append(entry)
        else:
            r = int(self.sampler.integers(0, j + 1))
            if r < self.keep_max:
                self.kept[r] = entry
        return t_in, ev

    def complete(self, ticket) -> None:
        """Wait for a batch's labels on the host."""
        t_in, ev = ticket
        if ev is not None:
            ev.synchronize()
        t_done = time.perf_counter()
        self.latencies.append(t_done - t_in)
        if t_done - self.t0 <= self.seconds:
            self.done_in_window += 1
            self.last_done = t_done
