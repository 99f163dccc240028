"""VManager — vision runtime: capture + finder lifecycle + hot-swap.

Parity: ``camkifu/core/vmanager.py`` (SURVEY §2.1/§2.4) — owns the capture,
instantiates the default finders from the cvconf registries, registers the
vision commands ("on"/"off"/"pause"/"next"/"vidpos"/algorithm select) into
the controller API, supports algorithm hot-swap, and runs the processing as
a daemon worker. ``VManagerSeq`` is the single-threaded variant for batch
runs and tests (SURVEY §4: bypass threads, don't mock them).

TPU-first: the reference's two finder threads trading frames through locks
become ONE pipeline worker per manager — each batch flows board-finder →
stones-finder through the device pipeline (SURVEY §2.4 row 1); the
capture wrapper's film/live disciplines live in core.capture.

Copied from camkifu_tpu/core/vmanager.py, with a ``device`` (the card
unless the caller asks for the CPU). Each batch is copied to the device
once, by the manager: ``read_batch`` (``VManagerSeq``, a finder's own
``execute`` loop) through a ring of pinned buffers on the caller's
stream, ``VManager`` through ``DeviceFeeder`` on a side stream. Both finders receive the same (B, H, W, 3) uint8 tensor on the
device, where the reference hands each a numpy batch to copy itself.
"""

from __future__ import annotations

import threading
import time

import numpy as np
import torch

from camkifu_tpu_torch.config import cvconf
from camkifu_tpu_torch.core.capture import open_capture, pad_batch
from camkifu_tpu_torch.core.feeder import DeviceFeeder, PinnedRing, \
    on_device
from camkifu_tpu_torch.utils.profiling import BatchStats


class VManagerBase:
    def __init__(self, controller, video=0, bounds=(0.0, 1.0),
                 bf_class=None, sf_class=None,
                 batch: int = cvconf.frame_batch,
                 stats_path: str | None = None,
                 initial_corners=None,
                 decoders: int = 1,
                 live_wait_s: float | None = None,
                 device="cuda"):
        self.controller = controller
        self.device = torch.device(device)
        self.video = video
        self.bounds = bounds
        self.batch = batch
        self.stats = BatchStats(stats_path)
        self.capture = None
        self.board_finder = None
        self.stones_finder = None
        #: Corners to apply to every (re-)instantiated board finder (e.g.
        #: ckmain --corners). Finder instances are rebuilt on vision_on and
        #: hot-swap, so the corners must live on the manager, not be poked
        #: onto one instance (which used to survive only through
        #: bf_manual's per-video disk persistence).
        self.initial_corners = None if initial_corners is None \
            else np.asarray(initial_corners, np.float32)
        self.decoders = decoders
        self.live_wait_s = live_wait_s
        self._bf_class = bf_class or cvconf.bfinders()[0]
        self._sf_class = sf_class or cvconf.sfinders()[0]
        if controller is not None:
            controller.stones_finder = None
            self._register_api()

    # -- lifecycle ----------------------------------------------------------

    def init_capture(self) -> None:
        if self.capture is None:
            self.capture = open_capture(self.video, self.bounds,
                                        decoders=self.decoders,
                                        live_wait_s=self.live_wait_s)

    def instantiate_finders(self) -> None:
        self.board_finder = self._bf_class(self)
        self.stones_finder = self._sf_class(self)
        if self.initial_corners is not None \
                and hasattr(self.board_finder, "set_corners"):
            self.board_finder.set_corners(self.initial_corners)
        if self.controller is not None:
            self.controller.stones_finder = self.stones_finder
            self.controller.board_finder = self.board_finder

    # -- frame source for VidProcessors -------------------------------------

    _ring: PinnedRing | None = None

    def read_batch(self):
        """→ (frames (batch, H, W, 3) uint8 on the manager's device — padded
        to the static batch size and copied once, through a ring of pinned
        buffers on the caller's stream —, valid_count, done)."""
        self.init_capture()
        frames, done = self.capture.read_batch(self.batch)
        frames, n = pad_batch(frames, self.batch)
        if n:
            if self._ring is None:
                self._ring = PinnedRing(2, self.device)
            frames, _ = self._ring.upload(frames)
        return frames, n, done

    def error_to_gui(self, message: str) -> None:
        if self.controller is not None:
            self.controller._notify("error", message)

    # -- controller API commands --------------------------------------------

    def _register_api(self) -> None:
        self.controller.api.update({
            "on": self.vision_on,
            "off": self.vision_off,
            "pause": self.vision_pause,
            "next": self.vision_next,
            "vidpos": self.vidpos,
            "bfselect": self.select_bf,
            "sfselect": self.select_sf,
        })

    def vision_on(self) -> None:
        raise NotImplementedError

    def vision_off(self) -> None:
        raise NotImplementedError

    def vision_pause(self, paused: bool = True) -> None:
        for f in (self.board_finder, self.stones_finder):
            if f is not None:
                f.pause(paused)

    def vision_next(self) -> None:
        for f in (self.board_finder, self.stones_finder):
            if f is not None:
                f.next()

    def vidpos(self, frac: float) -> None:
        self.init_capture()
        self.capture.set_position(float(frac))

    def _resolve(self, registry, label_or_class):
        if isinstance(label_or_class, type):
            return label_or_class
        for cls in registry:
            if cls.label == label_or_class or cls.__name__ == label_or_class:
                return cls
        raise KeyError(f"unknown finder: {label_or_class!r}")

    def select_bf(self, label_or_class) -> None:
        self._bf_class = self._resolve(cvconf.bfinders(), label_or_class)
        self._swap()

    def select_sf(self, label_or_class) -> None:
        self._sf_class = self._resolve(cvconf.sfinders(), label_or_class)
        self._swap()

    def _swap(self) -> None:
        """Hot-swap: interrupt + re-instantiate (reference: kill + respawn)."""
        self.instantiate_finders()


class VManagerSeq(VManagerBase):
    """Synchronous manager: processes the whole source in the caller's
    thread. The deterministic harness (filecheck, tests) runs on this."""

    def run(self, max_batches: int | None = None) -> None:
        self.init_capture()
        if self.board_finder is None:
            self.instantiate_finders()
        batches = 0
        while max_batches is None or batches < max_batches:
            frames, n, done = self.read_batch()
            if n:
                self.board_finder._doframe(frames, n)
                self.stones_finder._doframe(frames, n)
                self.board_finder._count(n)
                self.stones_finder._count(n)
                self.stats.record(n, **self.stones_finder.metadata)
            batches += 1
            if done:
                break


class VManager(VManagerBase):
    """Threaded manager: one daemon pipeline worker; vision on/off spawns and
    kills it; commands arrive through the controller API."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._thread: threading.Thread | None = None
        self._stop = threading.Event()
        self.last_frame = None      # latest raw frame, for the preview window

    def vision_on(self) -> None:
        if self._thread is not None and self._thread.is_alive():
            if not self._stop.is_set():
                return                      # already running
            # A stopped worker is still draining (vision_off's bounded join
            # timed out — e.g. blocked in the 20–40 s first-batch compile).
            # Never start a second worker while it lives: two pipelines
            # would interleave read_batch on one capture and race the
            # finders' state. And never block here: this runs on the Tk
            # main thread (pipe drain), so refuse fast and let the user
            # retry rather than freeze the GUI waiting.
            self._thread.join(timeout=0.5)
            if self._thread.is_alive():
                self.error_to_gui(
                    "vision pipeline still shutting down — try again")
                return
        self.init_capture()
        self.instantiate_finders()
        # Fresh event per worker generation: the worker captures it at
        # spawn, so a stale worker can never be resurrected by a clear().
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker,
                                        args=(self._stop,), daemon=True,
                                        name="vision-pipeline")
        self._thread.start()

    def vision_off(self) -> None:
        self._stop.set()
        for f in (self.board_finder, self.stones_finder):
            if f is not None:
                f.interrupt()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            if not self._thread.is_alive():
                self._thread = None

    # Alias matching the reference's lifecycle verbs.
    run = vision_on
    start = vision_on
    stop = vision_off

    def _worker(self, stop: threading.Event) -> None:
        with on_device(self.device):
            self._work(stop)

    def _work(self, stop: threading.Event) -> None:
        feeder = DeviceFeeder(self.capture, self.batch, device=self.device)
        try:
            for frames, n, _done, last_host, arrivals in \
                    self._relay_errors(feeder):
                if stop.is_set():
                    break
                bf, sf = self.board_finder, self.stones_finder
                while bf.paused and not bf._step_once \
                        and not stop.is_set():
                    stop.wait(0.02)
                bf._step_once = sf._step_once = False
                self.last_frame = np.ascontiguousarray(last_host)
                try:
                    bf._doframe(frames, n)
                    sf._doframe(frames, n)
                except Exception as exc:
                    self.error_to_gui(f"{type(exc).__name__}: {exc}")
                bf._count(n)
                sf._count(n)
                meta = dict(sf.metadata)
                if arrivals is not None and len(arrivals):
                    # Live-mode pipeline latency: newest/oldest frame
                    # arrival → this batch fully processed (finders done,
                    # any resulting moves piped).
                    now = time.perf_counter()
                    meta["latency_newest_ms"] = round(
                        (now - float(arrivals[-1])) * 1e3, 1)
                    meta["latency_oldest_ms"] = round(
                        (now - float(arrivals[0])) * 1e3, 1)
                self.stats.record(n, **meta)
        finally:
            feeder.close()
            stop.set()

    def _relay_errors(self, feeder):
        """Forward feeder batches; surface a mid-stream capture failure to
        the GUI (the feeder raises instead of faking end-of-stream)."""
        try:
            yield from feeder
        except RuntimeError as exc:
            self.error_to_gui(f"capture failed: {exc.__cause__ or exc}")

    def is_running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()
