"""Host↔device traffic of the runtime: the frame feeder and batched reads.

Parity: camkifu_tpu/core/feeder.py. There a decode thread stays one batch
ahead of the device and ``jax.device_put`` starts each host→HBM transfer
asynchronously, so transfer latency hides behind the compute on the
previous batch. PyTorch gives no such overlap by itself, so it is built
here from its parts:

- ``PinnedRing``: a ring of pinned host buffers. Each batch is padded
  (``capture.pad_batch``) into the next slot and copied to the device with
  ``non_blocking=True`` on a side CUDA stream, with an event recorded after
  the copy. A slot is refilled only once its last copy's event has
  completed: writing it earlier would change frames still in flight.
- ``DeviceFeeder`` / ``prefetch_to_device``: the reference's decode thread,
  uploading through the ring; the consumer's stream waits on each batch's
  event (``wait_event``) and the batch is marked as used on that stream
  (``record_stream``) before any finder touches it.
- ``host_read``: the values the host needs from a batch (corners,
  sharpness, labels, ...) read together, each a ``non_blocking`` copy into
  pinned memory and then one wait, where the reference reads one
  ``np.asarray`` at a time; ``to_device`` uploads small host arrays
  without a blocking copy.

On ``device="cpu"`` there is no stream and no pinning.
"""

from __future__ import annotations

import contextlib
import queue
import threading

import numpy as np
import torch

from camkifu_tpu_torch.core.capture import pad_batch


def host_read(*tensors: torch.Tensor) -> tuple[np.ndarray, ...]:
    """numpy copies of ``tensors``. On the card each is copied into pinned
    host memory with ``non_blocking=True``, then the host waits once, on
    an event recorded after the last copy."""
    if not any(t.is_cuda for t in tensors):
        return tuple(t.detach().numpy() for t in tensors)
    outs = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            for t in tensors]
    for out, t in zip(outs, tensors):
        out.copy_(t.detach(), non_blocking=True)
    done = torch.cuda.Event()
    done.record()
    done.synchronize()
    return tuple(out.numpy() for out in outs)


def to_device(array, device, dtype: torch.dtype | None = None):
    """A host array on ``device``; on the card through pinned memory and a
    ``non_blocking`` copy, which the host does not wait for."""
    t = torch.from_numpy(np.ascontiguousarray(array))
    if dtype is not None:
        t = t.to(dtype)
    device = torch.device(device)
    if device.type != "cuda":
        return t
    return t.pin_memory().to(device, non_blocking=True)


class PinnedRing:
    """Host→device copies of frame batches through ``slots`` pinned host
    buffers, issued on ``stream`` (None: the caller's current stream).

    ``upload(frames)`` → (device tensor, event recorded after its copy, or
    None on the CPU). A caller on another stream must make its stream
    wait on the event and ``record_stream`` the tensor before use."""

    def __init__(self, slots: int, device, stream=None):
        self.device = torch.device(device)
        self.stream = stream
        self._bufs: list[torch.Tensor | None] = [None] * slots
        self._events: list[torch.cuda.Event | None] = [None] * slots
        self._next = 0

    def upload(self, frames: np.ndarray):
        src = torch.from_numpy(np.ascontiguousarray(frames))
        if self.device.type != "cuda":
            return src, None
        i = self._next
        self._next = (i + 1) % len(self._bufs)
        last = self._events[i]
        if last is not None and not last.query():
            last.synchronize()                 # the slot's last copy is done
        buf = self._bufs[i]
        if buf is None or buf.shape != src.shape or buf.dtype != src.dtype:
            buf = torch.empty(src.shape, dtype=src.dtype, pin_memory=True)
            self._bufs[i] = buf
        buf.copy_(src)
        stream = self.stream or torch.cuda.current_stream(self.device)
        with torch.cuda.stream(stream):
            dev = buf.to(self.device, non_blocking=True)
            event = torch.cuda.Event()
            event.record(stream)
        self._events[i] = event
        return dev, event


def _side_ring(slots: int, device) -> PinnedRing:
    """A ring whose copies run on a stream of their own (none on the
    CPU)."""
    device = torch.device(device)
    stream = torch.cuda.Stream(device) if device.type == "cuda" else None
    return PinnedRing(slots, device, stream)


def on_device(device):
    """The thread's current CUDA device while uploading to ``device``."""
    device = torch.device(device)
    return torch.cuda.device(device) if device.type == "cuda" \
        else contextlib.nullcontext()


def _consume(dev: torch.Tensor, event) -> torch.Tensor:
    """Order the caller's stream after the batch's copy, and keep its
    memory from being reused before that stream is done with it."""
    if event is not None:
        current = torch.cuda.current_stream(dev.device)
        current.wait_event(event)
        dev.record_stream(current)
    return dev


def _read_padded(capture, batch: int, stop: threading.Event):
    """(frames padded to ``batch``, valid count, done, arrival times)
    batches of ``capture`` until it is done or ``stop`` is set (a live
    camera never is done). A live capture's arrival times are snapshotted
    right after its read, before the next one overwrites them (None for
    other captures)."""
    done = False
    while not done and not stop.is_set():
        frames, done = capture.read_batch(batch)
        arrivals = getattr(capture, "last_batch_arrivals", None)
        frames, n = pad_batch(frames, batch)
        if n:
            yield frames, n, done, arrivals


class DeviceFeeder:
    """Iterates (device_frames, count, done, last host frame, arrival
    times or None) batches, decoded and copied to ``device`` one batch
    ahead of the consumer.

    ``batches`` replaces the capture with an iterator of (frames, count)
    batches already padded (``prefetch_to_device``)."""

    def __init__(self, capture, batch: int, depth: int = 2,
                 device="cuda", *, batches=None):
        self.device = torch.device(device)
        self._stop = threading.Event()
        self._source = _read_padded(capture, batch, self._stop) \
            if batches is None \
            else ((frames, n, False, None) for frames, n in batches)
        self._ring = _side_ring(depth + 1, self.device)
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._thread = threading.Thread(target=self._pump, daemon=True,
                                        name="device-feeder")
        self._thread.start()

    def _put(self, item) -> None:
        # Bounded put re-checking stop: an unbounded put would block
        # forever once the consumer has gone.
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return
            except queue.Full:
                continue

    def _pump(self) -> None:
        err = None
        try:
            with on_device(self.device):
                for frames, n, done, arrivals in self._source:
                    if self._stop.is_set():
                        return
                    # Padded to the static batch size; the last real host
                    # frame rides along for the preview window.
                    dev, event = self._ring.upload(frames)
                    self._put((dev, event, n, done, frames[n - 1],
                               arrivals))
        except BaseException as exc:       # noqa: BLE001 — relayed, not eaten
            err = exc
        finally:
            # A sentinel must be enqueued even if a read or a copy raises,
            # or the consumer blocks forever. The failure rides it: None
            # would make a decode error look like the end of the video.
            self._put(err)       # None = end-of-stream; exception = failure

    def __iter__(self):
        while True:
            item = self._q.get()
            if item is None:
                return
            if isinstance(item, BaseException):
                raise RuntimeError("video capture failed "
                                   "mid-stream") from item
            dev, event, n, done, last_host, arrivals = item
            yield _consume(dev, event), n, done, last_host, arrivals

    def close(self) -> None:
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass


def prefetch_to_device(batches, depth: int = 2, device="cuda"):
    """Wrap an iterator of (numpy_frames, count) batches: the copies to
    ``device`` run one batch ahead on a worker thread, so they overlap the
    consumer's compute. Yields (device_frames, count)."""
    feeder = DeviceFeeder(None, 0, depth, device, batches=batches)
    try:
        for frames, n, _done, _last, _arrivals in feeder:
            yield frames, n
    finally:
        feeder.close()
