"""The port's live path against the reference's: ``PacedCamera`` (the
reference test's copy), ``LiveCapture`` around an injected camera (batch
fill, the ``max_wait_s`` partial batch, the ring, arrival times), the
feeder carrying those arrival times, the threaded ``VManager``'s live
latency fields, and the camera and file paths that need cv2 raising
``NotImplementedError``."""

import json
import threading
import time

import numpy as np
import pytest
import torch

from camkifu_tpu.core import capture as jcapture
from camkifu_tpu_torch.core import capture, feeder
from camkifu_tpu_torch.core.video import VidProcessor
from camkifu_tpu_torch.core.vmanager import VManager
from camkifu_tpu_torch.utils.latency import PacedCamera

torch.set_num_threads(1)


def test_paced_camera_timing():
    frames = [np.zeros((8, 8, 3), np.uint8)] * 10
    cam = PacedCamera(frames, fps=50.0)
    t0 = time.perf_counter()
    for _ in range(10):
        ok, f = cam.read()
        assert ok and f.shape == (8, 8, 3)
    dt = time.perf_counter() - t0
    assert 0.15 <= dt <= 1.0, dt          # ~0.18 s at 50 fps, paced
    assert len(cam.emit_times) == 10
    ok, _ = cam.read()
    assert not ok                          # stream exhausted


class _Burst:
    """A camera that hands out ``n`` distinct BGR frames as fast as asked,
    then nothing."""

    def __init__(self, n: int, hw=(6, 5)):
        rng = np.random.default_rng(n)
        self.frames = list(rng.integers(0, 256, (n, *hw, 3), dtype=np.uint8))
        self.i = 0
        self.lock = threading.Lock()
        self.released = False

    def isOpened(self):
        return True

    def read(self):
        with self.lock:
            if self.i >= len(self.frames):
                time.sleep(0.002)
                return False, None
            self.i += 1
            return True, self.frames[self.i - 1]

    def release(self):
        self.released = True


def _wait_for(cap, k, timeout=5.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        with cap._lock:
            if len(cap._ring) >= k:
                return
        time.sleep(0.005)
    raise AssertionError("the grabber did not fill the ring")


@pytest.mark.parametrize("module", [capture, jcapture],
                         ids=["port", "reference"])
def test_live_capture_batches(module):
    """A full batch is the newest frames in RGB with rising arrival times;
    a sparse ring waits ``max_wait_s`` and dispatches what arrived; an
    empty one returns no frames and no arrivals; the ring keeps the
    newest ``ring`` frames. The port's capture and the reference's give
    the same batches."""
    cam = _Burst(6)
    cap = module.LiveCapture(0, camera=cam, ring=4, max_wait_s=0.2)
    try:
        _wait_for(cap, 4)
        time.sleep(0.05)                   # the burst is over
        frames, done = cap.read_batch(3)
        assert not done and frames.shape == (3, 6, 5, 3)
        want = np.stack([f[:, :, ::-1] for f in cam.frames[3:6]])
        assert np.array_equal(frames, want)
        arr = cap.last_batch_arrivals
        assert arr.shape == (3,) and np.all(np.diff(arr) >= 0)
        t0 = time.perf_counter()
        frames, _ = cap.read_batch(2)
        assert frames.shape == (0, 1, 1, 3)
        assert cap.last_batch_arrivals is None
        assert time.perf_counter() - t0 >= 0.19
        with cam.lock:
            cam.frames.append(cam.frames[0])
        t0 = time.perf_counter()
        frames, _ = cap.read_batch(8)
        assert frames.shape == (1, 6, 5, 3)
        assert 0.19 <= time.perf_counter() - t0 < 2.0
        assert cap.frame_size == (0, 0)
    finally:
        cap.release()
    assert cam.released


def test_cv2_paths_raise():
    with pytest.raises(NotImplementedError, match="cv2.VideoCapture"):
        capture.LiveCapture(0)
    for video in (0, "1"):
        with pytest.raises(NotImplementedError, match="cv2"):
            capture.open_capture(video)
    with pytest.raises(NotImplementedError, match="cv2"):
        capture.open_capture("game.mp4")

    class Closed(_Burst):
        def isOpened(self):
            return False

    with pytest.raises(RuntimeError, match="cannot open camera 2"):
        capture.LiveCapture(2, camera=Closed(1))


def test_feeder_carries_the_arrival_times():
    """A batch's arrival times, snapshotted when it was read, ride with it
    through ``DeviceFeeder`` (a live ring drops the older frames); the
    feeder's thread stops on ``close`` though a camera never ends; an
    in-memory capture has no arrival times."""
    cam = _Burst(8)
    cap = capture.LiveCapture(0, camera=cam, ring=16, max_wait_s=0.05)
    try:
        _wait_for(cap, 8)
        feed = feeder.DeviceFeeder(cap, 3, device="cpu")
        frames, n, done, last, arrivals = next(iter(feed))
        feed.close()
        feed._thread.join(timeout=2.0)
        assert not feed._thread.is_alive()
    finally:
        cap.release()
    assert n == 3 and not done and frames.shape == (3, 6, 5, 3)
    assert arrivals.shape == (3,) and np.all(np.diff(arrivals) >= 0)
    want = np.stack([f[:, :, ::-1] for f in cam.frames[5:8]])
    assert np.array_equal(frames.numpy(), want)
    assert np.array_equal(last, want[-1])
    frames = list(np.zeros((5, 4, 4, 3), np.uint8))
    items = list(feeder.DeviceFeeder(capture.ArrayCapture(frames), 4,
                                     device="cpu"))
    assert [(n, a) for _, n, _, _, a in items] == [(4, None), (1, None)]


class _Idle(VidProcessor):
    label = "idle"

    def _doframe(self, frames, n=None):
        self.metadata["seen"] = int(n)


def test_threaded_manager_records_live_latency(tmp_path):
    """The threaded ``VManager`` over a ``LiveCapture`` records each batch's
    newest and oldest frame-arrival latency, oldest ≥ newest ≥ 0."""
    stats = tmp_path / "stats.jsonl"
    cam = PacedCamera(list(np.zeros((12, 6, 5, 3), np.uint8)), fps=60.0)
    vm = VManager(None, video=None, bf_class=_Idle, sf_class=_Idle, batch=4,
                  stats_path=str(stats), device="cpu")
    vm.capture = capture.LiveCapture(0, camera=cam, ring=64, max_wait_s=0.1)
    vm.init_capture = lambda: None
    vm.vision_on()
    deadline = time.time() + 10.0
    try:
        while time.time() < deadline and len(cam.emit_times) < 12:
            time.sleep(0.02)
        time.sleep(0.3)                # the last batch's wait and record
    finally:
        vm.vision_off()
        vm.capture.release()
    recs = [json.loads(line) for line in stats.read_text().splitlines()]
    assert recs and 4 <= sum(r["frames"] for r in recs) <= 12
    for r in recs:
        assert r["latency_oldest_ms"] >= r["latency_newest_ms"] >= 0.0
