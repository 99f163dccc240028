"""The port's video and camera capture against the reference's, on the host:
``FileCapture`` (batches, frame size, seeking, the bounds crop),
``ParallelFileCapture`` (segments that straddle the encoder's keyframe
interval, seeking), ``open_capture``'s dispatch and knobs, ``LiveCapture``
opening a camera through ``cv2.VideoCapture``, ``filecheck``'s
``iter_video_frames`` and ``synth.encode_roundtrip``, each bitwise to the
reference's on the same file; and every cv2 entry point raising
``ImportError`` when cv2 is missing.

Videos are written to ``tmp_path`` with cv2 and read back on this machine by
both packages: decoded frames differ between cv2 builds, so no decoded
golden is kept.
"""

import json
import sys
import time

import numpy as np
import pytest
import torch

from camkifu_tpu import filecheck as jfilecheck
from camkifu_tpu.core import capture as jcapture
from camkifu_tpu.utils import synth as jsynth
from camkifu_tpu_torch import filecheck, oracle_cv2
from camkifu_tpu_torch.core import capture
from camkifu_tpu_torch.utils import synth

torch.set_num_threads(1)

#: Frames of the test video, its size and rate. OpenCV's FFMPEG writer puts
#: a keyframe every 12 frames: SEGMENTS straddle that interval.
N_FRAMES = 61
HW = (96, 160)
SEGMENTS = (7, 10)


def _write(path, frames, fps=25):
    import cv2

    vw = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), fps,
                         (frames[0].shape[1], frames[0].shape[0]))
    for f in frames:
        vw.write(f[:, :, ::-1])
    vw.release()
    return str(path)


def _frames(n=N_FRAMES, hw=HW, seed=5):
    """Distinct RGB frames: a gradient, a moving square and a noise patch."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:hw[0], :hw[1]]
    out = []
    for i in range(n):
        f = np.stack([(xx * 255 // hw[1]).astype(np.uint8),
                      (yy * 255 // hw[0]).astype(np.uint8),
                      np.full(hw, (7 * i) % 251, np.uint8)], -1)
        x0 = (3 * i) % (hw[1] - 24)
        f[20:44, x0:x0 + 24] = (250, 30, 90)
        f[:16, :16] = rng.integers(0, 256, (16, 16, 3), np.uint8)
        out.append(f)
    return out


@pytest.fixture(scope="module")
def video(tmp_path_factory):
    return _write(tmp_path_factory.mktemp("video") / "clip.mp4", _frames())


def _drain(cap, n):
    """Every batch of ``n`` until done → (list of (frames, done))."""
    out = []
    while True:
        frames, done = cap.read_batch(n)
        out.append((frames, done))
        if done:
            return out


def _same_batches(a, b):
    assert len(a) == len(b)
    for (fa, da), (fb, db) in zip(a, b):
        assert da == db and fa.shape == fb.shape and fa.dtype == fb.dtype
        assert np.array_equal(fa, fb)


@pytest.mark.parametrize("bounds", [(0.0, 1.0), (0.25, 0.75)])
def test_file_capture_matches_the_reference(video, bounds):
    """Batches, ``frame_size``, ``get_position`` after each read and after a
    seek, and the tail after ``set_position``: bitwise the reference's."""
    cap, jcap = capture.FileCapture(video, bounds), \
        jcapture.FileCapture(video, bounds)
    h = HW[0] if bounds == (0.0, 1.0) else HW[0] // 2
    try:
        assert cap.frame_size == jcap.frame_size == (h, HW[1])
        assert cap.total == jcap.total == N_FRAMES
        for n in (5, 16, 1):
            got, ref = cap.read_batch(n), jcap.read_batch(n)
            _same_batches([got], [ref])
            assert cap.get_position() == jcap.get_position()
        assert cap.read_batch(0)[0].shape == jcap.read_batch(0)[0].shape
        for c in (cap, jcap):
            c.set_position(0.6)
        assert cap.get_position() == jcap.get_position()
        _same_batches(_drain(cap, 9), _drain(jcap, 9))
        assert cap.read_batch(4)[0].shape == (0, 1, 1, 3)
    finally:
        cap.release()
        jcap.release()


@pytest.mark.parametrize("workers", [2, 3])
@pytest.mark.parametrize("segment", SEGMENTS)
def test_parallel_file_capture_matches_sequential(video, workers, segment):
    """N workers on segments that straddle keyframes: the same frames as
    sequential decode and as the reference's parallel decoder, in the same
    batches; then a seek, the same again."""
    seq = capture.FileCapture(video)
    par = capture.ParallelFileCapture(video, workers=workers,
                                      segment=segment)
    jpar = jcapture.ParallelFileCapture(video, workers=workers,
                                        segment=segment)
    try:
        got, want, ref = _drain(par, 13), _drain(seq, 13), _drain(jpar, 13)
        _same_batches(got, want)
        _same_batches(got, ref)
        assert sum(len(f) for f, _ in got) == N_FRAMES
        assert par.dropped_frames == jpar.dropped_frames == 0
        assert par.frame_size == jpar.frame_size == HW
        for c in (par, jpar, seq):
            c.set_position(0.5)
        assert par.get_position() == jpar.get_position()
        _same_batches(_drain(par, 8), _drain(jpar, 8))
    finally:
        for c in (seq, par, jpar):
            c.release()


class FakeCamera:
    """Stands in for cv2.VideoCapture(index): ``N_CAM`` numbered BGR frames,
    then nothing."""

    N_CAM = 6

    def __init__(self, index):
        self.index = index
        self.n = 0
        self.opened = index != 99

    def isOpened(self):
        return self.opened

    def read(self):
        if self.n >= self.N_CAM:
            time.sleep(0.002)
            return False, None
        self.n += 1
        frame = np.zeros((12, 10, 3), np.uint8)
        frame[..., 0] = self.n
        frame[..., 2] = 200 + self.index
        return True, frame

    def release(self):
        self.opened = False


def _settle(cap, n, timeout=5.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        with cap._lock:
            if len(cap._ring) >= n:
                return
        time.sleep(0.005)
    raise AssertionError("the camera's frames never reached the ring")


@pytest.mark.parametrize("bounds", [(0.0, 1.0), (0.5, 1.0)])
def test_live_capture_opens_a_camera_like_the_reference(monkeypatch,
                                                        bounds):
    """``LiveCapture(index)`` opens ``cv2.VideoCapture(index)``: both
    packages, on the same fake camera, deliver the same RGB batch (the
    frames converted from BGR and cropped), and release the camera."""
    import cv2

    monkeypatch.setattr(cv2, "VideoCapture", FakeCamera)
    out = []
    for mod in (capture, jcapture):
        cap = mod.LiveCapture(3, bounds, max_wait_s=0.2)
        try:
            assert cap.cap.index == 3
            _settle(cap, FakeCamera.N_CAM)
            frames, done = cap.read_batch(FakeCamera.N_CAM)
            out.append((frames, done, cap.frame_size,
                        len(cap.last_batch_arrivals)))
        finally:
            cap.release()
        assert not cap.cap.opened
    (got, gdone, gsize, garr), (ref, rdone, rsize, rarr) = out
    assert np.array_equal(got, ref) and got.shape[0] == FakeCamera.N_CAM
    assert gdone is rdone is False and gsize == rsize and garr == rarr
    assert got[0, 0, 0].tolist() == [203, 0, 1]
    with pytest.raises(RuntimeError, match="cannot open camera 99"):
        capture.LiveCapture(99)


@pytest.mark.parametrize("source,kw,cls,knobs", [
    (0, {}, "LiveCapture", {"max_wait_s": 2.0}),
    ("1", {"live_wait_s": 0.25}, "LiveCapture", {"max_wait_s": 0.25}),
    ("path", {}, "FileCapture", {}),
    ("path", {"decoders": 3}, "ParallelFileCapture",
     {"workers": 3, "segment": 32}),
    ("path", {"decoders": 2, "bounds": (0.25, 0.75)},
     "ParallelFileCapture", {"workers": 2, "bounds": (0.25, 0.75)}),
    ("frames", {}, "ArrayCapture", {}),
])
def test_open_capture_matches_the_reference(monkeypatch, video, source, kw,
                                            cls, knobs):
    """An int or a digit string is a camera (``live_wait_s`` its batch
    wait), anything else a file (``decoders`` > 1 the parallel decoder),
    in-memory frames an ``ArrayCapture``: the same class and knobs as the
    reference's ``open_capture``."""
    import cv2

    if source in (0, "1"):
        monkeypatch.setattr(cv2, "VideoCapture", FakeCamera)
    src = {"path": video, "frames": _frames(3)}.get(source, source)
    kw = dict(kw)
    bounds = kw.pop("bounds", (0.0, 1.0))
    caps = [mod.open_capture(src, bounds, **kw)
            for mod in (capture, jcapture)]
    try:
        assert [type(c).__name__ for c in caps] == [cls, cls]
        assert type(caps[0]) is getattr(capture, cls)
        for name, value in knobs.items():
            assert getattr(caps[0], name) == getattr(caps[1], name) == value
        if cls != "LiveCapture":
            _same_batches(_drain(caps[0], 16), _drain(caps[1], 16))
    finally:
        for c in caps:
            c.release()


def test_open_capture_falls_back_to_sequential_decode(monkeypatch, video):
    """A file whose frame count cannot be read (``ParallelFileCapture``
    raises ``ValueError``) is decoded sequentially, in both packages."""
    import cv2

    real = cv2.VideoCapture

    class NoCount:
        def __init__(self, path):
            self._cap = real(path)

        def get(self, prop):
            return 0.0 if prop == cv2.CAP_PROP_FRAME_COUNT \
                else self._cap.get(prop)

        def __getattr__(self, name):
            return getattr(self._cap, name)

    monkeypatch.setattr(cv2, "VideoCapture", NoCount)
    with pytest.raises(ValueError, match="unknown frame count"):
        capture.ParallelFileCapture(video, workers=2)
    caps = [mod.open_capture(video, decoders=4)
            for mod in (capture, jcapture)]
    try:
        assert [type(c).__name__ for c in caps] == ["FileCapture"] * 2
        assert caps[0].total == caps[1].total == -1
        got, ref = _drain(caps[0], 32), _drain(caps[1], 32)
        _same_batches(got, ref)
        assert sum(len(f) for f, _ in got) == N_FRAMES
        assert caps[0].get_position() == 0.0
    finally:
        for c in caps:
            c.release()


@pytest.mark.parametrize("decoders", [1, 2])
@pytest.mark.parametrize("bounds", [(0.0, 1.0), (0.1, 0.9)])
def test_iter_video_frames_matches_the_reference(video, decoders, bounds):
    got = list(filecheck.iter_video_frames(video, bounds, decoders))
    ref = list(jfilecheck.iter_video_frames(video, bounds, decoders))
    assert len(got) == len(ref) == N_FRAMES
    for a, b in zip(got, ref):
        assert a.dtype == b.dtype == np.uint8 and np.array_equal(a, b)
    with pytest.raises(FileNotFoundError, match="cannot open video"):
        next(filecheck.iter_video_frames(video + ".missing"))


def test_encode_roundtrip_matches_the_reference(tmp_path):
    """The same frames through both packages' mp4 round trip decode to the
    same bytes; the port takes tensors as well as arrays; an empty input
    raises as the reference's does."""
    frames = _frames(23, hw=(64, 96), seed=9)
    got = synth.encode_roundtrip(iter(frames))
    ref = jsynth.encode_roundtrip(iter(frames))
    assert len(got) == len(ref) == 23
    assert all(np.array_equal(a, b) for a, b in zip(got, ref))
    assert not all(np.array_equal(a, f) for a, f in zip(got, frames))
    tensors = synth.encode_roundtrip(torch.from_numpy(f) for f in frames)
    assert all(np.array_equal(a, b) for a, b in zip(tensors, got))
    kept = tmp_path / "kept.mp4"
    synth.encode_roundtrip(iter(frames), path=str(kept))
    assert kept.stat().st_size > 0
    for mod in (synth, jsynth):
        with pytest.raises(RuntimeError, match="got no frames"):
            mod.encode_roundtrip(iter(()))


def test_cv2_entry_points_raise_import_error_without_cv2(monkeypatch,
                                                         video):
    """With cv2 missing, every entry point that decodes, encodes or opens a
    camera raises ``ImportError`` rather than read an empty stream."""
    monkeypatch.setitem(sys.modules, "cv2", None)
    frame = np.zeros((64, 96, 3), np.uint8)
    calls = [
        lambda: capture.open_capture(video),
        lambda: capture.open_capture(video, decoders=2),
        lambda: capture.open_capture(0),
        lambda: capture.open_capture("0", live_wait_s=0.1),
        lambda: capture.LiveCapture(0),
        lambda: capture.FileCapture(video),
        lambda: capture.ParallelFileCapture(video),
        lambda: next(filecheck.iter_video_frames(video)),
        lambda: next(filecheck.iter_video_frames(video, decoders=2)),
        lambda: synth.encode_roundtrip(iter([frame])),
        lambda: oracle_cv2.detect_corners_cv2(frame),
        lambda: oracle_cv2.classify_frame_cv2(
            frame, np.array([[10, 10], [80, 10], [80, 50], [10, 50]],
                            np.float32)),
    ]
    for call in calls:
        with pytest.raises(ImportError):
            call()
    assert isinstance(capture.open_capture([frame]), capture.ArrayCapture)


def test_golden_input_probes_read_an_image(tmp_path, capsys, monkeypatch):
    """``bf_auto``'s and ``sf_clustering``'s ``__main__`` probes on an image
    file (read through cv2, as the reference's): the corners printed near
    the truth and the overlay written; the board read with the detected
    corners and with given ones equal to the truth's. Without cv2 both
    raise ``ImportError``."""
    import cv2

    from camkifu_tpu_torch.board import bf_auto
    from camkifu_tpu_torch.stone import sf_clustering
    from camkifu_tpu_torch.utils import board_to_ascii
    from camkifu_tpu_torch.utils.still import render_still

    labels = np.zeros((19, 19), np.int8)
    labels[3, 3], labels[15, 15], labels[3, 15] = 1, 2, 1
    frame, truth = render_still(labels, frame_hw=(720, 1280), seed=0)
    image, overlay = str(tmp_path / "still.png"), str(tmp_path / "ov.png")
    cv2.imwrite(image, frame[:, :, ::-1])
    assert bf_auto._probe_main([image, overlay, "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    corners = np.array(json.loads(lines[0].split(":", 1)[1]), np.float32)
    assert np.abs(corners - truth).max() < 2.0
    assert float(lines[1].split(":")[1]) > 0.5
    drawn = cv2.imread(overlay)
    assert drawn.shape == frame.shape
    assert (drawn[:, :, ::-1] != frame).any(-1).sum() > 0
    given = ",".join(str(float(v)) for v in truth.reshape(-1))
    for argv in ([image], [image, given]):
        assert sf_clustering._probe_main(argv + ["--device", "cpu"]) == 0
        out = capsys.readouterr().out
        assert board_to_ascii(labels) in out and "stones: 3," in out
    monkeypatch.setitem(sys.modules, "cv2", None)
    for probe in (bf_auto._probe_main, sf_clustering._probe_main):
        with pytest.raises(ImportError):
            probe([image, "--device", "cpu"])
