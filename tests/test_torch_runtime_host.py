"""The runtime's host logic, the port against the JAX package on the CPU,
with no JAX compile: ``BoardFinderAuto.report_tracking``'s trip-wires,
``_detect``'s median, EMA and bump rules on recorded detections, the
pose veto, bulk self-correction, human corrections and the tracking
discontinuity of ``SfMeta`` / ``StonesFinder``, and the capture, stats
and grid helpers. Every state is held bitwise equal.
"""

import itertools
import sys
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from camkifu_tpu.board import bf_auto as jbf_auto
from camkifu_tpu.board.boardfinder import GobanCorners as JGobanCorners
from camkifu_tpu.core import capture as jcapture
from camkifu_tpu.core import feeder as jfeeder
from camkifu_tpu.core.controllerv import ControllerVSeq as JControllerVSeq
from camkifu_tpu.stone import sf_meta as jsf_meta
from camkifu_tpu.stone import stonesfinder as jstonesfinder
from camkifu_tpu.utils import profiling as jprofiling
from camkifu_tpu_torch.board import bf_auto
from camkifu_tpu_torch.board.boardfinder import GobanCorners
from camkifu_tpu_torch.core import capture, feeder
from camkifu_tpu_torch.core.controllerv import ControllerVSeq
from camkifu_tpu_torch.gamemodel.move import Move
from camkifu_tpu_torch.stone import sf_meta, stonesfinder
from camkifu_tpu_torch.utils import profiling
from camkifu_tpu_torch.utils.still import default_corners, sample_moves

torch.set_num_threads(1)

HW = (720, 1280)
BASE = default_corners(HW)                      # cell ≈ 29 px
STATE_FIELDS = ("_since_detect", "_align_anchor", "_prev_tracked_last",
                "_estimate", "suspect_batch", "fresh_anchor", "track_seed",
                "corners_batch", "metadata")


class _SF:
    """A stones finder that counts tracking discontinuities."""

    def __init__(self):
        self.discontinuities = 0

    def on_tracking_discontinuity(self):
        self.discontinuities += 1


class _VM:
    def __init__(self):
        self.stones_finder = _SF()


def _bare(mod):
    """A ``BoardFinderAuto`` of ``mod`` without a manager, as
    tests/test_tracking.py builds one."""
    bf = mod.BoardFinderAuto.__new__(mod.BoardFinderAuto)
    bf.metadata = {}
    bf._align_anchor = None
    bf._since_detect = 0
    bf.track_seed = "seed"
    bf._prev_tracked_last = None
    bf._estimate = None
    bf.suspect_batch = False
    bf.fresh_anchor = False
    bf.corners_batch = None
    bf.gsize = 19
    bf.lens = None
    bf._lens_checked = False
    bf.vmanager = _VM()
    return bf


def _same(a, b) -> bool:
    if a is None or b is None:
        return a is None and b is None
    if isinstance(a, (np.ndarray, jnp.ndarray)) or \
            isinstance(b, (np.ndarray, jnp.ndarray)):
        a, b = np.asarray(a), np.asarray(b)
        return a.dtype == b.dtype and np.array_equal(a, b, equal_nan=True)
    return a == b and type(a) is type(b)


def _assert_same_state(bf, jbf):
    for name in STATE_FIELDS:
        assert _same(getattr(bf, name), getattr(jbf, name)), name
    assert bf.vmanager.stones_finder.discontinuities == \
        jbf.vmanager.stones_finder.discontinuities


def _steady(seed: int, shift=(0.0, 0.0)) -> np.ndarray:
    """16 frames of corners jittering 0.3 px about BASE + shift."""
    rng = np.random.default_rng(seed)
    return (BASE + np.float32(shift) + rng.normal(0, 0.3, (16, 4, 2))) \
        .astype(np.float32)


def _knocked(seed: int, at: int, back: int | None = None) -> np.ndarray:
    """``_steady`` with a (34, −22) px knock from frame ``at`` (until
    ``back``, a spike)."""
    cb = _steady(seed)
    cb[at:back] += np.float32([34.0, -22.0])
    return cb


#: Each scenario: the (corners, mean sharpness, mean align) of successive
#: batches.
SCENARIOS = {
    "spike": [(_steady(0), 4.0, 2.0), (_knocked(1, 6, 8), 4.0, 2.0),
              (_steady(2), 4.0, 2.0)],
    "deferred jump": [(_steady(0), 4.0, 2.0), (_knocked(1, 15), 4.0, 2.0),
                      (_steady(2, (34.0, -22.0)), 4.0, 2.0)],
    "deferred spike": [(_steady(0), 4.0, 2.0), (_knocked(1, 15), 4.0, 2.0),
                       (_steady(2), 4.0, 2.0)],
    "confirmed jump": [(_steady(0), 4.0, 2.0), (_knocked(1, 8), 4.0, 2.0),
                       (_steady(2, (34.0, -22.0)), 4.0, 2.0)],
    "boundary jump": [(_steady(0), 4.0, 2.0),
                      (_steady(1, (30.0, 0.0)), 4.0, 2.0)],
    "alignment decay": [(_steady(0), 4.0, 2.0), (_steady(1), 4.0, 1.5),
                        (_steady(2), 4.0, 1.1)],
    "baseline rise": [(_steady(0), 3.0, 0.30), (_steady(1), 3.0, 0.60),
                      (_steady(2), 3.0, 0.25)],
    "sharpness collapse": [(_steady(0), 4.0, 2.0), (_steady(1), 1.2, 2.0),
                           (_steady(2), 4.0, None)],
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_report_tracking_matches_the_reference(name):
    bf, jbf = _bare(bf_auto), _bare(jbf_auto)
    trips = set()
    for i, (cb, sharp, align) in enumerate(SCENARIOS[name]):
        seed = f"seed{i}"
        bf.report_tracking(cb.copy(), seed, sharp, align)
        jbf.report_tracking(cb.copy(), seed, sharp, align)
        _assert_same_state(bf, jbf)
        trips.add(bf._since_detect >= 10 ** 9)
        if bf._since_detect >= 10 ** 9:     # the host re-detects: reset
            for b in (bf, jbf):
                b._since_detect = 0
                b.track_seed = "seed"
    assert trips == ({False} if name in ("spike", "deferred spike")
                     else {False, True})


def test_batch_align_matches_the_reference():
    rng = np.random.default_rng(3)
    for _ in range(20):
        align = rng.random(16).astype(np.float32) * 3
        sharp = (rng.random(16) * 3).astype(np.float32)
        assert bf_auto.BoardFinderAuto.batch_align(align, sharp) == \
            jbf_auto.BoardFinderAuto.batch_align(align, sharp)


# -- _detect on recorded detections -----------------------------------------

def _record_detections(seed: int, shift=(0.0, 0.0), nan=False, score=0.4):
    """Four detections scattered 2 px about BASE + shift, and their
    scores."""
    rng = np.random.default_rng(seed)
    corners = (BASE + np.float32(shift)
               + rng.normal(0, 2.0, (4, 4, 2))).astype(np.float32)
    if nan:
        corners[1, 2, 0] = np.nan
    return corners, np.full((4,), score, np.float32)


def _even_count_trap() -> tuple[np.ndarray, np.ndarray]:
    """Recorded detections whose median over four frames ``torch.median``
    (the lower middle value) gets wrong against ``jnp.median``."""
    for seed in itertools.count(100):
        corners, scores = _record_detections(seed)
        ref = np.asarray(jnp.median(jnp.asarray(corners), axis=0))
        if not np.array_equal(
                torch.median(torch.from_numpy(corners), 0).values.numpy(),
                ref):
            return corners, scores


def _stub_detection(monkeypatch, recorded):
    """Replace both packages' detectors with the recorded outputs, one
    call each; the lens calibration finds no lens."""
    jq, q = list(recorded), list(recorded)
    monkeypatch.setattr(jbf_auto, "detect_batch", lambda sample, gsize: tuple(
        jnp.asarray(x) for x in jq.pop(0)))
    monkeypatch.setattr(bf_auto, "detect_batch", lambda sample, gsize: tuple(
        torch.from_numpy(x) for x in q.pop(0)))
    monkeypatch.setattr(jbf_auto, "estimate_lens_k1",
                        lambda frame, gsize: (0.0, 1.0))
    monkeypatch.setattr(bf_auto, "estimate_lens_k1",
                        lambda frame, gsize: (0.0, 1.0))


def _detect_bares():
    bf, jbf = _bare(bf_auto), _bare(jbf_auto)
    bf.corners, jbf.corners = GobanCorners(), JGobanCorners()
    return bf, jbf


def test_detect_matches_the_reference(monkeypatch):
    """Four distinct detections (the even-count median), a NaN detection,
    a score below 0.1, EMA blends and a one-cell bump: the same verdicts,
    the bitwise same estimate and published corners."""
    cell = float(np.linalg.norm(BASE[1] - BASE[0]) / 18)
    recorded = [_even_count_trap(),
                _record_detections(1),
                _record_detections(2, nan=True),
                _record_detections(3, score=0.05),
                _record_detections(4, shift=(0.4 * cell, 0.0)),
                _record_detections(5, shift=(1.6 * cell, -0.5 * cell)),
                _record_detections(6, shift=(1.6 * cell, -0.5 * cell))]
    _stub_detection(monkeypatch, recorded)
    bf, jbf = _detect_bares()
    frames = np.zeros((16, 8, 8, 3), np.uint8)
    verdicts = []
    for _ in recorded:
        ok = bf._detect(torch.from_numpy(frames))
        assert ok == jbf._detect(frames)
        verdicts.append(ok)
        assert _same(bf._estimate, jbf._estimate)
        assert _same(bf.corners.points, jbf.corners.points)
        assert bf.metadata == jbf.metadata
    assert verdicts == [True, True, False, False, True, True, True]
    assert bf.metadata["lens_k1"] == 0.0 and bf._lens_checked


def test_detect_median_is_jnp_median(monkeypatch):
    """The first anchor's estimate is the even-count median that
    ``jnp.median`` takes, where ``torch.median`` differs; a NaN detection
    makes it NaN."""
    recorded = [_even_count_trap()]
    _stub_detection(monkeypatch, recorded)
    bf, _ = _detect_bares()
    assert bf._detect(torch.zeros((16, 8, 8, 3), dtype=torch.uint8))
    ref = np.asarray(jnp.median(jnp.asarray(recorded[0][0]), axis=0))
    assert np.array_equal(bf._estimate, ref)
    nan = _record_detections(2, nan=True)
    _stub_detection(monkeypatch, [nan])
    bf, _ = _detect_bares()
    assert not bf._detect(torch.zeros((16, 8, 8, 3), dtype=torch.uint8))
    assert bf._estimate is None


# -- the stones finder's host logic -------------------------------------------

class _Host:
    """A manager of one package: its controller, no board finder."""

    def __init__(self, controller, device=None):
        self.controller = controller
        self.board_finder = None
        if device is not None:
            self.device = device


def _finders(moves):
    """Both packages' SfMeta on controllers that played ``moves``."""
    ctrl, jctrl = ControllerVSeq(), JControllerVSeq()
    for c in (ctrl, jctrl):
        for m in moves:
            c.append(Move("np", (m.color, m.row, m.col)))
    sf = sf_meta.SfMeta(_Host(ctrl, device="cpu"))
    jsf = jsf_meta.SfMeta(_Host(jctrl))
    # A scan state with votes everywhere, as after a few batches.
    rng = np.random.default_rng(7)
    seeded = {"votes": rng.random((19, 19, 3)).astype(np.float32) * 4,
              "stable": ctrl.stones().astype(np.int8),
              "bg": rng.random((76, 76)).astype(np.float32),
              "prev": rng.random((76, 76)).astype(np.float32),
              "trust": rng.random((3, 3)).astype(np.float32),
              "frame_count": np.int32(40)}
    sf.state = sf_meta.meta_state_from_numpy(seeded, device="cpu")
    jsf.state = jsf_meta.MetaState(**{k: jnp.asarray(v)
                                      for k, v in seeded.items()})
    return sf, jsf


def _assert_same_finders(sf, jsf):
    state = sf_meta.meta_state_to_numpy(sf.state)
    for name, value in state.items():
        ref = np.asarray(getattr(jsf.state, name))
        assert value.dtype == ref.dtype and np.array_equal(value, ref), name
    assert sf.metadata == jsf.metadata
    assert np.array_equal(sf._contradict, jsf._contradict)
    assert np.array_equal(sf.extractor.state(), jsf.extractor.state())
    got = [(m.color, m.row, m.col) for m in sf.controller.kifu.moves()]
    ref = [(m.color, m.row, m.col) for m in jsf.controller.kifu.moves()]
    assert got == ref
    assert np.array_equal(sf.controller.stones(), jsf.controller.stones())


def _readings(board: np.ndarray, n: int) -> np.ndarray:
    return np.broadcast_to(board, (n,) + board.shape).astype(np.int8).copy()


def test_consume_and_bulk_correction_match_the_reference():
    """A new move, then an intersection contradicting the game for
    BULK_CORRECT_AFTER frames: the same piped moves and bulk fix."""
    moves = sample_moves(12, seed=3)
    sf, jsf = _finders(moves)
    board = sf.controller.stones()
    nxt = next((r, c) for r in range(19) for c in range(19)
               if board[r, c] == 0)
    after = board.copy()
    after[nxt] = 1 if moves[-1].color == "W" else 2
    wrong = after.copy()
    r0, c0 = moves[0].row, moves[0].col
    wrong[r0, c0] = 0                          # a stone the camera lost
    for labels, n in ((_readings(after, 16), 16), (_readings(after, 16), 9),
                      (_readings(wrong, 16), 16), (_readings(wrong, 16), 16),
                      (_readings(wrong, 16), 16)):
        sf._consume(torch.from_numpy(labels), n)
        jsf._consume(jnp.asarray(labels), n)
        _assert_same_finders(sf, jsf)
    # One move appended, the lost stone's move deleted by the bulk fix.
    assert len(sf.controller.kifu) == len(moves)
    assert sf.metadata["bulk_fixes"] == 1
    assert sf.controller.stones()[nxt] != 0
    assert sf.controller.stones()[r0, c0] == 0
    assert jstonesfinder.BULK_CORRECT_AFTER == \
        stonesfinder.BULK_CORRECT_AFTER == 40


@pytest.mark.parametrize("agree", [0.7, 0.9])
def test_pose_veto_matches_the_reference(agree):
    """A fresh anchor whose readings reproduce ``agree`` of the committed
    stones: the same verdict, board finder state and re-seeded scan."""
    moves = sample_moves(40, seed=5)
    sf, jsf = _finders(moves)
    committed = sf.controller.stones()
    stones = np.argwhere(committed != 0)
    labels = _readings(committed, 16)
    rng = np.random.default_rng(11)
    lost = stones[rng.permutation(len(stones))[
        :int(round((1 - agree) * len(stones)))]]
    labels[:, lost[:, 0], lost[:, 1]] = 0
    bf, jbf = _bare(bf_auto), _bare(jbf_auto)
    bf.corners, jbf.corners = GobanCorners(BASE), JGobanCorners(BASE)
    bf.mtx = jbf.mtx = np.eye(3, dtype=np.float32)
    vetoed = sf._pose_vetoed(labels, bf)
    assert vetoed == jsf._pose_vetoed(jnp.asarray(labels), jbf)
    assert vetoed == (agree < sf_meta.POSE_VETO_MIN_AGREE)
    assert sf_meta.POSE_VETO_MIN_AGREE == jsf_meta.POSE_VETO_MIN_AGREE
    assert sf_meta.POSE_VETO_MIN_STONES == jsf_meta.POSE_VETO_MIN_STONES
    _assert_same_finders(sf, jsf)
    _assert_same_state(bf, jbf)
    assert bf.ready() == jbf.ready() == (not vetoed)


def test_corrections_and_discontinuity_match_the_reference():
    """A human relocation (``corrected``: votes reset where it touched)
    and a camera bump (``on_tracking_discontinuity``: the scan re-seeded
    from the game)."""
    moves = sample_moves(20, seed=8)
    sf, jsf = _finders(moves)
    last = sf.controller.kifu.moves()[-1]
    col = next(c for c in range(19)
               if sf.controller.stones()[last.row, c] == 0)
    fixed = Move("np", (last.color, last.row, col))
    for s in (sf, jsf):
        s.controller.relocate(last, fixed)
        s.corrected(last, fixed)
    _assert_same_finders(sf, jsf)
    assert sf.extractor.state()[last.row, col] != 0
    sf.on_tracking_discontinuity()
    jsf.on_tracking_discontinuity()
    _assert_same_finders(sf, jsf)


def test_sgf_resume_seeds_the_scan(tmp_path):
    """A controller resumed from an SGF: both finders start from its board
    (``set_stable``) with the same extractor state."""
    from camkifu_tpu_torch.gamemodel.kifu import Kifu

    path = str(tmp_path / "game.sgf")
    kifu = Kifu.new(path)
    for m in sample_moves(30, seed=2):
        kifu.append(m)
    kifu.save()
    sf = sf_meta.SfMeta(_Host(ControllerVSeq(sgffile=path), device="cpu"))
    jsf = jsf_meta.SfMeta(_Host(JControllerVSeq(sgffile=path)))
    assert np.array_equal(sf.state.stable.numpy(),
                          np.asarray(jsf.state.stable))
    assert sf.state.stable.numpy().any()
    assert np.array_equal(sf.extractor.state(), jsf.extractor.state())
    assert sf.extractor.next_color() == jsf.extractor.next_color()


def test_sfmeta_refuses_a_neural_checkpoint(tmp_path, monkeypatch):
    """No checkpoint: no neural voter. The reference's orbax checkpoint
    without one of the port's: an error saying how to convert it, never a
    silent two-voter reading."""
    monkeypatch.setattr(sf_meta, "NEURAL_CKPT", str(tmp_path / "none.npz"))
    monkeypatch.setattr(sf_meta, "JAX_NEURAL_CKPT", str(tmp_path / "none"))
    assert sf_meta.SfMeta(_Host(None, device="cpu")).neural_params is None
    monkeypatch.setattr(sf_meta, "JAX_NEURAL_CKPT", str(tmp_path))
    with pytest.raises(RuntimeError, match="np.savez"):
        sf_meta.SfMeta(_Host(None, device="cpu"))


# -- capture, stats and the grid ------------------------------------------------

def test_pad_batch_matches_the_reference():
    f = np.arange(3 * 2 * 2 * 3, dtype=np.uint8).reshape(3, 2, 2, 3)
    for frames, size in ((f, 8), (f, 3), (f, 2),
                         (np.zeros((0, 1, 1, 3), np.uint8), 4)):
        got, n = capture.pad_batch(frames, size)
        ref, jn = jcapture.pad_batch(frames, size)
        assert n == jn and np.array_equal(got, ref)


def test_array_capture_matches_the_reference(tmp_path, monkeypatch):
    frames = [np.full((6, 4, 3), i, np.uint8) for i in range(11)]
    cap = capture.ArrayCapture(frames, bounds=(0.25, 0.75))
    jcap = jcapture.ArrayCapture(frames, bounds=(0.25, 0.75))
    assert cap.frame_size == jcap.frame_size == (3, 4)
    for n in (4, 4, 4, 4):
        (got, done), (ref, jdone) = cap.read_batch(n), jcap.read_batch(n)
        assert done == jdone and np.array_equal(got, ref)
    for c in (cap, jcap):
        c.set_position(0.5)
    assert cap.get_position() == jcap.get_position()
    assert np.array_equal(cap.read_batch(2)[0], jcap.read_batch(2)[0])
    assert isinstance(capture.open_capture(frames), capture.ArrayCapture)
    # A path is a video file, decoded through cv2 (ImportError without it):
    # the same decoder as the reference's for one and for two workers.
    import cv2

    path = str(tmp_path / "game.mp4")
    vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 10, (16, 8))
    for f in frames:
        vw.write(np.repeat(np.repeat(f, 4, 1), 4, 0)[:8, :16])
    vw.release()
    for decoders in (1, 2):
        ours = capture.open_capture(path, (0.25, 0.75), decoders=decoders)
        ref = jcapture.open_capture(path, (0.25, 0.75), decoders=decoders)
        try:
            assert type(ours).__name__ == type(ref).__name__
            assert ours.frame_size == ref.frame_size == (4, 16)
            (got, done), (want, jdone) = ours.read_batch(16), \
                ref.read_batch(16)
            assert done == jdone and got.shape == (11, 4, 16, 3)
            assert np.array_equal(got, want)
        finally:
            ours.release()
            ref.release()
    monkeypatch.setitem(sys.modules, "cv2", None)
    for video in (path, 0):
        with pytest.raises(ImportError, match="cv2"):
            capture.open_capture(video)


def test_batch_stats_records_match_the_reference(tmp_path, monkeypatch):
    """The same records and JSONL lines on the same clock (each tick read
    once by either package's ``record``)."""
    clock = (100.0 + 0.25 * (i // 2) for i in itertools.count())
    monkeypatch.setattr(time, "perf_counter", lambda: next(clock))
    sink, jsink = str(tmp_path / "a.jsonl"), str(tmp_path / "b.jsonl")
    stats = profiling.BatchStats(sink, window_s=1.0)
    jstats = jprofiling.BatchStats(jsink, window_s=1.0)
    recs = []
    for i in range(8):
        fields = {"agitation": 0.01 * i, "status": "re-anchoring",
                  "bulk_fixes": i}
        recs.append((stats.record(16, **fields), jstats.record(16, **fields)))
    stats.close()
    jstats.close()
    assert all(a == b for a, b in recs)
    assert recs[-1][0]["fps"] > 0
    with open(sink) as a, open(jsink) as b:
        assert a.read() == b.read()


def test_posgrid_matches_the_reference():
    grid, jgrid = stonesfinder.PosGrid(), jstonesfinder.PosGrid()
    rng = np.random.default_rng(4)
    for _ in range(50):
        r, c = (int(v) for v in rng.integers(0, 19, 2))
        obs = rng.normal(grid.pos(r, c), 4.0)
        grid.learn(r, c, obs)
        jgrid.learn(r, c, obs)
        y, x = (float(v) for v in rng.random(2) * 304)
        assert grid.closest(y, x) == jgrid.closest(y, x)
    assert np.array_equal(grid.offsets, jgrid.offsets)
    assert grid.pos(3, 4) == jgrid.pos(3, 4)


class _FailingCapture(capture.ArrayCapture):
    """Fails on its third read, as a camera unplugged mid-stream."""

    def read_batch(self, n):
        if self.pos >= 2 * n:
            raise OSError("camera unplugged")
        return super().read_batch(n)


def test_feeders_match_the_reference_on_the_cpu():
    """``DeviceFeeder`` and ``prefetch_to_device`` on the CPU give the
    reference's batches, counts and last host frames, and relay a capture
    failure as an error, never as the end of the stream."""
    rng = np.random.default_rng(1)
    frames = list(rng.integers(0, 256, (21, 6, 5, 3), dtype=np.uint8))
    ours = feeder.DeviceFeeder(capture.ArrayCapture(frames), 8,
                               device="cpu")
    ref = jfeeder.DeviceFeeder(jcapture.ArrayCapture(frames), 8)
    got = [(b.numpy(), n, done, last, a) for b, n, done, last, a in ours]
    want = [(np.asarray(b), n, done, last, a)
            for b, n, done, last, a in ref]
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert np.array_equal(g[0], w[0]) and g[1:3] == w[1:3]
        assert np.array_equal(g[3], w[3])
        assert g[4] is None and w[4] is None
    batches = [capture.pad_batch(np.stack(frames[i:i + 8]), 8)
               for i in range(0, 21, 8)]
    got = [(b.numpy(), n) for b, n in
           feeder.prefetch_to_device(iter(batches), device="cpu")]
    want = [(np.asarray(b), n) for b, n in
            jfeeder.prefetch_to_device(iter(batches))]
    assert [n for _, n in got] == [n for _, n in want] == [8, 8, 5]
    assert all(np.array_equal(a, b) for (a, _), (b, _) in zip(got, want))
    failing = feeder.DeviceFeeder(_FailingCapture(frames), 8, device="cpu")
    with pytest.raises(RuntimeError, match="mid-stream") as err:
        list(failing)
    assert isinstance(err.value.__cause__, OSError)

    def broken():
        yield batches[0]
        raise OSError("decoder died")

    with pytest.raises(RuntimeError, match="mid-stream"):
        list(feeder.prefetch_to_device(broken(), device="cpu"))


def test_host_read_and_to_device_on_the_cpu():
    a = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    b = torch.tensor([True, False])
    got = feeder.host_read(a, b)
    assert np.array_equal(got[0], a.numpy()) and got[1].dtype == np.bool_
    t = feeder.to_device(np.ones((4, 2), np.float64), "cpu", torch.float32)
    assert t.dtype == torch.float32 and t.device.type == "cpu"
