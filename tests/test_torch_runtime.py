"""The vision runtime as a whole, the port against the JAX package on the
CPU: ``VManagerSeq`` with ``BoardFinderAuto`` and ``SfMeta`` over the same
360×640 game from a drifting camera (the recipe of
tests/test_tracking.py's runtime case, 6 moves, batches of 16), and the
port's threaded ``VManager`` against its sequential one.

Both sides skip the first anchor's lens calibration (``_lens_checked``):
the calibration is held to JAX by tests/test_torch_lens_detect.py, and
its JAX compile alone would double this file's time.
"""

import numpy as np
import pytest
import torch

from camkifu_tpu.board.bf_auto import BoardFinderAuto as JBoardFinderAuto
from camkifu_tpu.core.capture import ArrayCapture as JArrayCapture
from camkifu_tpu.core.controllerv import ControllerVSeq as JControllerVSeq
from camkifu_tpu.core.vmanager import VManagerSeq as JVManagerSeq
from camkifu_tpu.stone.sf_meta import SfMeta as JSfMeta
from camkifu_tpu_torch.board.bf_auto import BoardFinderAuto
from camkifu_tpu_torch.config import cvconf
from camkifu_tpu_torch.core.capture import ArrayCapture
from camkifu_tpu_torch.core.controllerv import ControllerV, ControllerVSeq
from camkifu_tpu_torch.core.gamesync import score_moves
from camkifu_tpu_torch.core.vmanager import VManager, VManagerSeq
from camkifu_tpu_torch.stone.sf_meta import SfMeta
from camkifu_tpu_torch.utils.still import (handheld_corners, render_game,
                                            sample_moves)

torch.set_num_threads(1)

HW = (360, 640)
BATCH = 16
#: Corners of the two packages after the same batches (chip_smoke's
#: card-against-CPU tolerance; the tracker's gates sit on knife edges).
TOL_CPU_PX = 0.5
#: Tracking sharpness is rounded to 2 decimals by the host: one rounding
#: step. The largest corner step of a batch is a difference of tracked
#: corners, which the two packages place up to 0.0785 px apart here (their
#: detections differ by 3e-4 px, and the tracker's gates turn such a
#: difference into ~0.1 px: ROADMAP Queue C); measured 0.04 px apart.
TOL_SHARPNESS = 0.01
TOL_STEP_PX = 0.1
SF_KEYS = ("status", "pose_agreement", "bulk_fixes")


@pytest.fixture(scope="module")
def game():
    """6 moves (seed 9), 10 frames a move after 6 empty ones, from a camera
    drifting (5, 4) px at 360×640 (the reference's (10, 8) at 720p)."""
    moves = sample_moves(6, seed=9)
    fpm = cvconf.vote_window + 3
    n = 6 + len(moves) * fpm
    frames, _ = render_game(
        moves, fpm, frame_hw=HW, seed=9, empty_leadin=6,
        corners=handheld_corners(n, HW, drift=(5.0, 4.0),
                                 periods=(8.0, 11.0)))
    return moves, list(frames)


def _session(vm_cls, ctrl_cls, cap_cls, bf_cls, sf_cls, frames, **kw):
    """A sequential runtime over ``frames`` that records, after each batch,
    both finders' metadata and the published per-frame corners."""
    controller = ctrl_cls()
    vm = vm_cls(controller, video=None, bf_class=bf_cls, sf_class=sf_cls,
                batch=BATCH, **kw)
    vm.capture = cap_cls(frames)
    vm.instantiate_finders()
    vm.board_finder._lens_checked = True
    records = []
    record = vm.stats.record

    def spy(n, **fields):
        cb = vm.board_finder.corners_batch
        records.append((dict(vm.board_finder.metadata), dict(fields),
                        None if cb is None else np.array(cb)))
        return record(n, **fields)

    vm.stats.record = spy
    vm.run()
    return controller, vm, records


def _moves(controller):
    return [(m.color, m.row, m.col) for m in controller.kifu.moves()]


def test_runtime_matches_the_reference(game):
    """The same kifu (the truth), the same per-batch records and the same
    final corners as the JAX package's runtime."""
    moves, frames = game
    jctrl, jvm, jrecs = _session(JVManagerSeq, JControllerVSeq,
                                 JArrayCapture, JBoardFinderAuto, JSfMeta,
                                 frames)
    ctrl, vm, recs = _session(VManagerSeq, ControllerVSeq, ArrayCapture,
                              BoardFinderAuto, SfMeta, frames, device="cpu")
    assert score_moves(ctrl.kifu.moves(), moves)["agreement"] == 1.0
    assert _moves(ctrl) == _moves(jctrl)
    assert len(recs) == len(jrecs) == -(-len(frames) // BATCH)
    for (bf, sf, cb), (jbf, jsf, jcb) in zip(recs, jrecs):
        assert bf.get("track_trip") == jbf.get("track_trip")
        assert abs(bf["track_sharpness"] - jbf["track_sharpness"]) \
            <= TOL_SHARPNESS + 1e-9
        assert abs(bf["track_step"] - jbf["track_step"]) <= TOL_STEP_PX
        for key in SF_KEYS:
            assert sf.get(key) == jsf.get(key), key
        assert (cb is None) == (jcb is None)
        if cb is not None:
            assert np.abs(cb - jcb).max() < TOL_CPU_PX
    final = vm.board_finder.corners_batch
    assert final.shape == (BATCH, 4, 2)
    assert np.abs(final - np.asarray(jvm.board_finder.corners_batch)).max() \
        < TOL_CPU_PX


def test_threaded_manager_matches_sequential(game):
    """The threaded VManager (its feeder on the CPU) reads the same kifu
    as VManagerSeq on the same frames."""
    moves, frames = game
    frames = frames[:6 + 3 * (cvconf.vote_window + 3)]     # 3 moves
    seq, _, _ = _session(VManagerSeq, ControllerVSeq, ArrayCapture,
                         BoardFinderAuto, SfMeta, frames, device="cpu")

    controller = ControllerV()
    errors = []
    controller.listeners.append(
        lambda event, *args: errors.append(args) if event == "error"
        else None)
    vm = VManager(controller, video=None, bf_class=BoardFinderAuto,
                  sf_class=SfMeta, batch=BATCH, device="cpu")
    vm.capture = ArrayCapture(frames)
    vm.init_capture = lambda: None           # keep the injected capture
    vm.instantiate_finders = _no_lens_check(vm.instantiate_finders, vm)
    vm.vision_on()
    vm._thread.join(timeout=300)
    assert not vm.is_running()
    vm.vision_off()
    controller.process_pipe()
    assert not errors, errors
    assert _moves(controller) == _moves(seq)
    assert len(_moves(seq)) == 3
    assert vm.last_frame is not None and vm.last_frame.shape == HW + (3,)


def _no_lens_check(instantiate, vm):
    def run():
        instantiate()
        vm.board_finder._lens_checked = True
    return run
