"""Live-mode end-to-end latency harness (port of camkifu_tpu/utils/latency.py).

    python -m camkifu_tpu_torch.utils.latency --hw 720x1280 --fps 10 --moves 4

Live mode's defining metric is frame-arrival → SGF-append latency: how long
after the stone physically appears on camera does the move land in the
kifu. This harness drives the REAL threaded runtime (LiveCapture ring →
DeviceFeeder → VManager worker → BoardFinderAuto/SfMeta → ControllerV pipe
→ Kifu.append) with a paced mock camera whose per-frame emission times are
known, and attributes each appended move to the first frame that showed
its stone.

The measured latency decomposes structurally as

    wait-for-batch  (ring fill: ≤ batch/fps, bounded by LiveCapture
                     max_wait_s — the partial-batch dispatch knob)
  + vote commit     (a stone must persist ≈ vote_window readings before the
                     extractor emits it: ~vote_window/fps of wall time)
  + pipeline        (device compute + pipe drain)

so the harness reports the per-stage floors next to the measured p50/p99.

The game is rendered on ``device`` (``utils.synth``) and copied to the
host once, before pacing starts: a camera delivers host memory.
"""

from __future__ import annotations

import time

import numpy as np
import torch


class PacedCamera:
    """cv2.VideoCapture stand-in that releases pre-rendered frames at a
    fixed fps (wall-clock paced). ``emit_times[i]`` records when frame i
    was handed to the grabber — the harness's ground-truth arrival time."""

    def __init__(self, frames_rgb, fps: float):
        self._frames = frames_rgb
        self._period = 1.0 / fps
        self._idx = 0
        self._t0 = None
        self.emit_times: list[float] = []
        self.opened = True

    def isOpened(self):
        return self.opened

    def read(self):
        if self._idx >= len(self._frames):
            time.sleep(self._period)
            return False, None
        if self._t0 is None:
            self._t0 = time.perf_counter()
        due = self._t0 + self._idx * self._period
        delay = due - time.perf_counter()
        if delay > 0:
            time.sleep(delay)
        f = self._frames[self._idx]
        self._idx += 1
        self.emit_times.append(time.perf_counter())
        return True, f[:, :, ::-1]          # the grabber expects BGR

    def release(self):
        self.opened = False


def _host_game(moves, fpm: int, frame_hw, seed: int, gsize: int,
               leadin: int, device) -> list[np.ndarray]:
    """A synth game rendered on ``device``, then copied to the host in one
    copy: a list of (H, W, 3) uint8 arrays."""
    from camkifu_tpu_torch.utils import synth

    frames = torch.stack([f for f, _ in synth.render_game(
        moves, frames_per_move=fpm, frame_hw=frame_hw, seed=seed,
        gsize=gsize, empty_leadin=leadin, device=device)])
    return list(frames.cpu().numpy())


def measure_live_latency(n_moves: int = 4, fps: float = 4.0,
                         frame_hw=(360, 640), batch: int = 8,
                         max_wait_s: float = 2.0, gsize: int = 19,
                         seed: int = 3, frames_per_move: int | None = None,
                         timeout_s: float = 300.0,
                         warmup: bool = True, device="cuda") -> dict:
    """Render a synth game, play it through a paced camera into the full
    threaded runtime on ``device`` (the card unless the caller asks for
    the CPU), and measure frame-arrival → SGF-append latency.

    Returns a dict with per-move latencies (s), p50/p99, the number of
    moves detected/expected, and the structural floors (batch fill, vote
    commit) for the chosen fps/batch.

    ``warmup`` first runs a short throwaway game of the SAME shapes through
    the synchronous runtime in-process, so the live run measures steady
    state: on the card it pays for the kernel build and cuDNN's first
    calls. A real deployment warms once at startup the same way.
    """
    from camkifu_tpu_torch.board.bf_auto import BoardFinderAuto
    from camkifu_tpu_torch.config import cvconf
    from camkifu_tpu_torch.core.capture import LiveCapture
    from camkifu_tpu_torch.core.controllerv import ControllerV
    from camkifu_tpu_torch.core.vmanager import VManager, VManagerSeq
    from camkifu_tpu_torch.stone.sf_meta import SfMeta
    from camkifu_tpu_torch.utils import synth

    device = torch.device(device)
    fpm = frames_per_move or (cvconf.vote_window + 6)
    warmup_s = 0.0
    if warmup:
        t0 = time.perf_counter()
        wmoves = synth.sample_moves(2, gsize=gsize, seed=seed + 1)
        wframes = _host_game(wmoves, fpm, frame_hw, seed + 1, gsize, 4,
                             device)
        wctl = ControllerV(gsize=gsize)
        wvm = VManagerSeq(wctl, video=wframes, bf_class=BoardFinderAuto,
                          sf_class=SfMeta, batch=batch, device=device)
        wvm.run()
        wctl.process_pipe()
        warmup_s = time.perf_counter() - t0
    moves = synth.sample_moves(n_moves, gsize=gsize, seed=seed)
    leadin = 4
    frames = _host_game(moves, fpm, frame_hw, seed, gsize, leadin, device)
    # Move k's stone is first visible at this global frame index.
    first_idx = {(m.color, m.row, m.col): leadin + k * fpm
                 for k, m in enumerate(moves)}

    cam = PacedCamera(frames, fps)
    capture = LiveCapture(0, camera=cam, ring=max(batch * 4, 64),
                          max_wait_s=max_wait_s)
    controller = ControllerV(gsize=gsize)
    vm = VManager(controller, video=None, bf_class=BoardFinderAuto,
                  sf_class=SfMeta, batch=batch, device=device)
    vm.capture = capture
    vm.init_capture = lambda: None          # keep the injected capture

    append_times: dict[tuple, float] = {}
    orig_append = controller.api["append"]

    def timed_append(move, *a, **k):
        out = orig_append(move, *a, **k)
        append_times[(move.color, move.row, move.col)] = time.perf_counter()
        return out

    controller.api["append"] = timed_append

    vm.vision_on()
    deadline = time.time() + timeout_s
    try:
        while time.time() < deadline and len(append_times) < n_moves \
                and vm.is_running():
            controller.process_pipe()
            time.sleep(0.01)
    finally:
        vm.vision_off()
        controller.process_pipe()
        capture.release()

    lat = sorted(append_times[k] - cam.emit_times[first_idx[k]]
                 for k in append_times if k in first_idx
                 and first_idx[k] < len(cam.emit_times))
    rep = {
        "detected": len(append_times),
        "expected": n_moves,
        "fps_camera": fps,
        "batch": batch,
        "max_wait_s": max_wait_s,
        "latencies_s": [round(v, 3) for v in lat],
        "floor_batch_fill_s": round(min(batch / fps, max_wait_s), 3),
        "floor_vote_commit_s": round(cvconf.vote_window / fps, 3),
        "warmup_s": round(warmup_s, 1),
    }
    if lat:
        rep["p50_s"] = round(float(np.percentile(lat, 50)), 3)
        rep["p99_s"] = round(float(np.percentile(lat, 99)), 3)
        rep["mean_s"] = round(float(np.mean(lat)), 3)
    return rep


def main(argv=None) -> int:
    import argparse
    import json

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--fps", type=float, default=4.0)
    ap.add_argument("--moves", type=int, default=4)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--max-wait-s", type=float, default=2.0)
    ap.add_argument("--hw", type=str, default="360x640")
    ap.add_argument("--no-warmup", action="store_true",
                    help="skip the in-process steady-state warmup pass")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    h, w = (int(v) for v in args.hw.split("x"))
    rep = measure_live_latency(n_moves=args.moves, fps=args.fps,
                               frame_hw=(h, w), batch=args.batch,
                               max_wait_s=args.max_wait_s,
                               warmup=not args.no_warmup,
                               device=args.device)
    print(json.dumps(rep, indent=2))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
