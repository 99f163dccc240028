#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``camkifu_tpu_torch/csrc`` (nvcc,
sm_90a, one process per source), holds each kernel against its plain
PyTorch version at the shapes the paths give it, then drives its paths
once each, counting kernel launches per path:

- the still path: one board detection on a 1080p still
  (``board.bf_auto.detect_corners``) and stone classification of 128
  copies of it (``pipeline.read_board_batch``);
- the recorded-video path: a seeded 10-move game from a fixed camera at
  720p through ``filecheck.run_pipeline`` with automatic board detection
  (``detect_batch_stable``, then the ``sf_meta`` vote scan) to its moves;
- the full redetect: ``detect_batch`` on 64 drifting 1080p frames;
- the handheld path: a seeded 10-move game from a drifting 720p camera,
  one ``detect_corners`` and then ``sf_meta.track_read_batch`` in batches
  of 16 (per-frame tracking, rectification, classification, vote scan) to
  its moves, with every synchronizing call an error from the second batch
  on; then the same engine once at full width, 128 × 1080p;
- board sizes 9 and 13: detection, 128 copies read and one tracked chunk
  of a 1080p still at each, and ``infer_gsize`` on 9, 13 and 19 boards;
- several streams (``parallel.mesh``): the film and handheld games seen by
  four cameras through ``multistream_read_meta`` and
  ``multistream_track_read``, each stream held to its single-stream call;
- c5: 8 streams × 16 1080p frames, each its own board, through
  ``parallel.mesh._read_all_streams``, then the same frames through
  ``multistream_track_read``;
- the radial lens: k1 calibrated on 1080p boards through a lens
  (``bf_auto.estimate_lens_k1`` by detection, ``estimate_lens_k1_corners``
  from known corners), then a seeded 10-move handheld game at 720p
  through a k1 = 0.06 lens, calibrated on its first frame and read with
  ``sf_meta.track_read_batch(lens=...)``, and four cameras with four
  lenses through ``multistream_track_read(lenses=...)``;
- the vision runtime (``filecheck.run_runtime``: ``VManagerSeq`` with
  ``BoardFinderAuto`` and ``SfMeta``): the handheld game to its kifu, a
  camera bump, the pose veto of a resumed 200-move game, the lens game
  calibrated at its first anchor, the threaded ``VManager`` with its
  CUDA-stream frame feeder, the first batches through ``device="cpu"``,
  and the host waits of its batches;
- the remaining finders and the trainer (``models.neural``): 48 720p
  boards harvested and a ``PatchNet`` trained at ``cktrain``'s defaults,
  ``classify_batch_neural`` on 128 1080p frames, ``sf_meta.read_batch``
  with the trained net as its third voter and ``sf_bgsub.read_batch`` over
  the recorded game, bgsub's capture scenario, and the runtime with
  ``SfBgSub``, ``SfNeural`` and ``SfMeta`` loading the trained checkpoint;
- the renderer, the accuracy harness and the live path:
  ``utils.synth.render_frame`` at 720p and 1080p with each group of options
  on the card against the CPU, ``render_game``'s frames/s;
  ``filecheck.check`` on four ``synth:`` specs at the reference's PASS bar;
  the gauntlet scenario rendered without its mp4 round trip through
  ``run_runtime`` to its exact kifu; ``utils.latency.measure_live_latency``
  (a paced camera into ``LiveCapture`` and the threaded ``VManager``).

It checks corners, labels and moves against the renderer's ground truth
and against the plain CPU path, checks that every kernel launched on each
path, and prints the times it measured. Every phase prints one line; any
failure exits non-zero.

The last line of standard output is the result,
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``;
the line before it lists the kernels as JSON. Without a CUDA device the
script exits with code 1 and prints no result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

#: Frames per classification batch on the main path (bench.py's c2).
BATCH = 128
FRAME_HW = (1080, 1920)
#: Corner tolerance against ground truth: tests/test_bf_auto.py's 11 px at
#: 720p, scaled to 1080p.
TOL_PX = 16.0
#: Corner agreement between the card and the plain CPU path.
TOL_CPU_PX = 0.5
HOUGH_ATOL = 1e-2          # fixed-point votes, summed in another order
#: Device spin before each kernel timing, ~50 ms at the H100's clock:
#: longer than the host takes to fill the launch queue.
SPIN_CYCLES = 100_000_000

#: The H100 SXM's published peaks (NVIDIA's data sheet, 700 W): HBM3
#: bytes per second and float32 operations per second outside the tensor
#: cores. A kernel's bound is the larger of its bytes (each input byte the
#: work needs read once, each output byte written once) and its floating
#: operations over these.
PEAK_BYTES_S = 3.35e12
PEAK_FP32_S = 67e12
#: Floating operations, counted from the kernels' sources: the warp's
#: source coordinates per output pixel (6 mul, 6 add, 2 div, 2 fraction
#: subtractions) and its blend per value (6 mul, 3 add, 2 sub); the edge
#: map per pixel (9-tap blur twice, 34; Sobel, 11; magnitude and sqrt, 4;
#: sector and NMS compares, 6); the Hough vote per (point, θ) pair with a
#: non-zero weight (ρ 3, bin position 2, floor and fraction 2, 1 − frac 1,
#: two weighted taps 2, two adds 2); the hysteresis per pixel (two
#: threshold compares and the last select; its dilations are bit operations).
WARP_OPS_PX = 16
WARP_OPS_VALUE = 11
EDGE_OPS_PX = 55
HOUGH_OPS_PAIR = 12
HYSTERESIS_OPS_PX = 3
#: Dilation steps of the paths' hysteresis (``edge_map_batch``'s default)
#: and the fractions of each map's strided 99.5th percentile it thresholds
#: at.
HYSTERESIS_ITERS = 4
LOW_FRAC, HIGH_FRAC = 0.15, 0.4
#: Calls per kernel time: the kernel, its plain version, the library call.
KERNEL_REPS = 20
PLAIN_REPS = 3
LIBRARY_REPS = 5
#: Split counts the Hough kernel is also timed at, beside the one its
#: wrapper picks (``hough_kernel.auto_splits``).
HOUGH_SPLITS = (1, 2, 4, 8, 16, 32)
#: Segment lengths (output rows a warp walks) the edge kernel is also timed
#: at with each strip width, beside the pair its wrapper picks
#: (``edge_kernel.auto_plan``).
EDGE_ROWS = (1, 2, 4, 8, 16, 32, 64, 256)

#: The recorded game: moves, empty lead-in frames, frames per move (the
#: vote window + 2, as tests/test_sf_meta.py records), and the film batch.
FILM_HW = (720, 1280)
FILM_MOVES = 10
FILM_LEADIN = 6
FILM_BATCH = 32
#: tests/test_bf_auto.py's corner tolerance at 720p.
FILM_TOL_PX = 11.0
#: bench.py's c3 batch (128 frames through sf_meta.read_batch) and its
#: full-redetect batch (64 frames through detect_batch).
C3_BATCH = 128
REDETECT_BATCH = 64
REDETECT_RENDERS = 8
REDETECT_DRIFT = 3.0
#: Frames that detect_batch_stable detects on the film path (8 of the
#: first batch): the edge kernel's N = 16 and the Hough kernel's B = 8.
FILM_DETECT_FRAMES = 8
#: The handheld game: tests/test_tracking.py's (10 moves, vote window + 3
#: frames a move, a camera drifting by (12 sin(t/7), 9 cos(t/9)) px at
#: 720p) in batches of 16, each one chunk; tracked corners must stay within
#: 0.15 cell of the truth. Frames of it that also go through the CPU.
HANDHELD_HW = (720, 1280)
HANDHELD_MOVES = 10
HANDHELD_BATCH = 16
HANDHELD_TOL_CELLS = 0.15
HANDHELD_CPU_FRAMES = 32
HANDHELD_RENDER_THREADS = 8
#: bench.py's c4: 128 × 1080p through track_read_batch, 16 frames a chunk;
#: the unfused pair tracks on 8-frame chunks (track_corners_batch's and
#: warp_batch_chunked's default).
C4_BATCH = 128
C4_CHUNK = 16
UNFUSED_CHUNK = 8
#: Board sizes off 19 (tests/test_board_sizes.py's gates): one 1080p still
#: each (g stones, seed g), detected, read 128 at a time as c2 reads 19,
#: tracked for one chunk, and its size inferred beside a 19 board's.
SIZES = (9, 13)
SIZE_TOL_CELLS = 0.2
INFER_MARGIN = 1.1
#: bench.py's c5: 8 streams of 16 1080p frames through
#: parallel.mesh._read_all_streams. Every stream is its own board: 4
#: renders, each seen by 2 cameras an integer translation apart (80 px, 1.6
#: cells: a stream read through another's corners misreads).
C5_STREAMS = 8
C5_PER_STREAM = 16
C5_RENDERS = 4
C5_SHIFTS = ((-40, -30), (40, 30))
#: The multi-stream games: the film's and the handheld game's 720p frames
#: seen by 4 cameras at integer translations (px), in batches of 16.
MS_SHIFTS = ((0, 0), (12, -8), (-10, 6), (6, 10))
MS_BATCH = 16
#: The lens (``camkifu_tpu_torch/ops/lens.py``): the boards the
#: calibrators are held on at 1080p (tests/test_lens_e2e.py's board: 60
#: stones, seed 13) and their tolerances on k1 (that file's); the lens game
#: (the handheld game through k1 = 0.06); the four cameras of the
#: multi-stream lens game and the frames each films. Grid lines are drawn
#: 0.045 cell wide (a goban's 1 mm on 22 mm): the line-scale evidence both
#: calibrators maximize reads bold 0.08-cell lines as two edges and picks a
#: phantom k1 of ±0.015 on a pinhole board.
LENS_DETECT_K1 = (0.06, -0.05)
LENS_DETECT_TOL = 0.010
LENS_CORNERS_K1 = (0.08, -0.06)
LENS_CORNERS_TOL = 0.004
LENS_LINE_WIDTH = 0.045
LENS_GAME_K1 = 0.06
LENS_MS_K1 = (0.0, 0.03, 0.06, -0.04)
LENS_MS_FRAMES = 32
#: A lens stream's tracked corners against its single-stream call, px.
#: The tracker's accept/reject gates sit on knife edges in these games: on
#: the CPU, a one-ulp change of the seed moves a stream's tracked corners
#: by 0.09–0.13 px in three of eight (k1, line width) streams, and on the
#: card a stream rounds by the batch's size (MS_STREAM_TOL_PX). A stream
#: read through another stream's lens or camera is off by ≥ 10 px; the
#: card and the CPU are held to this tolerance too.
LENS_MS_STREAM_TOL_PX = TOL_CPU_PX
#: The warp's lens mode per output pixel, counted from warp.cu: the
#: normalization (2 sub, 2 div), the radial factor (3 mul, 2 add) and the
#: bend back (4 mul, 2 add).
LENS_OPS_PX = 15
#: A stream's tracked corners against its single-stream call, px. On the
#: CPU the two are bitwise equal; on the card reductions and batched solves
#: round by the batch's size, which the tracker's seed hand-off carries
#: from batch to batch (about 1e-3 px after 7 batches at 720p). A stream
#: read through another's camera is off by the shifts above, ≥ 10 px.
MS_STREAM_TOL_PX = 1e-2

#: The vision runtime (``filecheck.run_runtime``: ``VManagerSeq`` with
#: ``BoardFinderAuto`` and ``SfMeta``) at 720p, the size of the reference's
#: runtime tests, in batches of 16: the handheld game; the camera bump of
#: tests/test_tracking.py (6 moves, seed 17, a 2.5° turn and a (34, −22) px
#: shift mid-game); the pose veto of tests/test_pose_veto.py (a 200-move
#: game resumed from its SGF, 48 frames through a camera turned 17°, then
#: the same game unturned with one more move); the lens game. Calls timed
#: for each frames/s.
RUNTIME_BATCH = 16
BUMP_MOVES = 6
BUMP_SEED = 17
BUMP_TURN_DEG = 2.5
BUMP_SHIFT = (34.0, -22.0)
VETO_MOVES = 200
VETO_SEED = 9
VETO_TURN_DEG = 17.0
VETO_FRAMES = 48
RUNTIME_REPS = 3
#: Steady tracked batches whose device ops and host waits are counted.
RUNTIME_STEADY_PROFILED = 3

#: The trainer at ``cktrain``'s defaults: 48 boards harvested at 720p
#: (17,328 patches), 6 epochs of clip(17,328 // 12, 256, 2048) = 1,444,
#: accuracy above tests/test_neural.py's bar, also on 8 boards of another
#: seed; the steps timed after the first 12.
TRAIN_BOARDS = 48
TRAIN_HW = (720, 1280)
TRAIN_EPOCHS = 6
TRAIN_HELD_OUT = 8
TRAIN_ACC = 0.97
TRAIN_TIMED_FROM = 12
#: The classifier at c2's shape (a board of its own seed): every board at
#: least this agreement with its labels; card against CPU where the CPU's
#: top-2 softmax margin exceeds NEURAL_MARGIN. The per-frame-corner branch
#: on 16 720p frames of that board from a camera drifting NEURAL_DRIFT px,
#: which keeps each frame within a pixel of its chunk's median corners:
#: ``warp_batch_chunked`` shifts by at most +1 / −2 px and fades a frame
#: further off (the reference's too). The handheld game's frames from
#: NEURAL_HANDHELD_FROM on, up to 5.9 px off, are read and printed.
NEURAL_AGREE = 0.97
NEURAL_MARGIN = 0.02
NEURAL_DRIFT = (1.0, 0.75)
NEURAL_HANDHELD_FROM = 60
#: The capture-and-removal scenario of tests/test_sf_bgsub.py, at its size.
BGSUB_CAPTURE_HW = (360, 640)
BGSUB_CAPTURE_BATCH = 13

#: The renderer on the card against the CPU, sensor noise off (the shot
#: noise is a draw too, so no group has it): each group of options at each
#: size, corners bitwise, frames within a mean of
#: SYNTH_TOL_MEAN DN with at most SYNTH_TOL_FRAC of the values more than
#: 2 DN apart (float rounding in blurs and remaps; a shape's rim pixel).
SYNTH_HWS = ((720, 1280), (1080, 1920))
SYNTH_HARD = dict(stone_jitter=0.07, light_gradient=0.3, blur_sigma=1.2,
                  shadow=0.18)
SYNTH_GROUPS = {
    "none": {},
    "hard": SYNTH_HARD,
    "t3 + clutter": dict(SYNTH_HARD, glare=0.5, clutter=3,
                         wood_texture=0.10, vignette=0.22),
    "lens + rolling shutter": dict(lens_k1=0.06, rolling_shutter=(4.0, 3.0)),
    "hand": dict(hand=(640.0, 360.0, 0.8)),
    "walnut": dict(palette="walnut"),
}
SYNTH_TOL_MEAN = 0.05
SYNTH_TOL_FRAC = 1e-4
#: render_game's frames/s: a 10-move game at 720p, 10 frames a move.
SYNTH_GAME_MOVES = 10
#: filecheck.check's specs (reference SGF None: the true corners; "auto":
#: detection), each at the reference's PASS bar.
CHECK_SPECS = (("synth:40:hard", None), ("synth:24:caps", "auto"),
               ("synth:20:flicker", "auto"), ("synth:20:t3:bamboo", None))
CHECK_BAR = 0.99
#: The gauntlet without its mp4 round trip is read, by the reference's
#: runtime as by the port's, with moves 9 and 11 of its kifu swapped
#: (0-based 8 and 10: B (3, 3) committed after B (2, 4)): in both, a
#: phantom W (6, 4) committed under the arm resting after move 7 holds
#: W (16, 2) and B (3, 3) back until B (2, 4) is read too, and the two
#: black stones then commit in row-major order. With the round trip B (2,
#: 4) is read later and both read the exact kifu.
#: tools/gauntlet_reference.py reproduces this on the CPU (--trace shows
#: the commits). The gate is relaxed from the exact kifu to the
#: reference's own codec-free reading: a port that read the exact kifu
#: here would differ from the reference.
GAUNTLET_REFERENCE_SWAP = (8, 10)
#: The live harness: a paced 720p camera, batches of 8.
LIVE_HW = (720, 1280)
LIVE_FPS = 10.0
LIVE_BATCH = 8
LIVE_MOVES = 4


class SmokeFailure(RuntimeError):
    pass


def _require(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def _card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def _cuda_ms(fn, reps: int, spin: bool = True, warmup: int = 2) -> float:
    """Mean milliseconds per call between CUDA events, after a warm-up.

    With ``spin``, a device-side spin queued ahead of the start event lets
    the host enqueue the calls before the card reaches them, so a call
    shorter than its own launch overhead is timed by the device. Without
    it, the calls run as the host issues them, as on the main path."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if spin:
        torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _cuda_ms_runs(fn, reps: int, warmup: int = 2) -> list[float]:
    """Milliseconds of each of ``reps`` calls between CUDA events, sorted:
    host-bound paths vary from call to call, so end-to-end times report
    their median and range."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    for start, end in events:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return sorted(s.elapsed_time(e) for s, e in events)


def _median(xs: list[float]) -> float:
    n = len(xs)
    return (xs[(n - 1) // 2] + xs[n // 2]) / 2


def _bound(nbytes: float, ops: float) -> tuple[float, str]:
    """(least milliseconds the card could take, what bounds it)."""
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = ops / PEAK_FP32_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def bound_warp(frames, out_hw: tuple[int, int],
               lens: bool = False) -> tuple[float, str]:
    """float32 output written once, and four C-byte taps an output pixel
    (no more than the frames hold); in lens mode the bend's operations
    too (its parameters are 20 bytes a frame at most)."""
    b, _, _, c = frames.shape
    px = b * out_hw[0] * out_hw[1]
    taps = min(4 * c * px, frames.numel() * frames.element_size())
    ops = WARP_OPS_PX + c * WARP_OPS_VALUE + (LENS_OPS_PX if lens else 0)
    return _bound(4 * c * px + taps + (20 * b if lens else 0), px * ops)


def bound_edge(x) -> tuple[float, str]:
    """float32 maps read once and written once."""
    return _bound(8 * x.numel(), EDGE_OPS_PX * x.numel())


def bound_hough(pts, wts, n_theta: int = 128,
                n_rho: int = 256) -> tuple[float, str]:
    """The points and weights read once and the votes written once; the
    operations of this run's points with a non-zero weight."""
    frames = wts.numel() // wts.shape[-1]
    nbytes = 12 * wts.numel() + 4 * frames * n_theta * n_rho
    return _bound(nbytes, HOUGH_OPS_PAIR * n_theta * int((wts != 0).sum()))


def bound_hysteresis(x) -> tuple[float, str]:
    """float32 maps read once and written once, and a pair of thresholds a
    map."""
    return _bound(8 * x.numel() + 8 * x.shape[0],
                  HYSTERESIS_OPS_PX * x.numel())


def warp_sector_bytes(frames, H, out_hw: tuple[int, int]) -> int:
    """Bytes of the distinct 32-byte sectors that the taps of a warp
    through one homography ``H`` touch, summed over the frames, plus its
    float32 output: the least device-memory traffic of the warp when the
    card moves whole sectors."""
    import torch

    b, h, w, c = frames.shape
    oh, ow = out_hw
    dev = frames.device
    v = torch.arange(oh, dtype=torch.float32, device=dev)[:, None]
    u = torch.arange(ow, dtype=torch.float32, device=dev)[None, :]
    den = H[2, 0] * u + H[2, 1] * v + H[2, 2]
    x = ((H[0, 0] * u + H[0, 1] * v + H[0, 2]) / den).clamp(0, w - 1)
    y = ((H[1, 0] * u + H[1, 1] * v + H[1, 2]) / den).clamp(0, h - 1)
    x0, y0 = x.floor().long(), y.floor().long()
    xs = torch.stack([x0, (x0 + 1).clamp(max=w - 1)])
    ys = torch.stack([y0, (y0 + 1).clamp(max=h - 1)])
    start = (ys[:, None] * w + xs[None]) * c
    sectors = torch.cat([(start // 32).flatten(),
                         ((start + c - 1) // 32).flatten()]).unique()
    return b * (sectors.numel() * 32 + 4 * c * oh * ow)


def hough_at_splits(pts, wts, rho_max: float, splits: int):
    """The Hough kernel's C entry point with ``splits`` blocks on each
    frame's points, 128 × 256 bins; returns the call. Launched here, not
    through the wrapper, so it counts no launch."""
    import torch

    from camkifu_tpu_torch.ops.cuda import _build, hough_kernel

    pts = pts.reshape(-1, *pts.shape[-2:])
    b, k = pts.shape[0], pts.shape[1]
    out = torch.empty((b, 128, 256), dtype=torch.float32, device=pts.device)
    partial = torch.empty((splits, *out.shape), dtype=torch.float32,
                          device=pts.device)
    trig = hough_kernel._trig_on(128, pts.device)
    rho_scale, pos_hi = hough_kernel._bins(256, rho_max)
    lib = _build.lib()
    stream = _build.stream_handle(pts.device)
    return lambda: _build.check(lib.camkifu_hough(
        pts.data_ptr(), wts.data_ptr(), trig.data_ptr(), out.data_ptr(),
        partial.data_ptr(), b, k, 128, 256, splits, rho_max, rho_scale,
        pos_hi, stream), "hough")


def edge_at(x, cols: int, rows: int):
    """The edge kernel's C entry point on maps ``x`` (N, H, W) with strips
    of ``cols`` columns a lane and ``rows`` output rows a segment; returns
    the call. Launched here, not through the wrapper, so it counts no
    launch."""
    import torch

    from camkifu_tpu_torch.ops.cuda import _build, edge_kernel

    n, h, w = x.shape
    out = torch.empty_like(x)
    lib, taps = edge_kernel._ready(1.4)
    stream = _build.stream_handle(x.device)
    return lambda: _build.check(lib.camkifu_edge(
        x.data_ptr(), out.data_ptr(), n, h, w, edge_kernel.BORDER, cols, rows,
        taps, stream), "edge")


def grid_sample_case(frames, H, out_hw: tuple[int, int], scale: float,
                     lens=None):
    """The library yardstick of the warp: ``F.grid_sample`` (bilinear,
    border padding, align_corners) on the frames as float32 NCHW, through
    a normalised grid built from ``H`` ((3, 3), or (B, 3, 3) a frame each)
    and bent through ``lens`` (five numbers, or a (B, 5) table) beforehand;
    returns the call. The float copy and the grid are made here, outside
    any timed window."""
    import torch
    import torch.nn.functional as F

    from camkifu_tpu_torch.ops.lens import Lens, distort_pts

    b, h, w, _ = frames.shape
    oh, ow = out_hw
    dev = frames.device
    v = torch.arange(oh, dtype=torch.float32, device=dev)[:, None]
    u = torch.arange(ow, dtype=torch.float32, device=dev)[None, :]
    Hb = (H if H.ndim == 3 else H[None])[:, :, :, None, None]
    den = Hb[:, 2, 0] * u + Hb[:, 2, 1] * v + Hb[:, 2, 2]
    x = (Hb[:, 0, 0] * u + Hb[:, 0, 1] * v + Hb[:, 0, 2]) / den
    y = (Hb[:, 1, 0] * u + Hb[:, 1, 1] * v + Hb[:, 1, 2]) / den
    if lens is not None:
        table = lens if isinstance(lens, torch.Tensor) else torch.tensor(
            [float(f) for f in lens], device=dev)
        src = distort_pts(Lens(*table.unbind(-1)), torch.stack([x, y], -1))
        x, y = src[..., 0], src[..., 1]
    grid = torch.stack([x / (w - 1) * 2 - 1, y / (h - 1) * 2 - 1], dim=-1)
    grid = grid.expand(b, oh, ow, 2).contiguous()
    xf = frames.permute(0, 3, 1, 2).float().contiguous()
    return lambda: F.grid_sample(xf, grid, mode="bilinear",
                                 padding_mode="border",
                                 align_corners=True) * scale


def _labels() -> "np.ndarray":
    """bench.py's c2 board: 100 stones, seed 0."""
    import numpy as np

    labels = np.zeros((19, 19), np.int8)
    idx = np.random.default_rng(0).choice(361, 100, replace=False)
    labels.flat[idx[:50]] = 1
    labels.flat[idx[50:]] = 2
    return labels


def _kernel_modules() -> dict:
    from camkifu_tpu_torch.ops.cuda import edge_kernel, hough_kernel, \
        hysteresis_kernel, warp_kernel

    return {"warp": warp_kernel, "edge": edge_kernel, "hough": hough_kernel,
            "hysteresis": hysteresis_kernel}


def _reset_counts() -> None:
    for m in _kernel_modules().values():
        m.launches = 0
        if hasattr(m, "sizes"):
            m.sizes.clear()
        if hasattr(m, "lens_launches"):
            m.lens_launches = 0


def _read_counts() -> dict:
    """{kernel: (launches, {batch size: launches})} since the reset."""
    return {k: (m.launches, dict(getattr(m, "sizes", {})))
            for k, m in _kernel_modules().items()}


def _require_launched(counts: dict, path: str) -> None:
    for name, (n, _) in counts.items():
        _require(n > 0, f"the {name} kernel did not run on the {path} path")
    _require(counts["hysteresis"] == counts["edge"],
             f"the hysteresis kernel did not follow every edge launch on the "
             f"{path} path")


def phase_build(_build) -> None:
    t0 = time.perf_counter()
    path, compile_s, log = _build.build()
    _build.lib()
    print(f"build: {path.name} compiled in {compile_s:.2f} s "
          f"(ready in {time.perf_counter() - t0:.2f} s)", flush=True)
    for line in log.splitlines():
        if any(key in line for key in ("registers", "spill", "Compiling")):
            print(f"  ptxas: {line.strip()}", flush=True)


def _check_warp(frames, H, out_hw: tuple[int, int], label: str,
                lens=None, scale: float = 1.0 / 255.0) -> float:
    """The warp kernel against its plain version on u8 ``frames``
    (B, H, W, C) through one homography (or one a frame), bent through
    ``lens`` if given, in ``scale``: bitwise equal. Returns the largest
    difference."""
    import torch

    from camkifu_tpu_torch.ops.cuda import warp_kernel

    H = H.contiguous()
    extra = () if lens is None else (lens,)
    a = warp_kernel.warp_homography(frames, H, out_hw, scale, *extra)
    b = warp_kernel.warp_homography_ref(frames, H, out_hw, scale, *extra)
    torch.cuda.synchronize()
    err = float((a - b).abs().max())
    same = torch.equal(a, b)
    print(f"kernel warp{label}: {tuple(frames.shape)} → {out_hw}, "
          f"max|kernel - plain| = {err:.3g}, "
          f"{'bitwise equal' if same else 'NOT bitwise equal'}", flush=True)
    _require(same, f"warp kernel{label} is not bitwise equal to its plain "
             f"version")
    return err


def _check_edge(x, label: str) -> float:
    """The edge kernel against its plain version on maps ``x`` (N, H, W):
    bitwise equal in the interior, a zero border band. Returns the largest
    difference."""
    import torch

    from camkifu_tpu_torch.ops.cuda import edge_kernel
    from camkifu_tpu_torch.ops.cuda.edge_kernel import BORDER

    a = edge_kernel.edge_magnitude(x)
    b = edge_kernel.edge_magnitude_ref(x)
    torch.cuda.synchronize()
    inner = (slice(None), slice(BORDER, -BORDER), slice(BORDER, -BORDER))
    same = torch.equal(a[inner], b[inner])
    err = float((a[inner] - b[inner]).abs().max())
    differ = int((a[inner] != b[inner]).sum())
    band = a.clone()
    band[inner] = 0
    print(f"kernel edge{label}: max|kernel - plain| = {err:.3g} in the "
          f"interior, {differ} of {a[inner].numel()} pixels differ, "
          f"{'bitwise equal' if same else 'NOT bitwise equal'}, "
          f"{int((a[inner] > 0).sum())} edge pixels, band max "
          f"{float(band.abs().max())}", flush=True)
    _require(same, f"edge kernel{label} is not bitwise equal to its plain "
             f"version in the interior")
    _require(float(band.abs().max()) == 0.0,
             f"edge kernel{label} band is not 0")
    return err


def _thresholds(mags):
    """The paths' per-map thresholds, as ``edge_map_batch`` makes them:
    (N, 1, 1) fractions of each map's strided 99.5th percentile."""
    from camkifu_tpu_torch.ops.edges import percentile

    n = mags.shape[0]
    ref = percentile(mags[:, ::2, ::2].reshape(n, -1), 99.5, dim=1)
    ref = ref[:, None, None]
    return LOW_FRAC * ref, HIGH_FRAC * ref


def _check_hysteresis(mags, low, high, label: str) -> float:
    """The hysteresis kernel against its plain version on maps ``mags``
    (N, H, W): ``torch.equal``. Returns the largest difference."""
    import torch

    from camkifu_tpu_torch.ops.cuda import hysteresis_kernel

    a = hysteresis_kernel.hysteresis(mags, low, high, HYSTERESIS_ITERS)
    b = hysteresis_kernel.hysteresis_ref(mags, low, high, HYSTERESIS_ITERS)
    torch.cuda.synchronize()
    same = torch.equal(a, b)
    err = float((a - b).abs().max())
    strong = int((mags >= high).sum())
    print(f"kernel hysteresis{label}: {tuple(mags.shape)}, "
          f"{'bitwise equal' if same else 'NOT bitwise equal'}, "
          f"{int((a > 0).sum())} pixels kept of {int((mags >= low).sum())} "
          f"weak ({strong} strong)", flush=True)
    _require(same, f"hysteresis kernel{label} is not equal to its plain "
             f"version")
    return err


def _check_hysteresis_wrap(dev) -> None:
    """A map whose only strong pixel sits on row 0, with weak pixels on
    the last rows and, past column 0, in the last column: every one of them
    hangs on it around the image's edges within the paths' 4 steps."""
    import torch

    from camkifu_tpu_torch.ops.cuda import hysteresis_kernel

    mags = torch.zeros((1, 256, 256), device=dev)
    mags[0, 0, 2] = 0.9
    mags[0, -3:, 0:5] = 0.5
    mags[0, 0, 0:2] = 0.5
    mags[0, 0:2, -1] = 0.5
    _check_hysteresis(mags, 0.3, 0.8, " (wrap)")
    out = hysteresis_kernel.hysteresis(mags, 0.3, 0.8, HYSTERESIS_ITERS)
    _require(bool(((out > 0) == (mags > 0)).all()),
             "hysteresis did not reach around the image's edges")


def _edge_cases(x, path: str, label: str, main: bool = False) -> list[dict]:
    """The edge and the hysteresis kernel at one path's maps ``x``: the
    hysteresis on the edge kernel's magnitudes and their own thresholds."""
    from camkifu_tpu_torch.ops.cuda import edge_kernel, hysteresis_kernel

    side = f"{x.shape[-1]}²"
    cases = [_case(
        "edge", f"N = {x.shape[0]}, {side}", path,
        lambda: edge_kernel.edge_magnitude(x),
        lambda: edge_kernel.edge_magnitude_ref(x),
        _check_edge(x, label), bound_edge(x), main=main, rows=x)]
    mags = edge_kernel.edge_magnitude(x)
    low, high = _thresholds(mags)
    cases.append(_case(
        "hysteresis", f"N = {x.shape[0]}, {side}, {HYSTERESIS_ITERS} steps",
        path,
        lambda: hysteresis_kernel.hysteresis(mags, low, high,
                                             HYSTERESIS_ITERS),
        lambda: hysteresis_kernel.hysteresis_ref(mags, low, high,
                                                 HYSTERESIS_ITERS),
        _check_hysteresis(mags, low, high, label), bound_hysteresis(mags),
        main=main))
    return cases


def _check_hough(pts, wts, rho_max: float, label: str) -> float:
    """The Hough kernel against its plain version on (..., K, 2) points,
    128 × 256 bins. Returns the largest difference."""
    import torch

    from camkifu_tpu_torch.ops.cuda import hough_kernel

    a = hough_kernel.hough_accumulate(pts, wts, rho_max, 128, 256)
    b = hough_kernel.hough_accumulate_ref(pts, wts, rho_max, 128, 256)
    torch.cuda.synchronize()
    err = float((a - b).abs().max())
    print(f"kernel hough{label}: max|kernel - plain| = {err:.3g} "
          f"(atol {HOUGH_ATOL}, max vote {float(b.max()):.4g})", flush=True)
    _require(err <= HOUGH_ATOL, f"hough kernel{label} disagrees")
    return err


def _case(name: str, shape: str, path: str, kern, plain, err: float,
          bound: tuple[float, str], library=None, main: bool = False,
          **extra) -> dict:
    """One kernel at one path shape, for ``phase_kernel_times``: the kernel
    and its plain version as calls, ``library`` a function that makes the
    library yardstick's call (or None), ``main`` for the still path's
    shape, which the top-level numbers of the kernels line report."""
    return {"name": name, "shape": shape, "path": path, "kern": kern,
            "plain": plain, "library": library, "err": err, "bound": bound,
            "main": main, **extra}


def phase_kernels(frames, corners) -> list[dict]:
    """Each kernel against its plain version at the still path's shapes."""
    import torch

    from camkifu_tpu_torch.board.bf_auto import (REFINE_RES, _rect_H,
                                                  resize_bilinear)
    from camkifu_tpu_torch.ops.color import rgb_to_gray_u8
    from camkifu_tpu_torch.ops.cuda import hough_kernel, warp_kernel
    from camkifu_tpu_torch.ops.edges import edge_map
    from camkifu_tpu_torch.ops.hough import topk_edge_points
    from camkifu_tpu_torch.ops.warp import canonical_corners, homography_dlt

    scale = 1.0 / 255.0
    cases = []
    # Warp: the canonical warp of the c2 batch, and the detector's gray rect.
    H = homography_dlt(canonical_corners(device=frames.device), corners)
    err = _check_warp(frames, H, (304, 304), "")
    sector_ms = warp_sector_bytes(frames, H, (304, 304)) / PEAK_BYTES_S * 1e3
    cases.append(_case(
        "warp", f"{tuple(frames.shape)} u8 → 304²×3", "still c2",
        lambda: warp_kernel.warp_homography(frames, H, (304, 304), scale),
        lambda: warp_kernel.warp_homography_ref(frames, H, (304, 304),
                                                scale),
        err, bound_warp(frames, (304, 304)),
        library=lambda: grid_sample_case(frames, H, (304, 304), scale),
        main=True, sector_floor_ms=sector_ms))
    gray = rgb_to_gray_u8(frames[0])[None, :, :, None].contiguous()
    H_rect = _rect_H(corners, 0.10, REFINE_RES).contiguous()
    rect_hw = (REFINE_RES,) * 2
    err = _check_warp(gray, H_rect, rect_hw, " (detector rect)")
    cases.append(_case(
        "warp", f"{tuple(gray.shape)} u8 → {REFINE_RES}²", "still rect",
        lambda: warp_kernel.warp_homography(gray, H_rect, rect_hw),
        lambda: warp_kernel.warp_homography_ref(gray, H_rect, rect_hw),
        err, bound_warp(gray, rect_hw)))

    # Edge: the detector's 256² luma and chroma maps of frame 0.
    f0 = frames[0]
    small = resize_bilinear(rgb_to_gray_u8(f0).float() / 255.0, (256, 256))
    chroma = resize_bilinear((f0[..., 0].float() - f0[..., 2].float())
                             / 255.0, (256, 256))
    x = torch.stack([small, chroma]).contiguous()
    cases += _edge_cases(x, "still", "", main=True)
    _check_hysteresis_wrap(frames.device)

    # Hough: K = 4096 edge points of the luma map, 128 × 256 bins.
    pts, wts = topk_edge_points(edge_map(small))
    rho_max = float(256 * 2 ** 0.5)
    cases.append(_case(
        "hough", "B = 1, K = 4096 → 128 × 256", "still",
        lambda: hough_kernel.hough_accumulate(pts, wts, rho_max, 128, 256),
        lambda: hough_kernel.hough_accumulate_ref(pts, wts, rho_max, 128,
                                                  256),
        _check_hough(pts, wts, rho_max, ""), bound_hough(pts, wts),
        main=True, splits=(pts, wts, rho_max)))
    return cases


def phase_main_path(frames, corners_true, labels) -> dict:
    """detect_corners + read_board_batch once, counting kernel launches."""
    import numpy as np
    import torch

    from camkifu_tpu_torch import pipeline
    from camkifu_tpu_torch.board import bf_auto

    _reset_counts()
    corners, score = bf_auto.detect_corners(frames[0])
    out, conf = pipeline.read_board_batch(frames, corners)
    torch.cuda.synchronize()
    counts = _read_counts()

    corners_np = corners.cpu().numpy()
    err_px = float(np.abs(corners_np - corners_true).max())
    out_np, conf_np = out.cpu().numpy(), conf.cpu().numpy()
    right = int((out_np == labels[None]).all(axis=(1, 2)).sum())
    print(f"still path: score {float(score):.4f}, corner error {err_px:.3f} "
          f"px (tol {TOL_PX}), boards read exactly {right}/{out_np.shape[0]}, "
          f"launches {counts}", flush=True)
    _require(float(score) > 0.1, "detection score too low")
    _require(err_px < TOL_PX, "corners off the ground truth")
    _require(out_np.shape == (BATCH, 19, 19) and conf_np.shape == out_np.shape,
             "wrong output shapes")
    _require(bool(np.isfinite(conf_np).all()), "non-finite confidence")
    _require(right == BATCH, "a board was misread")
    _require_launched(counts, "still")

    # The same path on the CPU, through the plain versions.
    c_cpu, s_cpu = bf_auto.detect_corners(frames[0].cpu())
    l_cpu, _ = pipeline.read_board_batch(frames[:1].cpu(), c_cpu)
    d_cpu = float(np.abs(c_cpu.numpy() - corners_np).max())
    same = np.array_equal(l_cpu.numpy()[0], out_np[0])
    print(f"plain CPU path: corners within {d_cpu:.4f} px of the card's "
          f"(tol {TOL_CPU_PX}), score {float(s_cpu):.4f}, labels "
          f"{'equal' if same else 'DIFFER'}", flush=True)
    _require(d_cpu < TOL_CPU_PX, "card and CPU corners disagree")
    _require(same, "card and CPU labels disagree")
    return {"corners": corners, "launches": counts}


def phase_times(frames, corners, card: str) -> dict:
    """CUDA-event times of c1 and c2."""
    import torch

    from camkifu_tpu_torch import pipeline
    from camkifu_tpu_torch.board import bf_auto

    def c1():
        cs, _ = bf_auto.detect_corners(frames[0])
        return pipeline.read_board_batch(frames[:1], cs)

    def c2():
        cs, _ = bf_auto.detect_corners(frames[0])
        return pipeline.read_board_batch(frames, cs)

    runs = {
        "c1": _cuda_ms_runs(c1, reps=20),
        "c2": _cuda_ms_runs(c2, reps=20),
        "detect": _cuda_ms_runs(lambda: bf_auto.detect_corners(frames[0]),
                                reps=20),
        "classify": _cuda_ms_runs(
            lambda: pipeline.read_board_batch(frames, corners), reps=20),
    }
    med = {k: _median(v) for k, v in runs.items()}
    print(f"times on {card}, median of 20 calls [min, max]: " + ", ".join(
        f"{k} {med[k]:.3f} ms [{v[0]:.3f}, {v[-1]:.3f}]"
        for k, v in runs.items())
        + f"; c2 {BATCH / med['c2'] * 1e3:.1f} frames/s ({BATCH} frames "
        f"per batch)", flush=True)
    c1_ms, c2_ms = med["c1"], med["c2"]

    return {"c1_ms": c1_ms, "c2_ms": c2_ms}


def phase_film(dev) -> dict:
    """The recorded-video path once: a seeded game from a fixed 720p
    camera through ``filecheck.run_pipeline`` with automatic detection,
    then its first batch through the plain CPU path."""
    import numpy as np
    import torch

    from camkifu_tpu_torch import filecheck
    from camkifu_tpu_torch.config import cvconf
    from camkifu_tpu_torch.core.gamesync import score_moves
    from camkifu_tpu_torch.board import bf_auto
    from camkifu_tpu_torch.stone import sf_meta
    from camkifu_tpu_torch.utils.still import render_game, sample_moves

    t0 = time.perf_counter()
    moves = sample_moves(FILM_MOVES, seed=5)
    frames, truth = render_game(moves, cvconf.vote_window + 2,
                                frame_hw=FILM_HW, empty_leadin=FILM_LEADIN)
    t_render = time.perf_counter() - t0

    t0 = time.perf_counter()
    _reset_counts()
    ex, stats = filecheck.run_pipeline(iter(frames), corners=None,
                                       batch=FILM_BATCH, device=dev)
    torch.cuda.synchronize()
    counts = _read_counts()
    t_run = time.perf_counter() - t0
    report = score_moves(ex.moves, moves)
    corners = np.asarray(stats["corners"], np.float32)
    err_px = float(np.abs(corners - truth).max())
    print(f"film path: {len(frames)} frames {FILM_HW[0]}p in batches of "
          f"{FILM_BATCH}, {report['good']}/{report['ref_moves']} moves "
          f"right, agreement {report['agreement']}, corner error "
          f"{err_px:.3f} px (tol {FILM_TOL_PX}), launches {counts} "
          f"(render {t_render:.1f} s, first run {t_run:.1f} s)", flush=True)
    _require(report["agreement"] == 1.0, "the film game was misread")
    _require(err_px < FILM_TOL_PX, "film corners off the ground truth")
    _require_launched(counts, "film")
    _require(max(counts["edge"][1]) >= 16,
             "the edge kernel never ran at N >= 16 on the film path")
    _require(max(counts["hough"][1]) > 1,
             "the Hough kernel never ran with B > 1 on the film path")

    # The first batch through the plain CPU path: the same corners from
    # detection, then the same labels and stable board from the vote scan
    # (both read through the card's corners).
    t0 = time.perf_counter()
    fb = torch.from_numpy(frames[:FILM_BATCH])
    c_cpu = bf_auto.detect_batch_stable(fb)
    d_cpu = float(np.abs(c_cpu.numpy() - corners).max())
    c_dev = torch.from_numpy(corners)
    st_d, lab_d, _, _ = sf_meta.read_batch(
        sf_meta.init_state(device=dev), fb.to(dev), c_dev.to(dev))
    st_c, lab_c, _, _ = sf_meta.read_batch(sf_meta.init_state(device="cpu"),
                                        fb, c_dev)
    same_labels = torch.equal(lab_d.cpu(), lab_c)
    same_stable = torch.equal(st_d.stable.cpu(), st_c.stable)
    print(f"film, plain CPU path on the first batch: corners within "
          f"{d_cpu:.4f} px of the card's (tol {TOL_CPU_PX}), labels "
          f"{'equal' if same_labels else 'DIFFER'}, stable "
          f"{'equal' if same_stable else 'DIFFERS'} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    _require(d_cpu < TOL_CPU_PX, "film: card and CPU corners disagree")
    _require(same_labels and same_stable,
             "film: card and CPU vote scans disagree")
    return {"frames": frames, "corners": corners, "launches": counts,
            "moves": moves}


def _drift_labels() -> "np.ndarray":
    """The drifting frames' board: 40 stones, seed 1."""
    import numpy as np

    labels = np.zeros((19, 19), np.int8)
    idx = np.random.default_rng(1).choice(361, 40, replace=False)
    labels.flat[idx[::2]] = 1
    labels.flat[idx[1::2]] = 2
    return labels


def _drift_frames(dev):
    """``REDETECT_RENDERS`` 1080p stills whose corners drift ±3 px (as
    tests/test_detect_shared.py makes them), tiled to ``REDETECT_BATCH``
    frames on the card, and each frame's true corners."""
    import numpy as np
    import torch

    from camkifu_tpu_torch.utils.still import default_corners, render_still

    labels = _drift_labels()
    base = default_corners(FRAME_HW)
    renders, truth = [], []
    for i in range(REDETECT_RENDERS):
        c = base + np.array([REDETECT_DRIFT * np.sin(i / 2.0),
                             REDETECT_DRIFT * np.cos(i / 3.0)], np.float32)
        f, gt = render_still(labels, frame_hw=FRAME_HW, seed=i, corners=c)
        renders.append(torch.from_numpy(f).to(dev))
        truth.append(gt)
    reps = REDETECT_BATCH // REDETECT_RENDERS
    return torch.stack(renders * reps), np.stack(truth * reps)


def phase_redetect(dev) -> dict:
    """``detect_batch`` once on 64 drifting 1080p frames."""
    import numpy as np
    import torch

    from camkifu_tpu_torch.board import bf_auto

    t0 = time.perf_counter()
    frames, truth = _drift_frames(dev)
    t_render = time.perf_counter() - t0
    _reset_counts()
    corners, scores = bf_auto.detect_batch(frames)
    torch.cuda.synchronize()
    counts = _read_counts()
    # The verdicts of the same stage 1 and chunked route: every chunk took
    # the shared canvas, whose corners detect_batch returned.
    grays, quads, scores1 = bf_auto._detect_prepare_batch(frames, 256)
    routed, oks = bf_auto._chunked_route(grays, quads, scores1, 19,
                                         bf_auto.SHARED_CHUNK)
    oks = oks.cpu().numpy()
    err_px = float(np.abs(corners.cpu().numpy() - truth).max())
    print(f"redetect path: {REDETECT_BATCH} x {FRAME_HW[0]}p, corner error "
          f"{err_px:.3f} px (tol {TOL_PX}), shared route in "
          f"{int(oks.sum())}/{oks.size} chunks, scores "
          f"[{float(scores.min()):.3f}, {float(scores.max()):.3f}], launches "
          f"{counts} (render {t_render:.1f} s)", flush=True)
    _require(err_px < TOL_PX, "redetect corners off the ground truth")
    _require(bool(oks.all()), "a redetect chunk left the shared route")
    _require(torch.equal(routed, corners),
             "detect_batch did not return the shared-route corners")
    _require_launched(counts, "redetect")
    _require(max(counts["edge"][1]) >= 2 * REDETECT_BATCH,
             "the edge kernel did not take the whole batch at once")
    _require(max(counts["hough"][1]) == REDETECT_BATCH,
             "the Hough kernel did not take the whole batch at once")
    return {"frames": frames, "truth": truth, "launches": counts,
            "grays": grays, "quads": quads}


def phase_batch_kernels(redetect: dict, film: dict, dev) -> list[dict]:
    """Each kernel against its plain version at the film and redetect
    paths' shapes: the warp kernel on a redetect chunk's shared gray
    rectification (8 × 1080p, C = 1 → 320²) and on a film batch's
    canonical warp (32 × 720p RGB → 304²), the edge kernel at N = 16 (the
    film's 8 detected frames) and N = 128, the Hough kernel at B = 8 and
    B = 64."""
    import torch

    from camkifu_tpu_torch.board.bf_auto import (REFINE_RES, SHARED_CHUNK,
                                                  _rect_H, resize_bilinear)
    from camkifu_tpu_torch.ops.color import rgb_to_gray_u8
    from camkifu_tpu_torch.ops.cuda import hough_kernel, warp_kernel
    from camkifu_tpu_torch.ops.edges import edge_map_batch
    from camkifu_tpu_torch.ops.hough import topk_edge_points
    from camkifu_tpu_torch.ops.warp import canonical_corners, homography_dlt

    scale = 1.0 / 255.0
    cases = []
    grays = redetect["grays"][:SHARED_CHUNK][..., None].contiguous()
    med = torch.quantile(redetect["quads"][:SHARED_CHUNK], 0.5, dim=0)
    H_rect = _rect_H(med, 0.10, REFINE_RES).contiguous()
    rect_hw = (REFINE_RES,) * 2
    err = _check_warp(grays, H_rect, rect_hw, " (redetect chunk rect)")
    cases.append(_case(
        "warp", f"{tuple(grays.shape)} u8 → {REFINE_RES}²", "redetect rect",
        lambda: warp_kernel.warp_homography(grays, H_rect, rect_hw),
        lambda: warp_kernel.warp_homography_ref(grays, H_rect, rect_hw),
        err, bound_warp(grays, rect_hw)))
    film_frames = torch.from_numpy(film["frames"][:FILM_BATCH]).to(dev)
    film_H = homography_dlt(canonical_corners(device=dev),
                            torch.from_numpy(film["corners"]).to(dev))
    err = _check_warp(film_frames, film_H, (304, 304), " (film batch)")
    cases.append(_case(
        "warp", f"{tuple(film_frames.shape)} u8 → 304²×3", "film",
        lambda: warp_kernel.warp_homography(film_frames, film_H, (304, 304),
                                            scale),
        lambda: warp_kernel.warp_homography_ref(film_frames, film_H,
                                                (304, 304), scale),
        err, bound_warp(film_frames, (304, 304)),
        library=lambda: grid_sample_case(film_frames, film_H, (304, 304),
                                         scale)))

    f = redetect["frames"]
    small = resize_bilinear(rgb_to_gray_u8(f).float() / 255.0, (256, 256))
    chroma = resize_bilinear((f[..., 0].float() - f[..., 2].float())
                             / 255.0, (256, 256))
    n_film = FILM_DETECT_FRAMES
    for x, path in ((torch.cat([small[:n_film], chroma[:n_film]]), "film"),
                    (torch.cat([small, chroma]), "redetect")):
        cases += _edge_cases(x.contiguous(), path, f" at N = {x.shape[0]}")

    pts_all, wts_all = topk_edge_points(edge_map_batch(small))
    rho_max = float(256 * 2 ** 0.5)
    for n, path in ((n_film, "film"), (REDETECT_BATCH, "redetect")):
        pts = pts_all[:n].contiguous()
        wts = wts_all[:n].contiguous()
        cases.append(_case(
            "hough", f"B = {n}, K = {pts.shape[1]} → 128 × 256", path,
            lambda p=pts, w=wts: hough_kernel.hough_accumulate(
                p, w, rho_max, 128, 256),
            lambda p=pts, w=wts: hough_kernel.hough_accumulate_ref(
                p, w, rho_max, 128, 256),
            _check_hough(pts, wts, rho_max, f" at B = {n}"),
            bound_hough(pts, wts), splits=(pts, wts, rho_max)))
    return cases


def _split_sweep(pts, wts, rho_max: float) -> str:
    """The Hough kernel's ms at each of ``HOUGH_SPLITS`` (up to 64 points
    a split), beside the split count its wrapper picks, as text."""
    from camkifu_tpu_torch.ops.cuda import hough_kernel

    b, k = pts.numel() // pts.shape[-1] // pts.shape[-2], pts.shape[-2]
    auto = hough_kernel.auto_splits(b, k, 128, pts.device)
    times = {s: _cuda_ms(hough_at_splits(pts, wts, rho_max, s), KERNEL_REPS)
             for s in HOUGH_SPLITS if s <= k // 64}
    return f"; by splits (auto {auto}): " + ", ".join(
        f"{s} {t:.4f}" for s, t in times.items())


def _rows_sweep(x) -> str:
    """The edge kernel's ms with each strip width at each of ``EDGE_ROWS``
    rows a segment, beside the pair its wrapper picks, as text."""
    from camkifu_tpu_torch.ops.cuda import edge_kernel

    n, h, w = x.shape
    auto = edge_kernel.auto_plan(n, h, w, x.device)
    text = f"; by (columns a lane, rows a segment), auto {auto}"
    for cols in edge_kernel.STRIPS:
        times = {r: _cuda_ms(edge_at(x, cols, r), KERNEL_REPS)
                 for r in EDGE_ROWS if r <= h}
        text += f": {cols} columns " + ", ".join(
            f"{r} {t:.4f}" for r, t in times.items())
    return text


def phase_kernel_times(cases: list[dict], card: str) -> None:
    """CUDA-event device times of every kernel case beside its plain
    version (plain, kernel, kernel, plain) and its library yardstick, with
    the share of its bound; the still path's shapes also as the host
    issues them. Writes the numbers into each case."""
    import torch

    for c in cases:
        p1 = _cuda_ms(c["plain"], PLAIN_REPS)
        k1 = _cuda_ms(c["kern"], KERNEL_REPS)
        k2 = _cuda_ms(c["kern"], KERNEL_REPS)
        p2 = _cuda_ms(c["plain"], PLAIN_REPS)
        c["ms"], c["plain_ms"] = (k1 + k2) / 2, (p1 + p2) / 2
        c["library_ms"] = None
        if c["library"] is not None:
            call = c["library"]()
            c["library_ms"] = _cuda_ms(call, LIBRARY_REPS)
            del call
            torch.cuda.empty_cache()
        c["bound_ms"], c["bound_by"] = c["bound"]
        c["share"] = c["bound_ms"] / c["ms"]
        extra = ""
        if c["main"]:
            c["paced_ms"] = _cuda_ms(c["kern"], KERNEL_REPS, spin=False)
            extra = f"; {c['paced_ms']:.4f} ms as the host issues it"
        if "sector_floor_ms" in c:
            extra += f"; whole-sector floor {c['sector_floor_ms']:.4f} ms"
        if "splits" in c:
            extra += _split_sweep(*c["splits"])
        if "rows" in c:
            extra += _rows_sweep(c["rows"])
        lib = ("" if c["library_ms"] is None else
               f", library {c['library_ms']:.4f} ms")
        print(f"time {c['name']} {c['shape']} ({c['path']}): kernel "
              f"{c['ms']:.4f} ms, plain {c['plain_ms']:.4f} ms{lib}, bound "
              f"{c['bound_ms']:.4f} ms by {c['bound_by']}, share "
              f"{c['share']:.3f}{extra} ({card})", flush=True)


def phase_film_times(film: dict, redetect: dict, dev, card: str) -> dict:
    """CUDA-event times of c3, the full redetect and the film end to
    end."""
    import torch

    from camkifu_tpu_torch import filecheck
    from camkifu_tpu_torch.board import bf_auto
    from camkifu_tpu_torch.stone import sf_meta

    frames = film["frames"]
    idx = torch.arange(C3_BATCH) % frames.shape[0]
    c3_frames = torch.from_numpy(frames)[idx].to(dev)
    c3_corners = torch.from_numpy(film["corners"]).to(dev)
    state0 = sf_meta.init_state(device=dev)
    # Calls per time: the redetect takes ~2.4 s a call and the film ~0.6 s,
    # so they take fewer to keep the phase short.
    runs = {
        "c3": _cuda_ms_runs(lambda: sf_meta.read_batch(
            state0, c3_frames, c3_corners), reps=20),
        "redetect": _cuda_ms_runs(
            lambda: bf_auto.detect_batch(redetect["frames"]), reps=5,
            warmup=1),
        "film": _cuda_ms_runs(lambda: filecheck.run_pipeline(
            iter(frames), corners=None, batch=FILM_BATCH, device=dev),
            reps=10, warmup=1),
    }
    n = {"c3": C3_BATCH, "redetect": REDETECT_BATCH,
         "film": frames.shape[0]}
    med = {k: _median(v) for k, v in runs.items()}
    fps = {k: n[k] / med[k] * 1e3 for k in runs}
    print(f"times on {card}, median of N calls [min, max]: " + ", ".join(
        f"{k} {med[k]:.3f} ms [{v[0]:.3f}, {v[-1]:.3f}] over {len(v)} = "
        f"{fps[k]:.1f} frames/s ({n[k]} frames)" for k, v in runs.items()),
        flush=True)

    return {"fps": fps, "ms": med}


def phase_handheld(dev) -> dict:
    """The handheld path once: a seeded game from a drifting 720p camera,
    one detection, then ``track_read_batch`` batch by batch; from the
    second batch on any call that makes the host wait for the card is an
    error. Then its first frames through ``device="cpu"``."""
    import numpy as np
    import torch

    from camkifu_tpu_torch.board import bf_auto
    from camkifu_tpu_torch.config import cvconf
    from camkifu_tpu_torch.core.gamesync import MoveExtractor, score_moves
    from camkifu_tpu_torch.ops.cuda import warp_kernel
    from camkifu_tpu_torch.stone import sf_meta
    from camkifu_tpu_torch.utils.still import (handheld_corners, render_game,
                                                sample_moves)

    t0 = time.perf_counter()
    moves = sample_moves(HANDHELD_MOVES, seed=5)
    fpm = cvconf.vote_window + 3
    n_frames = 6 + HANDHELD_MOVES * fpm
    truth = handheld_corners(n_frames, HANDHELD_HW)
    frames, _ = render_game(moves, fpm, frame_hw=HANDHELD_HW, seed=5,
                            empty_leadin=6, corners=truth,
                            workers=HANDHELD_RENDER_THREADS)
    t_render = time.perf_counter() - t0

    def batches():
        for lo in range(0, n_frames, HANDHELD_BATCH):
            fb = frames[lo:lo + HANDHELD_BATCH]
            n = fb.shape[0]
            if n < HANDHELD_BATCH:            # capture padding
                fb = np.concatenate(
                    [fb, np.repeat(fb[-1:], HANDHELD_BATCH - n, 0)])
            yield lo, n, torch.from_numpy(fb)

    t0 = time.perf_counter()
    _reset_counts()
    seed0, score = bf_auto.detect_corners(torch.from_numpy(frames[0]).to(dev))
    detect_warps = warp_kernel.launches
    state = sf_meta.init_state(device=dev)
    seed = seed0
    ex = MoveExtractor()
    corners, sharps, first = [], [], {}
    try:
        for lo, n, fb in batches():
            fb = fb.to(dev)
            torch.cuda.synchronize()
            if lo:
                torch.cuda.set_sync_debug_mode("error")
            out = sf_meta.track_read_batch(state, fb, seed, chunk=C4_CHUNK,
                                           valid_count=n)
            torch.cuda.set_sync_debug_mode("default")
            state, labels, _, _, cs, sharp, _, seed = out
            if lo < HANDHELD_CPU_FRAMES:
                first[lo] = (labels.cpu(), cs.cpu())
            corners.append(cs[:n].cpu().numpy())
            sharps.append(sharp[:n].cpu().numpy())
            for lab in labels[:n].cpu().numpy():
                ex.advance(lab)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    counts = _read_counts()
    t_run = time.perf_counter() - t0
    n_chunks = -(-n_frames // HANDHELD_BATCH) * -(-HANDHELD_BATCH // C4_CHUNK)
    report = score_moves(ex.moves, moves)
    cell = float(np.linalg.norm(truth[0][1] - truth[0][0]) / 18)
    err_cells = float(np.abs(np.concatenate(corners) - truth).max()) / cell
    sharp_min = float(np.concatenate(sharps).min())
    print(f"handheld path: {n_frames} frames {HANDHELD_HW[0]}p in batches of "
          f"{HANDHELD_BATCH}, seed score {float(score):.4f}, "
          f"{report['good']}/{report['ref_moves']} moves right, agreement "
          f"{report['agreement']}, tracked corners within {err_cells:.4f} "
          f"cell of the truth (tol {HANDHELD_TOL_CELLS}), sharpness min "
          f"{sharp_min:.3f} (gate {bf_auto.TRACK_MIN_SHARPNESS}), no host "
          f"wait in track_read_batch from the second batch on, launches "
          f"{counts} of which the tracker's warp "
          f"{counts['warp'][0] - detect_warps} in {n_chunks} chunks (render "
          f"{t_render:.1f} s, run {t_run:.1f} s)", flush=True)
    _require(float(score) > 0.1, "handheld: detection score too low")
    _require(report["agreement"] == 1.0, "the handheld game was misread")
    _require(err_cells < HANDHELD_TOL_CELLS,
             "handheld: tracked corners off the ground truth")
    _require(sharp_min >= bf_auto.TRACK_MIN_SHARPNESS,
             "handheld: a frame's correlation was rejected")
    _require_launched(counts, "handheld")
    _require(counts["warp"][0] - detect_warps == n_chunks,
             "handheld: the warp kernel was not launched once per chunk")

    # The first batches through device="cpu": the same seed, the plain warp.
    t0 = time.perf_counter()
    st = sf_meta.init_state(device="cpu")
    sd = seed0.cpu()
    d_px, same = 0.0, True
    for lo, n, fb in batches():
        if lo >= HANDHELD_CPU_FRAMES:
            break
        st, lab_c, _, _, cs_c, _, _, sd = sf_meta.track_read_batch(
            st, fb, sd, chunk=C4_CHUNK, valid_count=n)
        d_px = max(d_px, float((cs_c - first[lo][1]).abs().max()))
        same = same and torch.equal(lab_c, first[lo][0])
    print(f"handheld, device=\"cpu\" on the first {HANDHELD_CPU_FRAMES} "
          f"frames: corners within {d_px:.4f} px of the card's (tol "
          f"{TOL_CPU_PX}), labels {'equal' if same else 'DIFFER'} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    _require(d_px < TOL_CPU_PX, "handheld: card and CPU corners disagree")
    _require(same, "handheld: card and CPU labels disagree")
    return {"launches": counts, "frames": frames, "truth": truth,
            "seed": seed0.cpu().numpy(), "moves": moves}


def _c4_inputs(redetect: dict):
    """bench.py's c4 input at full width: the redetect's 64 drifting 1080p
    frames twice, and each frame's true corners."""
    import numpy as np
    import torch

    reps = C4_BATCH // REDETECT_BATCH
    return (torch.cat([redetect["frames"]] * reps),
            np.concatenate([redetect["truth"]] * reps))


def phase_handheld_kernels(redetect: dict) -> list[dict]:
    """The warp kernel against its plain version at the handheld path's
    three shapes: the fused engine's canvas (16 × 1080p RGB → 336²), the
    unfused tracker's gray canvas (8 × 1080p → 320²) and
    ``warp_batch_chunked``'s chunk (8 × 1080p RGB → 304²)."""
    import torch

    from camkifu_tpu_torch.board.bf_auto import (REFINE_RES, TRACK_MARGIN,
                                                  _rect_H)
    from camkifu_tpu_torch.ops.color import rgb_to_gray_u8
    from camkifu_tpu_torch.ops.cuda import warp_kernel
    from camkifu_tpu_torch.ops.warp import canonical_corners, homography_dlt

    frames, truth = _c4_inputs(redetect)
    dev = frames.device
    scale = 1.0 / 255.0
    seed = torch.from_numpy(truth[0]).to(dev)
    fused = frames[:C4_CHUNK]
    chunk = frames[:UNFUSED_CHUNK]
    grays = rgb_to_gray_u8(chunk)[..., None].contiguous()
    med = torch.quantile(torch.from_numpy(truth[:UNFUSED_CHUNK]).to(dev),
                         0.5, dim=0)
    # The fused canvas: 304² and a cell's margin around it (336²), the
    # seed's corner intersections on the centers of the corner cells.
    shapes = (
        ("handheld canvas", fused, (336, 336), scale, _canvas_H(seed, 19)),
        ("handheld gray canvas", grays, (REFINE_RES,) * 2, scale,
         _rect_H(seed, TRACK_MARGIN, REFINE_RES)),
        ("handheld chunked", chunk, (304, 304), scale,
         homography_dlt(canonical_corners(device=dev), med)),
    )
    cases = []
    for path, x, hw, sc, H in shapes:
        H = H.contiguous()
        err = _check_warp(x, H, hw, f" ({path})")
        cases.append(_case(
            "warp", f"{tuple(x.shape)} u8 → {hw[0]}²×{x.shape[-1]}", path,
            lambda x=x, H=H, hw=hw: warp_kernel.warp_homography(x, H, hw, sc),
            lambda x=x, H=H, hw=hw: warp_kernel.warp_homography_ref(
                x, H, hw, sc),
            err, bound_warp(x, hw),
            library=lambda x=x, H=H, hw=hw: grid_sample_case(x, H, hw, sc)))
    return cases


def phase_handheld_times(redetect: dict, card: str) -> dict:
    """c4 at full width: one counted and checked call, then CUDA-event
    times of c4 (``detect_corners`` + ``track_read_batch``), of
    ``track_read_batch`` alone, and of the unfused pair
    (``track_corners_batch`` + ``read_batch``)."""
    import numpy as np
    import torch

    from camkifu_tpu_torch.board import bf_auto
    from camkifu_tpu_torch.ops.cuda import warp_kernel
    from camkifu_tpu_torch.stone import sf_meta

    frames, truth = _c4_inputs(redetect)
    dev = frames.device
    state0 = sf_meta.init_state(device=dev)

    def c4():
        seed, _ = bf_auto.detect_corners(frames[0])
        return sf_meta.track_read_batch(state0, frames, seed, chunk=C4_CHUNK)

    _reset_counts()
    seed, score = bf_auto.detect_corners(frames[0])
    detect_warps = warp_kernel.launches
    out = sf_meta.track_read_batch(state0, frames, seed, chunk=C4_CHUNK)
    torch.cuda.synchronize()
    counts = _read_counts()
    _, labels, conf, _, cs, sharp, _, _ = out
    cell = float(np.linalg.norm(truth[0][1] - truth[0][0]) / 18)
    err_cells = float(np.abs(cs.cpu().numpy() - truth).max()) / cell
    tracker_warps = counts["warp"][0] - detect_warps
    print(f"c4 at full width: {tuple(frames.shape)}, chunk {C4_CHUNK}, seed "
          f"score {float(score):.4f}, tracked corners within "
          f"{err_cells:.4f} cell of the truth (tol {HANDHELD_TOL_CELLS}), "
          f"sharpness min {float(sharp.min()):.3f}, launches {counts} of "
          f"which the tracker's warp {tracker_warps}", flush=True)
    _require(labels.shape == (C4_BATCH, 19, 19) and cs.shape
             == (C4_BATCH, 4, 2), "c4: wrong output shapes")
    _require(bool(torch.isfinite(conf).all() & torch.isfinite(cs).all()),
             "c4: non-finite output")
    _require(err_cells < HANDHELD_TOL_CELLS,
             "c4: tracked corners off the ground truth")
    _require(float(sharp.min()) >= bf_auto.TRACK_MIN_SHARPNESS,
             "c4: a frame's correlation was rejected")
    _require_launched(counts, "c4")
    _require(tracker_warps == C4_BATCH // C4_CHUNK,
             "c4: the warp kernel was not launched once per chunk")

    def unfused():
        cs_u, _, _, _ = bf_auto.track_corners_batch(frames, seed,
                                                    chunk=UNFUSED_CHUNK)
        return sf_meta.read_batch(state0, frames, cs_u)

    # Both engines' votes settle on the board that was drawn.
    board = torch.from_numpy(_drift_labels()).to(dev)
    _require(torch.equal(labels[-1], board), "c4: the board was misread")
    _require(torch.equal(unfused()[1][-1], board),
             "c4: the unfused pair misread the board")
    runs = {
        "c4": _cuda_ms_runs(c4, reps=10),
        "track_read": _cuda_ms_runs(lambda: sf_meta.track_read_batch(
            state0, frames, seed, chunk=C4_CHUNK), reps=10),
        "unfused": _cuda_ms_runs(unfused, reps=10),
    }
    med = {k: _median(v) for k, v in runs.items()}
    fps = {k: C4_BATCH / med[k] * 1e3 for k in runs}
    print(f"times on {card}, median of 10 calls [min, max], {C4_BATCH} x "
          f"{FRAME_HW[0]}p: " + ", ".join(
              f"{k} {med[k]:.3f} ms [{v[0]:.3f}, {v[-1]:.3f}] = "
              f"{fps[k]:.1f} frames/s" for k, v in runs.items())
          + "; both engines read the board exactly", flush=True)
    return {"fps": fps, "ms": med}


def _size_labels(g: int) -> "np.ndarray":
    """A size-``g`` board with ``g`` stones, seed ``g``."""
    import numpy as np

    labels = np.zeros((g, g), np.int8)
    idx = np.random.default_rng(g).choice(g * g, g, replace=False)
    labels.flat[idx[::2]] = 1
    labels.flat[idx[1::2]] = 2
    return labels


def _canvas_H(corners, g: int, zone: int = 16, pad: int = 16):
    """The fused tracker's canvas homography for size ``g``: the corner
    intersections on the centers of the corner cells of a (g·zone + 2·pad)²
    canvas."""
    from camkifu_tpu_torch.ops.warp import homography_dlt, square

    lo = pad + zone / 2.0 - 0.5
    return homography_dlt(square(lo, pad + g * zone - zone / 2.0 - 0.5,
                                 corners.device), corners)


def phase_sizes(dev, card: str) -> dict:
    """Board sizes 9 and 13 at 1080p: ``detect_corners``, 128 copies
    through ``read_board_batch``, one chunk of 16 through
    ``track_read_batch``, and ``infer_gsize`` on each size and on a 19
    board, counting launches; then the warp kernel at the new canonical
    and canvas sides, and CUDA-event times of c1, c2 and ``infer_gsize``."""
    import numpy as np
    import torch

    from camkifu_tpu_torch import pipeline
    from camkifu_tpu_torch.board import bf_auto
    from camkifu_tpu_torch.ops.cuda import warp_kernel
    from camkifu_tpu_torch.ops.warp import canonical_corners, homography_dlt
    from camkifu_tpu_torch.stone import sf_meta
    from camkifu_tpu_torch.utils.still import render_still

    t0 = time.perf_counter()
    stills = {}
    for g in SIZES + (19,):
        frame, truth = render_still(_size_labels(g), frame_hw=FRAME_HW,
                                    seed=g)
        stills[g] = (torch.from_numpy(frame).to(dev), truth)
    t_render = time.perf_counter() - t0

    _reset_counts()
    out = {}
    for g in SIZES:
        frame, truth = stills[g]
        frames = frame[None].expand(BATCH, *frame.shape).contiguous()
        corners, score = bf_auto.detect_corners(frame, gsize=g)
        labels, conf = pipeline.read_board_batch(frames, corners, gsize=g)
        track = sf_meta.track_read_batch(
            sf_meta.init_state(g, device=dev), frames[:C4_CHUNK],
            torch.from_numpy(truth).to(dev), gsize=g, chunk=C4_CHUNK)
        out[g] = (frames, corners, score, labels, conf, track)
    inferred = {g: bf_auto.infer_gsize(stills[g][0]) for g in stills}
    torch.cuda.synchronize()
    counts = _read_counts()

    for g in SIZES:
        frames, corners, score, labels, conf, track = out[g]
        truth = stills[g][1]
        cell = float(np.linalg.norm(truth[1] - truth[0])) / (g - 1)
        err = float(np.abs(corners.cpu().numpy() - truth).max()) / cell
        right = int((labels.cpu().numpy() == _size_labels(g)[None])
                    .all(axis=(1, 2)).sum())
        t_err = float(np.abs(track[4].cpu().numpy() - truth).max()) / cell
        print(f"size {g}: score {float(score):.4f}, corners within "
              f"{err:.4f} cell of the truth (tol {SIZE_TOL_CELLS}), boards "
              f"read exactly {right}/{BATCH}, tracked corners within "
              f"{t_err:.4f} cell (tol {HANDHELD_TOL_CELLS}), sharpness min "
              f"{float(track[5].min()):.3f}", flush=True)
        _require(float(score) > 0.5, f"size {g}: detection score too low")
        _require(err < SIZE_TOL_CELLS, f"size {g}: corners off the truth")
        _require(labels.shape == (BATCH, g, g)
                 and bool(torch.isfinite(conf).all()),
                 f"size {g}: wrong or non-finite output")
        _require(right == BATCH, f"size {g}: a board was misread")
        _require(t_err < HANDHELD_TOL_CELLS,
                 f"size {g}: tracked corners off the truth")
    for g, (got, quals) in inferred.items():
        others = max(q for k, q in quals.items() if k != g)
        print(f"infer_gsize on a {g} board: {got}, qualities "
              + ", ".join(f"{k} {q:.4f}" for k, q in quals.items())
              + f", margin {quals[g] / others:.3f} (gate {INFER_MARGIN})",
              flush=True)
        _require(got == g, f"infer_gsize read a {g} board as {got}")
        _require(quals[g] > INFER_MARGIN * others,
                 f"infer_gsize: no {INFER_MARGIN}x margin on the {g} board")
    print(f"sizes path: launches {counts} (render {t_render:.1f} s)",
          flush=True)
    _require_launched(counts, "sizes")

    # The warp kernel at the new sides: canonical 144² / 208² (c2) and
    # the tracker's canvas 176² / 240².
    scale = 1.0 / 255.0
    cases = []
    for g in SIZES:
        frames, corners = out[g][0], out[g][1]
        side, canvas = 16 * g, 16 * g + 32
        for path, x, hw, H in (
                (f"size {g} c2", frames, (side, side),
                 homography_dlt(canonical_corners(g, 16, dev), corners)),
                (f"size {g} canvas", frames[:C4_CHUNK], (canvas, canvas),
                 _canvas_H(corners, g))):
            H = H.contiguous()
            err = _check_warp(x, H, hw, f" ({path})")
            cases.append(_case(
                "warp", f"{tuple(x.shape)} u8 → {hw[0]}²×3", path,
                lambda x=x, H=H, hw=hw: warp_kernel.warp_homography(
                    x, H, hw, scale),
                lambda x=x, H=H, hw=hw: warp_kernel.warp_homography_ref(
                    x, H, hw, scale),
                err, bound_warp(x, hw),
                library=lambda x=x, H=H, hw=hw: grid_sample_case(
                    x, H, hw, scale)))

    runs = {}
    for g in SIZES:
        frames = out[g][0]

        def c1(g=g, frames=frames):
            cs, _ = bf_auto.detect_corners(frames[0], gsize=g)
            return pipeline.read_board_batch(frames[:1], cs, gsize=g)

        def c2(g=g, frames=frames):
            cs, _ = bf_auto.detect_corners(frames[0], gsize=g)
            return pipeline.read_board_batch(frames, cs, gsize=g)

        runs[f"c1 at {g}"] = _cuda_ms_runs(c1, reps=20)
        runs[f"c2 at {g}"] = _cuda_ms_runs(c2, reps=20)
    runs["infer_gsize"] = _cuda_ms_runs(
        lambda: bf_auto.infer_gsize(stills[13][0]), reps=5, warmup=1)
    med = {k: _median(v) for k, v in runs.items()}
    print(f"times on {card}, median [min, max] of 20 calls (5 for "
          f"infer_gsize on the 13 board): " + ", ".join(
              f"{k} {med[k]:.3f} ms [{v[0]:.3f}, {v[-1]:.3f}]"
              for k, v in runs.items())
          + "; " + ", ".join(f"c2 at {g} {BATCH / med[f'c2 at {g}'] * 1e3:.1f}"
                             f" frames/s" for g in SIZES), flush=True)
    return {"launches": counts, "cases": cases, "ms": med}


def _translate(frames, dx: int, dy: int, out=None):
    """(..., H, W, 3) uint8 frames moved by (dx, dy) whole pixels into
    ``out`` (a new array if None), the uncovered border filled with the
    renderer's table colour."""
    import numpy as np

    from camkifu_tpu_torch.utils.still import TABLE

    h, w = frames.shape[-3], frames.shape[-2]
    if out is None:
        out = np.empty_like(frames)
    out[...] = np.asarray(TABLE, np.uint8)

    def span(d, n):
        return (slice(0, n - d), slice(d, n)) if d >= 0 else \
            (slice(-d, n), slice(0, n + d))

    (ys, yd), (xs, xd) = span(dy, h), span(dx, w)
    out[..., yd, xd, :] = frames[..., ys, xs, :]
    return out


def _c5_inputs(dev):
    """bench.py's c5 at full width, each stream its own board and camera:
    (frames (8, 16, 1080, 1920, 3) on ``dev``, corners (8, 4, 2) on
    ``dev``, truth labels (8, 19, 19))."""
    import numpy as np
    import torch

    from camkifu_tpu_torch.utils.still import render_still

    frames, corners, labels = [], [], []
    for r in range(C5_RENDERS):
        lab = np.zeros((19, 19), np.int8)
        idx = np.random.default_rng(100 + r).choice(361, 40 + 20 * r,
                                                    replace=False)
        lab.flat[idx[::2]] = 1
        lab.flat[idx[1::2]] = 2
        frame, truth = render_still(lab, frame_hw=FRAME_HW, seed=100 + r)
        for dx, dy in C5_SHIFTS:
            f = torch.from_numpy(_translate(frame, dx, dy)).to(dev)
            frames.append(f[None].expand(C5_PER_STREAM, *f.shape))
            corners.append(truth + np.array([dx, dy], np.float32))
            labels.append(lab)
    return (torch.stack(frames).contiguous(),
            torch.from_numpy(np.stack(corners)).to(dev), np.stack(labels))


def phase_c5(dev, card: str) -> dict:
    """c5 once, counted and checked (one warp launch for all 128 frames,
    every stream's 16 grids equal to its own board), the warp kernel at
    its shape with 128 distinct homographies, and c5's CUDA-event time."""
    import torch

    from camkifu_tpu_torch.ops.cuda import warp_kernel
    from camkifu_tpu_torch.ops.warp import canonical_corners, homography_dlt
    from camkifu_tpu_torch.parallel import mesh

    t0 = time.perf_counter()
    frames, corners, truth = _c5_inputs(dev)
    t_render = time.perf_counter() - t0
    _reset_counts()
    labels, conf = mesh._read_all_streams(frames, corners)
    torch.cuda.synchronize()
    counts = _read_counts()
    n = C5_STREAMS * C5_PER_STREAM
    right = int((labels.cpu().numpy() == truth[:, None])
                .all(axis=(2, 3)).sum())
    print(f"c5 path: {tuple(frames.shape)}, boards read exactly {right}/{n}, "
          f"launches {counts} (render {t_render:.1f} s)", flush=True)
    _require(labels.shape == (C5_STREAMS, C5_PER_STREAM, 19, 19)
             and bool(torch.isfinite(conf).all()),
             "c5: wrong or non-finite output")
    _require(right == n, "c5: a stream's board was misread")
    _require(counts["warp"][0] == 1,
             "c5: not one warp launch for every stream's frames")

    # Every frame its own homography: its stream's corners moved by a
    # hundredth of a pixel per frame.
    flat = frames.reshape(n, *frames.shape[2:])
    jitter = torch.arange(n, device=dev, dtype=torch.float32) * 0.01
    per_frame = corners.repeat_interleave(C5_PER_STREAM, 0) \
        + jitter[:, None, None]
    H = homography_dlt(canonical_corners(device=dev), per_frame).contiguous()
    scale = 1.0 / 255.0
    err = _check_warp(flat, H, (304, 304), f" (c5, {n} homographies)")
    cases = [_case(
        "warp", f"{tuple(flat.shape)} u8, {n} homographies → 304²×3", "c5",
        lambda: warp_kernel.warp_homography(flat, H, (304, 304), scale),
        lambda: warp_kernel.warp_homography_ref(flat, H, (304, 304), scale),
        err, bound_warp(flat, (304, 304)),
        library=lambda: grid_sample_case(flat, H, (304, 304), scale))]

    runs = _cuda_ms_runs(lambda: mesh._read_all_streams(frames, corners),
                         reps=20)
    med = _median(runs)
    print(f"times on {card}: c5 {med:.3f} ms [{runs[0]:.3f}, {runs[-1]:.3f}]"
          f" median [min, max] of 20 calls = {n / med * 1e3:.1f} frames/s "
          f"({C5_STREAMS} streams x {C5_PER_STREAM} x {FRAME_HW[0]}p)",
          flush=True)
    return {"launches": counts, "cases": cases, "ms": med,
            "fps": n / med * 1e3, "frames": frames, "corners": corners,
            "truth": truth}


def _streams_of(frames, corners):
    """A game's frames (N, H, W, 3) and corners (…, 4, 2) as seen by the
    ``MS_SHIFTS`` cameras: (frames (n, N, H, W, 3), corners (n, …, 4, 2)),
    numpy."""
    import numpy as np

    out = np.empty((len(MS_SHIFTS),) + frames.shape, np.uint8)
    for s, (dx, dy) in enumerate(MS_SHIFTS):
        _translate(frames, dx, dy, out[s])
    return out, np.stack([corners + np.array([dx, dy], np.float32)
                          for dx, dy in MS_SHIFTS])


def _ms_batches(frames):
    """(lo, n real frames, (n_streams, MS_BATCH, H, W, 3) tensor) per
    batch, the tail padded with repeats of its last frame."""
    import numpy as np
    import torch

    total = frames.shape[1]
    for lo in range(0, total, MS_BATCH):
        fb = frames[:, lo:lo + MS_BATCH]
        n = fb.shape[1]
        if n < MS_BATCH:
            fb = np.concatenate(
                [fb, np.repeat(fb[:, -1:], MS_BATCH - n, 1)], axis=1)
        yield lo, n, torch.from_numpy(np.ascontiguousarray(fb))


def phase_multistream(film: dict, handheld: dict, dev) -> dict:
    """The two stateful multi-stream entry points once each on 4 streams
    of the 720p games, batch by batch, with every synchronizing call an
    error from the second batch on: ``multistream_read_meta`` (the film
    game, fixed cameras) and ``multistream_track_read`` (the handheld
    game). Every stream reads its game; each stream equals the
    single-stream call on it; the tracked first batch also runs through
    ``device="cpu"``."""
    import numpy as np
    import torch

    from camkifu_tpu_torch.core.gamesync import MoveExtractor, score_moves
    from camkifu_tpu_torch.parallel import mesh
    from camkifu_tpu_torch.stone import sf_meta
    from camkifu_tpu_torch.utils.still import sample_moves

    n_s = len(MS_SHIFTS)
    t0 = time.perf_counter()
    film_f, film_c = _streams_of(film["frames"], film["corners"])
    hand_f, hand_c = _streams_of(handheld["frames"], handheld["truth"])
    seeds0 = _streams_of(handheld["frames"][:1], handheld["seed"])[1]
    t_prep = time.perf_counter() - t0

    def drive(fn, frames, state, key):
        """Every batch through ``fn(state, batch, key)`` → (state,
        labels, extra); sync debug mode "error" from the second on."""
        outs = []
        try:
            for lo, n, fb in _ms_batches(frames):
                fb = fb.to(dev)
                torch.cuda.synchronize()
                if lo:
                    torch.cuda.set_sync_debug_mode("error")
                state, labels, extra, key = fn(state, fb, key)
                torch.cuda.set_sync_debug_mode("default")
                outs.append((lo, n, labels, extra))
        finally:
            torch.cuda.set_sync_debug_mode("default")
        return outs

    def meta(state, fb, corners):
        state, labels, _, _ = mesh.multistream_read_meta(state, fb, corners)
        return state, labels, None, corners

    def track(state, fb, seeds):
        out = mesh.multistream_track_read(state, fb, seeds)
        return out[0], out[1], out[4], out[7]

    t0 = time.perf_counter()
    _reset_counts()
    meta_out = drive(meta, film_f, mesh.multistream_init_states(n_s,
                                                                device=dev),
                     torch.from_numpy(film_c).to(dev))
    track_out = drive(track, hand_f,
                      mesh.multistream_init_states(n_s, device=dev),
                      torch.from_numpy(seeds0).to(dev))
    torch.cuda.synchronize()
    counts = _read_counts()
    t_run = time.perf_counter() - t0
    n_meta, n_track = len(meta_out), len(track_out)

    film_moves = sample_moves(FILM_MOVES, seed=5)
    hand_moves = handheld["moves"]
    cell = float(np.linalg.norm(hand_c[0, 0, 1] - hand_c[0, 0, 0]) / 18)
    agree = {"meta": [], "track": []}
    err_cells = 0.0
    for name, outs, moves in (("meta", meta_out, film_moves),
                              ("track", track_out, hand_moves)):
        for s in range(n_s):
            ex = MoveExtractor()
            for lo, n, labels, cs in outs:
                for lab in labels[s, :n].cpu().numpy():
                    ex.advance(lab)
                if cs is not None:
                    err_cells = max(err_cells, float(np.abs(
                        cs[s, :n].cpu().numpy() - hand_c[s, lo:lo + n]).max())
                        / cell)
            agree[name].append(score_moves(ex.moves, moves)["agreement"])

    # Each stream alone through the single-stream entry points.
    t0 = time.perf_counter()
    d_px, same = 0.0, True
    for s in range(n_s):
        st = sf_meta.init_state(device=dev)
        c = torch.from_numpy(film_c[s]).to(dev)
        for (lo, n, fb), (_, _, labels, _) in zip(
                _ms_batches(film_f[s:s + 1]), meta_out):
            st, lab, _, _ = sf_meta.read_batch(st, fb[0].to(dev), c)
            same = same and torch.equal(lab, labels[s])
        st = sf_meta.init_state(device=dev)
        seed = torch.from_numpy(seeds0[s]).to(dev)
        for (lo, n, fb), (_, _, labels, cs) in zip(
                _ms_batches(hand_f[s:s + 1]), track_out):
            st, lab, _, _, cs_s, _, _, seed = sf_meta.track_read_batch(
                st, fb[0].to(dev), seed)
            same = same and torch.equal(lab, labels[s])
            d_px = max(d_px, float((cs_s - cs[s]).abs().max()))
    t_single = time.perf_counter() - t0

    # The tracked first batch through device="cpu".
    t0 = time.perf_counter()
    _, _, fb = next(_ms_batches(hand_f))
    out_c = mesh.multistream_track_read(
        mesh.multistream_init_states(n_s, device="cpu"), fb,
        torch.from_numpy(seeds0))
    _, _, lab_d, cs_d = track_out[0]
    d_cpu = float((out_c[4] - cs_d.cpu()).abs().max())
    same_cpu = torch.equal(out_c[1], lab_d.cpu())
    t_cpu = time.perf_counter() - t0

    print(f"multi-stream path: {n_s} streams of the {FILM_HW[0]}p film "
          f"game through multistream_read_meta and of the handheld game "
          f"through multistream_track_read, batches of {MS_BATCH}, "
          f"agreement {agree['meta']} / {agree['track']}, tracked corners "
          f"within {err_cells:.4f} cell of the truth (tol "
          f"{HANDHELD_TOL_CELLS}), no host wait from the second batch on, "
          f"each stream alone: labels {'equal' if same else 'DIFFER'}, "
          f"corners within {d_px:.2e} px (tol {MS_STREAM_TOL_PX}); "
          f"device=\"cpu\" on the first "
          f"batch: corners within {d_cpu:.4f} px (tol {TOL_CPU_PX}), labels "
          f"{'equal' if same_cpu else 'DIFFER'}; launches {counts} in "
          f"{n_meta} + {n_track} calls (prep {t_prep:.1f} s, run "
          f"{t_run:.1f} s, single streams {t_single:.1f} s, cpu "
          f"{t_cpu:.1f} s)", flush=True)
    _require(all(a == 1.0 for a in agree["meta"] + agree["track"]),
             "multi-stream: a stream's game was misread")
    _require(err_cells < HANDHELD_TOL_CELLS,
             "multi-stream: tracked corners off the truth")
    _require(same, "multi-stream: a stream differs from its single call")
    _require(d_px <= MS_STREAM_TOL_PX, "multi-stream: a stream's corners "
             "differ from its single call")
    _require(d_cpu < TOL_CPU_PX and same_cpu,
             "multi-stream: card and CPU disagree")
    _require(counts["warp"][0] == n_meta + n_track,
             "multi-stream: not one warp launch a batch for every stream")
    return {"launches": counts}


def phase_multistream_times(c5: dict, c4_track_ms: float, card: str) -> dict:
    """``multistream_track_read`` at full width (8 streams × 16 × 1080p,
    the c5 frames, each stream seeded on its own corners): one call under
    sync debug mode "error" and checked, the warp kernel at its canvas
    (128 frames, 8 homographies), then its CUDA-event time beside c4's
    ``track_read_batch`` at 128 × 1080p."""
    import numpy as np
    import torch

    from camkifu_tpu_torch.ops.cuda import warp_kernel
    from camkifu_tpu_torch.parallel import mesh

    frames, corners = c5["frames"], c5["corners"]
    states = mesh.multistream_init_states(C5_STREAMS, device=corners.device)
    mesh.multistream_track_read(states, frames, corners)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = mesh.multistream_track_read(states, frames, corners)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    truth = corners.cpu().numpy()
    cell = float(np.linalg.norm(truth[0, 1] - truth[0, 0]) / 18)
    err_cells = float(np.abs(out[4].cpu().numpy()
                             - truth[:, None]).max()) / cell
    sharp = float(out[5].min())
    print(f"multistream_track_read at full width: {tuple(frames.shape)}, "
          f"tracked corners within {err_cells:.4f} cell (tol "
          f"{HANDHELD_TOL_CELLS}), sharpness min {sharp:.3f}, no host wait",
          flush=True)
    _require(err_cells < HANDHELD_TOL_CELLS and bool(
        torch.isfinite(out[2]).all()), "multi-stream at full width: off")

    n = C5_STREAMS * C5_PER_STREAM
    flat = frames.reshape(n, *frames.shape[2:])
    H = _canvas_H(corners, 19)[:, None].expand(C5_STREAMS, C5_PER_STREAM, 3, 3) \
        .reshape(n, 3, 3).contiguous()
    scale = 1.0 / 255.0
    err = _check_warp(flat, H, (336, 336), " (multi-stream canvas)")
    cases = [_case(
        "warp", f"{tuple(flat.shape)} u8, {C5_STREAMS} homographies → "
        f"336²×3", "multi-stream canvas",
        lambda: warp_kernel.warp_homography(flat, H, (336, 336), scale),
        lambda: warp_kernel.warp_homography_ref(flat, H, (336, 336), scale),
        err, bound_warp(flat, (336, 336)),
        library=lambda: grid_sample_case(flat, H, (336, 336), scale))]

    runs = _cuda_ms_runs(lambda: mesh.multistream_track_read(
        states, frames, corners), reps=10)
    med = _median(runs)
    print(f"times on {card}: multistream_track_read {med:.3f} ms "
          f"[{runs[0]:.3f}, {runs[-1]:.3f}] median [min, max] of 10 calls = "
          f"{n / med * 1e3:.1f} frames/s ({C5_STREAMS} streams x "
          f"{C5_PER_STREAM} x {FRAME_HW[0]}p); c4's track_read_batch at "
          f"{C4_BATCH} x {FRAME_HW[0]}p {c4_track_ms:.3f} ms = "
          f"{C4_BATCH / c4_track_ms * 1e3:.1f} frames/s", flush=True)
    return {"cases": cases, "ms": med, "fps": n / med * 1e3}


def _lens_labels() -> "np.ndarray":
    """tests/test_lens_e2e.py's board: 60 stones, seed 13."""
    import numpy as np

    rng = np.random.default_rng(13)
    labels = np.zeros((19, 19), np.int8)
    idx = rng.choice(361, 60, replace=False)
    labels.flat[idx[:30]] = 1
    labels.flat[idx[30:]] = 2
    return labels


def _lens_stills(k1s, dev) -> dict:
    """{k1: (1080p frame on ``dev``, true raw corners)} of the lens board
    through each lens, rendered on threads."""
    from concurrent.futures import ThreadPoolExecutor

    import torch

    from camkifu_tpu_torch.utils.still import render_still

    labels = _lens_labels()
    with ThreadPoolExecutor(max_workers=len(k1s)) as pool:
        out = list(pool.map(lambda k: render_still(
            labels, frame_hw=FRAME_HW, seed=5, lens_k1=k,
            line_width=LENS_LINE_WIDTH), k1s))
    return {k: (torch.from_numpy(f).to(dev), c) for k, (f, c) in
            zip(k1s, out)}


def _lens_counts() -> int:
    from camkifu_tpu_torch.ops.cuda import warp_kernel

    return warp_kernel.lens_launches


def phase_lens(dev) -> dict:
    """The lens path once, counting launches: both calibrators on 1080p
    lens boards held to the truth, then the lens game, a seeded 10-move
    handheld game at 720p through k1 = 0.06: k1 calibrated on its first
    frame, the seed detected at that k1, then ``track_read_batch`` with the
    lens in batches of 16 (from the second batch any call that makes the
    host wait is an error) to its kifu; the same game tracked from its true
    first corners; its first frames through ``device="cpu"``; and,
    ungated, the same game read without the lens."""
    import numpy as np
    import torch

    from camkifu_tpu_torch.board import bf_auto
    from camkifu_tpu_torch.config import cvconf
    from camkifu_tpu_torch.core.gamesync import MoveExtractor, score_moves
    from camkifu_tpu_torch.ops.lens import make_lens
    from camkifu_tpu_torch.stone import sf_meta
    from camkifu_tpu_torch.utils.still import (handheld_corners, render_game,
                                                sample_moves)

    t0 = time.perf_counter()
    stills = _lens_stills(LENS_DETECT_K1 + LENS_CORNERS_K1 + (0.0,), dev)
    moves = sample_moves(HANDHELD_MOVES, seed=5)
    fpm = cvconf.vote_window + 3
    n_frames = 6 + HANDHELD_MOVES * fpm
    frames, truth = render_game(
        moves, fpm, frame_hw=HANDHELD_HW, seed=5, empty_leadin=6,
        corners=handheld_corners(n_frames, HANDHELD_HW),
        workers=HANDHELD_RENDER_THREADS, lens_k1=LENS_GAME_K1,
        line_width=LENS_LINE_WIDTH)
    t_render = time.perf_counter() - t0

    t0 = time.perf_counter()
    _reset_counts()
    cal = {}
    for k in LENS_DETECT_K1 + (0.0,):
        frame, gt = stills[k]
        est, gain = bf_auto.estimate_lens_k1(frame)
        corners, score, _ = bf_auto._detect_k1_probe(frame, est)
        cell = float(np.linalg.norm(gt[1] - gt[0]) / 18)
        err = float(np.abs(corners.cpu().numpy() - gt).max()) / cell
        cal[("detect", k)] = (est, gain, err)
    for k in LENS_CORNERS_K1 + (0.0,):
        frame, gt = stills[k]
        cal[("corners", k)] = bf_auto.estimate_lens_k1_corners(frame, gt) \
            + (0.0,)
    t_cal = time.perf_counter() - t0

    def batches():
        for lo in range(0, n_frames, HANDHELD_BATCH):
            fb = frames[lo:lo + HANDHELD_BATCH]
            n = fb.shape[0]
            if n < HANDHELD_BATCH:            # capture padding
                fb = np.concatenate(
                    [fb, np.repeat(fb[-1:], HANDHELD_BATCH - n, 0)])
            yield lo, n, torch.from_numpy(fb)

    def read_game(lens, seed, device):
        """The game through ``track_read_batch`` → (moves, corners, labels
        and corners of the batches below HANDHELD_CPU_FRAMES)."""
        state = sf_meta.init_state(device=device)
        ex = MoveExtractor()
        corners, first = [], {}
        try:
            for lo, n, fb in batches():
                if device == "cpu" and lo >= HANDHELD_CPU_FRAMES:
                    break
                fb = fb.to(device)
                if device != "cpu":
                    torch.cuda.synchronize()
                    if lo:
                        torch.cuda.set_sync_debug_mode("error")
                out = sf_meta.track_read_batch(state, fb, seed,
                                               chunk=C4_CHUNK, valid_count=n,
                                               lens=lens)
                torch.cuda.set_sync_debug_mode("default")
                state, labels, _, _, cs, _, _, seed = out
                if lo < HANDHELD_CPU_FRAMES:
                    first[lo] = (labels.cpu(), cs.cpu())
                corners.append(cs[:n].cpu().numpy())
                for lab in labels[:n].cpu().numpy():
                    ex.advance(lab)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        return ex.moves, np.concatenate(corners), first

    t0 = time.perf_counter()
    frame0 = torch.from_numpy(frames[0]).to(dev)
    k1, gain = bf_auto.estimate_lens_k1(frame0)
    seed0, score, _ = bf_auto._detect_k1_probe(frame0, k1)
    lens = make_lens(k1, HANDHELD_HW)
    game_moves, tracked, first = read_game(lens, seed0, dev)
    torch.cuda.synchronize()
    counts = _read_counts()
    lens_warps = _lens_counts()
    t_run = time.perf_counter() - t0

    report = score_moves(game_moves, moves)
    cell = float(np.linalg.norm(truth[0][1] - truth[0][0]) / 18)
    seed_cells = float(np.abs(seed0.cpu().numpy() - truth[0]).max()) / cell
    err_cells = float(np.abs(tracked - truth).max()) / cell
    # The same game tracked from its true first corners, as the
    # reference's tracking tests seed it (tests/test_tracking.py): the
    # probe seed's own error rides on every frame of the run above, which
    # is held as the reference holds an imperfect seed (its error must not
    # grow by more than the tolerance).
    _, from_truth, _ = read_game(lens, torch.from_numpy(truth[0]).to(dev),
                                 dev)
    true_cells = float(np.abs(from_truth - truth).max()) / cell
    for (how, k), (est, g, err) in cal.items():
        tol = LENS_DETECT_TOL if how == "detect" else LENS_CORNERS_TOL
        exact = ", exactly 0" if k == 0 else ""
        print(f"lens calibration by {how} on a {FRAME_HW[0]}p board through "
              f"k1 = {k}: k1 {est} (tol {tol}{exact}), gain {g:.4f}"
              + (f", probe corners within {err:.4f} cell (tol "
                 f"{HANDHELD_TOL_CELLS})" if how == "detect" else ""),
              flush=True)
        if k == 0.0:
            _require(est == 0.0, f"lens: a phantom lens by {how}")
        else:
            _require(abs(est - k) < tol, f"lens: k1 by {how} off the truth")
        if how == "detect" and k != 0.0:
            _require(err < HANDHELD_TOL_CELLS,
                     "lens: the k1 probe's corners off the truth")
        if how == "corners" and k != 0.0:
            _require(g > bf_auto.K1_CAL_MARGIN, "lens: gain under the margin")
    print(f"lens game: {n_frames} frames {HANDHELD_HW[0]}p through k1 = "
          f"{LENS_GAME_K1}, calibrated k1 {k1} (gain {gain:.4f}), seed score "
          f"{float(score):.4f}, seed {seed_cells:.4f} cell off the truth, "
          f"{report['good']}/{report['ref_moves']} moves right, agreement "
          f"{report['agreement']}, tracked corners within {err_cells:.4f} "
          f"cell of the truth (tol seed + {HANDHELD_TOL_CELLS}), from the "
          f"true first corners within {true_cells:.4f} cell (tol "
          f"{HANDHELD_TOL_CELLS}), no host wait in track_read_batch from the "
          f"second batch on, launches {counts}, {lens_warps} in lens mode "
          f"(render {t_render:.1f} s, calibrations {t_cal:.1f} s, game "
          f"{t_run:.1f} s)", flush=True)
    _require(abs(k1 - LENS_GAME_K1) < LENS_DETECT_TOL,
             "lens game: k1 off the truth")
    _require(seed_cells < HANDHELD_TOL_CELLS,
             "lens game: the probe's seed off the truth")
    _require(report["agreement"] == 1.0, "the lens game was misread")
    _require(true_cells < HANDHELD_TOL_CELLS,
             "lens game: tracked corners off the truth")
    _require(err_cells < seed_cells + HANDHELD_TOL_CELLS,
             "lens game: the seed's error grew while tracking")
    _require_launched(counts, "lens")
    _require(lens_warps > 0, "the warp kernel never ran in lens mode")

    # The first frames through device="cpu", the same lens and seed.
    t0 = time.perf_counter()
    _, _, first_c = read_game(lens, seed0.cpu(), "cpu")
    d_px = max(float((first_c[lo][1] - first[lo][1]).abs().max())
               for lo in first_c)
    same = all(torch.equal(first_c[lo][0], first[lo][0]) for lo in first_c)
    print(f"lens game, device=\"cpu\" on the first {HANDHELD_CPU_FRAMES} "
          f"frames: corners within {d_px:.4f} px of the card's (tol "
          f"{TOL_CPU_PX}), labels {'equal' if same else 'DIFFER'} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    _require(d_px < TOL_CPU_PX, "lens game: card and CPU corners disagree")
    _require(same, "lens game: card and CPU labels disagree")

    # Ungated: the same game without the lens, seeded by plain detection.
    plain_seed, _ = bf_auto.detect_corners(frame0)
    plain_moves, plain_tracked, _ = read_game(None, plain_seed, dev)
    plain_report = score_moves(plain_moves, moves)
    seed_off = float(np.abs(plain_seed.cpu().numpy() - truth[0]).max())
    print(f"lens game read WITHOUT the lens (not gated): agreement "
          f"{plain_report['agreement']}, tracked corners within "
          f"{float(np.abs(plain_tracked - truth).max()) / cell:.4f} cell of "
          f"the truth, seed {seed_off / cell:.4f} cell off", flush=True)
    return {"launches": counts, "lens_launches": lens_warps,
            "frames": frames, "truth": truth, "stills": stills, "k1": k1,
            "moves": moves}


def phase_lens_multistream(lens_run: dict, dev) -> dict:
    """The lens game's first frames seen by four cameras, each its own
    lens (``LENS_MS_K1``), through ``multistream_track_read`` with one
    stacked lens made once, in batches of 16 with every synchronizing call
    an error from the second batch on: one warp launch a batch, in lens
    mode, for every stream; each stream against the single-stream call
    with its own lens."""
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    import torch

    from camkifu_tpu_torch.config import cvconf
    from camkifu_tpu_torch.ops.lens import make_lens, stack_lenses
    from camkifu_tpu_torch.parallel import mesh
    from camkifu_tpu_torch.stone import sf_meta
    from camkifu_tpu_torch.utils.still import (handheld_corners, render_game,
                                                sample_moves)

    t0 = time.perf_counter()
    n = LENS_MS_FRAMES
    fpm = cvconf.vote_window + 3
    moves = sample_moves(-(-(n - 6) // fpm), seed=5)
    pin = handheld_corners(6 + len(moves) * fpm, HANDHELD_HW)

    def render(k):
        if k == LENS_GAME_K1:
            return lens_run["frames"][:n], lens_run["truth"][:n]
        f, c = render_game(moves, fpm, frame_hw=HANDHELD_HW, seed=5,
                           empty_leadin=6, corners=pin, workers=2,
                           lens_k1=k, line_width=LENS_LINE_WIDTH)
        return f[:n], c[:n]

    with ThreadPoolExecutor(max_workers=len(LENS_MS_K1)) as pool:
        out = list(pool.map(render, LENS_MS_K1))
    frames = np.stack([f for f, _ in out])
    truth = np.stack([c for _, c in out])
    lenses = [make_lens(k, HANDHELD_HW) for k in LENS_MS_K1]
    stacked = stack_lenses(lenses, dev)
    seeds0 = torch.from_numpy(truth[:, 0]).to(dev)
    t_render = time.perf_counter() - t0

    t0 = time.perf_counter()
    _reset_counts()
    states = mesh.multistream_init_states(len(lenses), device=dev)
    seeds = seeds0
    outs = []
    try:
        for lo, nb, fb in _ms_batches(frames):
            fb = fb.to(dev)
            torch.cuda.synchronize()
            if lo:
                torch.cuda.set_sync_debug_mode("error")
            res = mesh.multistream_track_read(states, fb, seeds,
                                              lenses=stacked)
            torch.cuda.set_sync_debug_mode("default")
            states, labels, seeds = res[0], res[1], res[7]
            outs.append((labels, res[4]))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    counts = _read_counts()
    lens_warps = _lens_counts()
    t_run = time.perf_counter() - t0

    d_px, same = 0.0, True
    for s, ln in enumerate(lenses):
        st = sf_meta.init_state(device=dev)
        seed = seeds0[s]
        for (lo, nb, fb), (labels, cs) in zip(
                _ms_batches(frames[s:s + 1]), outs):
            st, lab, _, _, cs_s, _, _, seed = sf_meta.track_read_batch(
                st, fb[0].to(dev), seed, lens=ln)
            same = same and torch.equal(lab, labels[s])
            d_px = max(d_px, float((cs_s - cs[s]).abs().max()))
    cell = float(np.linalg.norm(truth[0, 0, 1] - truth[0, 0, 0]) / 18)
    err_cells = max(float(np.abs(cs[:, :nb].cpu().numpy()
                                 - truth[:, lo:lo + nb]).max()) / cell
                    for (lo, nb, _), (_, cs) in zip(_ms_batches(frames),
                                                    outs))
    print(f"lens multi-stream: {len(lenses)} cameras with k1 {LENS_MS_K1} "
          f"on {n} frames {HANDHELD_HW[0]}p through multistream_track_read"
          f"(lenses=stack_lenses(...)), batches of {MS_BATCH}, no host wait "
          f"from the second batch on, tracked corners within "
          f"{err_cells:.4f} cell of the truth (tol {HANDHELD_TOL_CELLS}), "
          f"each stream alone: labels {'equal' if same else 'DIFFER'}, "
          f"corners within {d_px:.2e} px (tol {LENS_MS_STREAM_TOL_PX}); "
          f"launches "
          f"{counts}, {lens_warps} in lens mode in {len(outs)} calls (render "
          f"{t_render:.1f} s, run {t_run:.1f} s)", flush=True)
    _require(same, "lens multi-stream: a stream differs from its single call")
    _require(d_px <= LENS_MS_STREAM_TOL_PX, "lens multi-stream: a "
             "stream's corners differ from its single call")
    _require(err_cells < HANDHELD_TOL_CELLS,
             "lens multi-stream: tracked corners off the truth")
    _require(counts["warp"][0] == len(outs) and lens_warps == len(outs),
             "lens multi-stream: not one lens-mode warp a batch for every "
             "stream")
    return {"launches": counts, "lens_launches": lens_warps}


def phase_lens_kernels(lens_run: dict, dev) -> list[dict]:
    """The warp's lens mode against its plain version at the lens paths'
    shapes: a 1080p RGB frame undistorted, the known-corner calibration's
    513² gray rect, the tracker's canvas (16 × 1080p → 336²) with one
    shared lens and with a lens a stream (4 streams × 16); then the edge,
    hysteresis and Hough kernels at the calibration's res 512 (N = 2,
    B = 1) on the undistorted 1080p frame."""
    import numpy as np
    import torch

    from camkifu_tpu_torch.board.bf_auto import _detect_prepare, \
        resize_bilinear
    from camkifu_tpu_torch.ops.color import rgb_to_gray_u8
    from camkifu_tpu_torch.ops.cuda import hough_kernel, warp_kernel
    from camkifu_tpu_torch.ops.edges import edge_map
    from camkifu_tpu_torch.ops.hough import topk_edge_points
    from camkifu_tpu_torch.ops.lens import as_table, make_lens, \
        stack_lenses, undistort_frame, undistort_pts
    from camkifu_tpu_torch.ops.warp import canonical_corners, homography_dlt

    frame, gt = lens_run["stills"][LENS_DETECT_K1[0]]
    lens = make_lens(LENS_DETECT_K1[0], FRAME_HW)
    shared = tuple(lens)
    truth = torch.from_numpy(gt).to(dev)
    pin = undistort_pts(lens, truth)
    canvas = _canvas_H(pin, 19).contiguous()
    n_s = len(LENS_MS_K1)
    ms_lenses = [make_lens(k, FRAME_HW) for k in LENS_MS_K1]
    table = as_table(stack_lenses(ms_lenses, dev))[:, None] \
        .expand(n_s, C4_CHUNK, 5).reshape(-1, 5).contiguous()
    ms_H = torch.stack([_canvas_H(undistort_pts(ln, truth), 19)
                        for ln in ms_lenses])[:, None] \
        .expand(n_s, C4_CHUNK, 3, 3).reshape(-1, 3, 3).contiguous()
    one = frame[None].contiguous()
    gray = rgb_to_gray_u8(frame)[None, :, :, None].contiguous()
    many = frame[None].expand(C4_CHUNK, *frame.shape).contiguous()
    shapes = (
        ("lens undistort", one, torch.eye(3, device=dev), FRAME_HW, 1.0,
         shared),
        ("lens calibration rect", gray,
         homography_dlt(canonical_corners(19, 27, dev), pin), (513, 513),
         1.0 / 255.0, shared),
        ("lens canvas", many, canvas, (336, 336), 1.0 / 255.0, shared),
        ("lens multi-stream canvas",
         many.repeat(n_s, 1, 1, 1), ms_H, (336, 336), 1.0 / 255.0, table),
    )
    cases = []
    for path, x, H, hw, sc, ln in shapes:
        H = H.contiguous()
        err = _check_warp(x, H, hw, f" ({path})", lens=ln, scale=sc)
        n_h = "" if H.ndim == 2 else f", {int(H.shape[0] // C4_CHUNK)} lenses"
        cases.append(_case(
            "warp", f"{tuple(x.shape)} u8{n_h} → {hw[0]}×{hw[1]}×"
            f"{x.shape[-1]}, lens", path,
            lambda x=x, H=H, hw=hw, sc=sc, ln=ln: warp_kernel.warp_homography(
                x, H, hw, sc, ln),
            lambda x=x, H=H, hw=hw, sc=sc, ln=ln:
                warp_kernel.warp_homography_ref(x, H, hw, sc, ln),
            err, bound_warp(x, hw, lens=True),
            library=lambda x=x, H=H, hw=hw, sc=sc, ln=ln: grid_sample_case(
                x, H, hw, sc, ln)))
    got = undistort_frame(frame, lens)
    _require(got.dtype == torch.uint8 and got.shape == frame.shape,
             "undistort_frame: wrong output")

    # Stage 1 of a k1 probe: res 512 on the undistorted frame.
    f0 = got
    small = resize_bilinear(rgb_to_gray_u8(f0).float() / 255.0, (512, 512))
    chroma = resize_bilinear((f0[..., 0].float() - f0[..., 2].float())
                             / 255.0, (512, 512))
    x = torch.stack([small, chroma]).contiguous()
    cases += _edge_cases(x, "lens calibration", " at res 512")
    pts, wts = topk_edge_points(edge_map(small))
    rho_max = float(np.hypot(512, 512))
    cases.append(_case(
        "hough", f"B = 1, K = {pts.shape[-2]} → 128 × 256, res 512",
        "lens calibration",
        lambda: hough_kernel.hough_accumulate(pts, wts, rho_max, 128, 256),
        lambda: hough_kernel.hough_accumulate_ref(pts, wts, rho_max, 128,
                                                  256),
        _check_hough(pts, wts, rho_max, " at res 512"),
        bound_hough(pts, wts)))
    _, _, score = _detect_prepare(f0, 512)
    _require(float(score) > 0.5, "lens: stage 1 at res 512 found no board")
    return cases


def phase_lens_times(lens_run: dict, card: str) -> dict:
    """c4's shape through the lens, 128 × 1080p at chunk 16: the lens
    board drifting ±3 px over 8 renders, tiled. One call checked against
    the truth, then CUDA-event times of ``track_read_batch`` with the lens
    and without it on the same frames, in turns, and of both calibrators
    at 1080p."""
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    import torch

    from camkifu_tpu_torch.board import bf_auto
    from camkifu_tpu_torch.ops.lens import make_lens
    from camkifu_tpu_torch.stone import sf_meta
    from camkifu_tpu_torch.utils.still import default_corners, render_still

    frame0, gt0 = lens_run["stills"][LENS_GAME_K1]
    dev = frame0.device
    labels = _lens_labels()
    base = default_corners(FRAME_HW)

    def render(i):
        c = base + np.array([REDETECT_DRIFT * np.sin(i / 2.0),
                             REDETECT_DRIFT * np.cos(i / 3.0)], np.float32)
        return render_still(labels, frame_hw=FRAME_HW, seed=i, corners=c,
                            lens_k1=LENS_GAME_K1, line_width=LENS_LINE_WIDTH)

    with ThreadPoolExecutor(max_workers=REDETECT_RENDERS) as pool:
        out = list(pool.map(render, range(REDETECT_RENDERS)))
    reps = C4_BATCH // REDETECT_RENDERS
    frames = torch.stack([torch.from_numpy(f).to(dev) for f, _ in out]
                         * reps)
    truth = np.stack([c for _, c in out] * reps)
    lens = make_lens(LENS_GAME_K1, FRAME_HW)
    state0 = sf_meta.init_state(device=dev)
    seed = torch.from_numpy(truth[0]).to(dev)
    res = sf_meta.track_read_batch(state0, frames, seed, chunk=C4_CHUNK,
                                   lens=lens)
    torch.cuda.synchronize()
    cell = float(np.linalg.norm(truth[0][1] - truth[0][0]) / 18)
    err_cells = float(np.abs(res[4].cpu().numpy() - truth).max()) / cell
    read = torch.equal(res[1][-1].cpu(), torch.from_numpy(labels))
    print(f"c4's shape through the lens: {tuple(frames.shape)}, k1 "
          f"{LENS_GAME_K1}, tracked corners within {err_cells:.4f} cell of "
          f"the truth (tol {HANDHELD_TOL_CELLS}), board "
          f"{'read' if read else 'MISREAD'}", flush=True)
    _require(err_cells < HANDHELD_TOL_CELLS,
             "c4 through the lens: tracked corners off the truth")
    _require(read, "c4 through the lens: the board was misread")

    def track(ln):
        return lambda: sf_meta.track_read_batch(state0, frames, seed,
                                                chunk=C4_CHUNK, lens=ln)

    runs = {"track_read no lens": _cuda_ms_runs(track(None), reps=10),
            "track_read lens": _cuda_ms_runs(track(lens), reps=10)}
    runs["track_read lens"] += _cuda_ms_runs(track(lens), reps=10)
    runs["track_read no lens"] += _cuda_ms_runs(track(None), reps=10)
    runs = {k: sorted(v) for k, v in runs.items()}
    runs["estimate_lens_k1"] = _cuda_ms_runs(
        lambda: bf_auto.estimate_lens_k1(frame0), reps=5, warmup=1)
    runs["estimate_lens_k1_corners"] = _cuda_ms_runs(
        lambda: bf_auto.estimate_lens_k1_corners(frame0, gt0), reps=5,
        warmup=1)
    med = {k: _median(v) for k, v in runs.items()}
    print(f"times on {card}, median [min, max] (20 calls, in turns no lens /"
          f" lens / lens / no lens, for track_read_batch at {C4_BATCH} x "
          f"{FRAME_HW[0]}p; 5 for the calibrators at {FRAME_HW[0]}p): "
          + ", ".join(f"{k} {med[k]:.3f} ms [{v[0]:.3f}, {v[-1]:.3f}]"
                      for k, v in runs.items())
          + f"; lens / no lens "
          f"{med['track_read lens'] / med['track_read no lens']:.3f}",
          flush=True)
    return {"ms": med}


def _render_frames(specs) -> list:
    """720p frames of (labels, pinhole corners, noise seed) specs, rendered
    on threads."""
    from concurrent.futures import ThreadPoolExecutor

    from camkifu_tpu_torch.utils.still import render_still

    with ThreadPoolExecutor(max_workers=HANDHELD_RENDER_THREADS) as pool:
        return list(pool.map(lambda s: render_still(
            s[0], frame_hw=HANDHELD_HW, seed=s[2], corners=s[1])[0], specs))


def _turned(corners, deg: float):
    """``corners`` turned by ``deg`` degrees about their center."""
    import numpy as np

    ctr = corners.mean(axis=0)
    th = np.deg2rad(deg)
    rot = np.array([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]],
                   np.float32)
    return (ctr + (corners - ctr) @ rot.T).astype(np.float32)


def _moves_of(moves) -> list:
    return [(m.color, m.row, m.col) for m in moves]


def _runtime_vm(frames, dev, sgf=None, lens_checked=False):
    """The stack of ``filecheck.run_runtime`` over ``frames`` on ``dev``
    (resumed from ``sgf``), instrumented: after each batch it records both
    finders' metadata, the published per-frame corners and the labels
    diffed into moves. → (controller, manager, records)."""
    import numpy as np

    from camkifu_tpu_torch.board.bf_auto import BoardFinderAuto
    from camkifu_tpu_torch.core.capture import ArrayCapture
    from camkifu_tpu_torch.core.controllerv import ControllerVSeq
    from camkifu_tpu_torch.core.vmanager import VManagerSeq
    from camkifu_tpu_torch.stone.sf_meta import SfMeta

    controller = ControllerVSeq(sgffile=sgf)
    vm = VManagerSeq(controller, video=None, bf_class=BoardFinderAuto,
                     sf_class=SfMeta, batch=RUNTIME_BATCH, device=dev)
    vm.capture = ArrayCapture(frames)
    vm.instantiate_finders()
    vm.board_finder._lens_checked = lens_checked
    records, held = [], {}
    sf, bf = vm.stones_finder, vm.board_finder
    consume, record = sf._consume, vm.stats.record

    def spy_consume(labels, n):
        held["labels"] = np.array(labels)[:n]
        return consume(labels, n)

    def spy_record(n, **fields):
        cb = bf.corners_batch
        records.append({"bf": dict(bf.metadata), "sf": dict(fields),
                        "corners": None if cb is None else np.array(cb),
                        "labels": held.pop("labels", None)})
        return record(n, **fields)

    sf._consume, vm.stats.record = spy_consume, spy_record
    return controller, vm, records


def _runtime_session(frames, dev, sgf=None, lens_checked=False):
    """``_runtime_vm`` run to the end of ``frames``."""
    import torch

    controller, vm, records = _runtime_vm(frames, dev, sgf, lens_checked)
    t0 = time.perf_counter()
    vm.run()
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()
    return controller, vm, records, time.perf_counter() - t0


def _threaded_session(frames, dev):
    """The threaded ``VManager`` (its ``DeviceFeeder`` on a side CUDA
    stream) over ``frames``, started with ``vision_on`` and joined at the
    end of the stream. → (controller, manager, error events, seconds)."""
    from camkifu_tpu_torch.board.bf_auto import BoardFinderAuto
    from camkifu_tpu_torch.core.capture import ArrayCapture
    from camkifu_tpu_torch.core.controllerv import ControllerV
    from camkifu_tpu_torch.core.vmanager import VManager
    from camkifu_tpu_torch.stone.sf_meta import SfMeta

    controller = ControllerV()
    errors = []
    controller.listeners.append(
        lambda event, *args: errors.append(args) if event == "error"
        else None)
    vm = VManager(controller, video=None, bf_class=BoardFinderAuto,
                  sf_class=SfMeta, batch=RUNTIME_BATCH, device=dev)
    vm.capture = ArrayCapture(frames)
    vm.init_capture = lambda: None           # keep the given capture
    t0 = time.perf_counter()
    vm.vision_on()
    deadline = t0 + 600
    while vm.is_running() and time.perf_counter() < deadline:
        controller.process_pipe()
        time.sleep(0.005)
    dt = time.perf_counter() - t0
    running = vm.is_running()
    vm.vision_off()
    controller.process_pipe()
    _require(not running, "threaded runtime: the worker did not finish")
    return controller, vm, errors, dt


def _next_legal(moves, board):
    """tests/test_pose_veto.py's next move: the first empty point, in
    order, where the side to play may legally put a stone. → (move, the
    board after it)."""
    from camkifu_tpu_torch.gamemodel.move import B, W, Move
    from camkifu_tpu_torch.gamemodel.rules import IllegalMove, RuleUnsafe

    rule = RuleUnsafe(gsize=19)
    for m in moves:
        rule.put(m)
        rule.confirm()
    color = B if moves[-1].color == W else W
    for r in range(19):
        for c in range(19):
            if board[r, c] != 0:
                continue
            cand = Move("np", (color, r, c), gsize=19)
            try:
                rule.put(cand)
            except IllegalMove:
                continue
            rule.confirm()
            return cand, rule.as_labels()
    raise SmokeFailure("pose veto: no legal move left")


def phase_runtime(handheld: dict, lens_run: dict, dev) -> dict:
    """The vision runtime on the card: the handheld game through
    ``filecheck.run_runtime``'s stack (the path's kernel launches counted
    around it), a camera bump, both pose-veto scenarios, the lens game
    (k1 calibrated at the first anchor), the threaded ``VManager`` with
    its CUDA-stream feeder, and the handheld game's first batches through
    ``device="cpu"``."""
    import os
    import tempfile

    import numpy as np
    import torch

    from camkifu_tpu_torch.config import cvconf
    from camkifu_tpu_torch.core.gamesync import score_moves
    from camkifu_tpu_torch.gamemodel.kifu import Kifu
    from camkifu_tpu_torch.ops.cuda import warp_kernel
    from camkifu_tpu_torch.utils.still import (default_corners, game_states,
                                                sample_moves)

    frames = list(handheld["frames"])
    truth = _moves_of(handheld["moves"])
    t0 = time.perf_counter()
    _reset_counts()
    ctrl, vm, recs, dt = _runtime_session(frames, dev)
    counts = _read_counts()
    got = _moves_of(ctrl.kifu.moves())
    bf = vm.board_finder
    cb = bf.corners_batch
    report = score_moves(ctrl.kifu.moves(), handheld["moves"])
    print(f"runtime, handheld game: {len(frames)} frames {HANDHELD_HW[0]}p "
          f"through VManagerSeq + BoardFinderAuto + SfMeta in batches of "
          f"{RUNTIME_BATCH}, {report['good']}/{report['ref_moves']} moves "
          f"right, agreement {report['agreement']}, lens_k1 "
          f"{bf.metadata.get('lens_k1')}, corners_batch "
          f"{None if cb is None else cb.shape}, trips "
          f"{[r['bf'].get('track_trip') for r in recs]}, launches {counts} "
          f"({dt:.2f} s)", flush=True)
    _require(got == truth, "runtime: the handheld game was misread")
    _require(bf.metadata.get("lens_k1") == 0.0,
             "runtime: a lens on the pinhole handheld game")
    _require(cb is not None and cb.shape == (RUNTIME_BATCH, 4, 2),
             "runtime: no per-frame corners published")
    _require_launched(counts, "runtime")
    card_recs = recs

    # A camera bump mid-game.
    bmoves = sample_moves(BUMP_MOVES, seed=BUMP_SEED)
    states = list(game_states(bmoves))
    base = default_corners(HANDHELD_HW)
    bumped = _turned(base, BUMP_TURN_DEG) + np.float32(BUMP_SHIFT)
    fpm = cvconf.vote_window + 3
    specs = []

    def emit(labels, corners, n):
        for _ in range(n):
            specs.append((labels, corners, BUMP_SEED + len(specs)))

    emit(np.zeros((19, 19), np.int8), base, 6)
    for labels in states[:3]:                 # a steady camera
        emit(labels, base, fpm)
    emit(states[2], bumped, 32)               # the knock, then a pause
    for labels in states[3:]:                 # the new pose
        emit(labels, bumped, fpm)
    emit(states[-1], bumped, 12)
    ctrl, vm, recs, dt = _runtime_session(_render_frames(specs), dev)
    trips = [r["bf"].get("track_trip") for r in recs]
    print(f"runtime, camera bump ({BUMP_TURN_DEG}° and {BUMP_SHIFT} px "
          f"after move 3): {len(specs)} frames, moves "
          f"{'all read' if _moves_of(ctrl.kifu.moves()) == _moves_of(bmoves) else 'MISREAD'}"
          f" ({len(ctrl.kifu)}/{len(bmoves)}), trips per batch {trips} "
          f"({dt:.2f} s)", flush=True)
    _require(_moves_of(ctrl.kifu.moves()) == _moves_of(bmoves),
             "runtime: a move was lost around the camera bump")
    _require("jump" in trips, "runtime: the bump did not trip the tracker")

    # The pose veto: a saturated game resumed from its SGF.
    vmoves = sample_moves(VETO_MOVES, seed=VETO_SEED)
    final = list(game_states(vmoves))[-1]
    nxt, after = _next_legal(vmoves, final)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "late.sgf")
        kifu = Kifu.new(path)
        for m in vmoves:
            kifu.append(m)
        kifu.save()
        turned = _render_frames([(final, _turned(base, VETO_TURN_DEG),
                                  70 + i) for i in range(VETO_FRAMES)])
        ctrl, vm, recs, dt = _runtime_session(turned, dev, sgf=path)
        vetoed = (_moves_of(ctrl.kifu.moves()) == _moves_of(vmoves),
                  vm.board_finder.metadata.get("track_trip"),
                  vm.board_finder.ready())
        frames_b = _render_frames(
            [(final, base, 70 + i) for i in range(16)]
            + [(after, base, 170 + i)
               for i in range(cvconf.vote_window + 19)])
        ctrl, vm, recs, dt_b = _runtime_session(frames_b, dev, sgf=path)
        accepted = (_moves_of(ctrl.kifu.moves())
                    == _moves_of(vmoves) + _moves_of([nxt]),
                    vm.board_finder.metadata.get("track_trip"),
                    vm.board_finder.ready())
    print(f"runtime, pose veto on a {VETO_MOVES}-move game resumed from its "
          f"SGF: turned {VETO_TURN_DEG}° → kifu "
          f"{'unchanged' if vetoed[0] else 'CHANGED'}, trip {vetoed[1]}, "
          f"board finder ready {vetoed[2]} ({dt:.2f} s); unturned with one "
          f"more move → {'appended' if accepted[0] else 'NOT APPENDED'}, "
          f"trip {accepted[1]}, ready {accepted[2]} ({dt_b:.2f} s)",
          flush=True)
    _require(vetoed == (True, "pose_veto", False),
             "runtime: the turned camera's pose was not vetoed")
    _require(accepted[0] and accepted[1] != "pose_veto" and accepted[2],
             "runtime: the consistent pose was refused")

    # The lens game: k1 calibrated at the first anchor.
    lens_frames = list(lens_run["frames"])
    lens_before = warp_kernel.lens_launches
    ctrl, vm, recs, dt = _runtime_session(lens_frames, dev)
    lens_warps = warp_kernel.lens_launches - lens_before
    k1 = vm.board_finder.metadata.get("lens_k1")
    lens_ok = _moves_of(ctrl.kifu.moves()) == _moves_of(lens_run["moves"])
    print(f"runtime, lens game (k1 = {LENS_GAME_K1}): calibrated k1 {k1} at "
          f"the first anchor (tol {LENS_DETECT_TOL}), moves "
          f"{'all read' if lens_ok else 'MISREAD'}, {lens_warps} warp "
          f"launches in lens mode ({dt:.2f} s)", flush=True)
    _require(k1 is not None and abs(k1 - LENS_GAME_K1) < LENS_DETECT_TOL,
             "runtime: the lens was not calibrated at the first anchor")
    _require(lens_ok, "runtime: the lens game was misread")
    _require(lens_warps > 0, "runtime: the warp never ran in lens mode")

    # The threaded manager.
    ctrl, vm, errors, dt = _threaded_session(frames, dev)
    same = _moves_of(ctrl.kifu.moves()) == truth
    print(f"runtime, threaded VManager with the CUDA-stream feeder: "
          f"{'the same kifu' if same else 'ANOTHER KIFU'}, errors {errors} "
          f"({dt:.2f} s)", flush=True)
    _require(not errors, "threaded runtime: the worker reported an error")
    _require(same, "threaded runtime: another kifu than the sequential one")

    # The first batches through device="cpu". The card's run calibrated
    # k1 = 0.0 (gated above), which changes nothing downstream, so the CPU
    # run skips the calibration.
    n_cpu = HANDHELD_CPU_FRAMES // RUNTIME_BATCH
    _, _, cpu_recs, dt = _runtime_session(frames[:HANDHELD_CPU_FRAMES],
                                          "cpu", lens_checked=True)
    d_px, same = 0.0, len(cpu_recs) == n_cpu
    for c, d in zip(cpu_recs, card_recs[:n_cpu]):
        if (c["corners"] is None) != (d["corners"] is None):
            same = False
        elif c["corners"] is not None:
            d_px = max(d_px, float(np.abs(c["corners"] - d["corners"]).max()))
        same = same and all(
            c[k].get(f) == d[k].get(f)
            for k, f in (("sf", "status"), ("bf", "track_trip")))
        same = same and (c["labels"] is None) == (d["labels"] is None) and (
            c["labels"] is None or np.array_equal(c["labels"], d["labels"]))
    print(f"runtime, device=\"cpu\" on the first {HANDHELD_CPU_FRAMES} "
          f"frames: corners within {d_px:.4f} px of the card's (tol "
          f"{TOL_CPU_PX}), labels and records "
          f"{'equal' if same else 'DIFFER'} ({dt:.1f} s)", flush=True)
    _require(d_px < TOL_CPU_PX, "runtime: card and CPU corners disagree")
    _require(same, "runtime: card and CPU labels or records disagree")
    print(f"runtime phase checks {time.perf_counter() - t0:.1f} s",
          flush=True)
    return {"launches": counts, "lens_launches": lens_warps}


def phase_runtime_kernels(game: dict, lens_game: dict, dev) -> list[dict]:
    """Each kernel against its plain version at the runtime's 720p shapes
    that no earlier phase checks: ``BoardFinderAuto._detect``'s sample of
    4 frames of a batch (edge and hysteresis at N = 8, Hough at B = 4, the
    shared gray rect 4 × 720p → 320²), the fused tracker's canvas (16 ×
    720p RGB → 336²), and through the lens game's k1 the sample's
    undistort (4 × 720p RGB), the lens canvas, and the first anchor's
    calibration probes: ``_detect_k1_probe``'s undistort of one 720p RGB
    frame and ``_corners_bow_probe``'s 513² rect of a 720p gray frame."""
    import numpy as np
    import torch

    from camkifu_tpu_torch.board.bf_auto import (REFINE_RES,
                                                  _detect_prepare_batch,
                                                  _rect_H, resize_bilinear)
    from camkifu_tpu_torch.ops.color import rgb_to_gray_u8
    from camkifu_tpu_torch.ops.cuda import hough_kernel, warp_kernel
    from camkifu_tpu_torch.ops.edges import edge_map_batch
    from camkifu_tpu_torch.ops.hough import topk_edge_points
    from camkifu_tpu_torch.ops.lens import make_lens, undistort_pts
    from camkifu_tpu_torch.ops.warp import canonical_corners, homography_dlt

    step = RUNTIME_BATCH // 4
    frames = torch.from_numpy(game["frames"][:RUNTIME_BATCH]).to(dev)
    sample = frames[::step][:4].contiguous()
    lframes = torch.from_numpy(lens_game["frames"][:RUNTIME_BATCH]).to(dev)
    lsample = lframes[::step][:4].contiguous()
    lens = tuple(make_lens(LENS_GAME_K1, HANDHELD_HW))
    grays, quads, _ = _detect_prepare_batch(sample, 256)
    rect_H = _rect_H(torch.quantile(quads, 0.5, dim=0), 0.10, REFINE_RES)
    seed = torch.from_numpy(game["truth"][0]).to(dev)
    pin = undistort_pts(make_lens(LENS_GAME_K1, HANDHELD_HW),
                        torch.from_numpy(lens_game["truth"][0]).to(dev))
    lgray = rgb_to_gray_u8(lframes[0])[None, :, :, None].contiguous()
    scale = 1.0 / 255.0
    shapes = (
        ("runtime detection rect", grays[..., None].contiguous(), rect_H,
         (REFINE_RES,) * 2, scale, None),
        ("runtime canvas", frames, _canvas_H(seed, 19), (336, 336), scale,
         None),
        ("runtime lens undistort", lsample, torch.eye(3, device=dev),
         HANDHELD_HW, 1.0, lens),
        ("runtime lens canvas", lframes, _canvas_H(pin, 19), (336, 336),
         scale, lens),
        ("runtime k1 probe undistort", lframes[:1].contiguous(),
         torch.eye(3, device=dev), HANDHELD_HW, 1.0, lens),
        ("runtime bow probe rect", lgray,
         homography_dlt(canonical_corners(19, 27, dev), pin), (513, 513),
         scale, lens),
    )
    cases = []
    for path, x, H, hw, sc, ln in shapes:
        H = H.contiguous()
        extra = () if ln is None else (ln,)
        err = _check_warp(x, H, hw, f" ({path})", lens=ln, scale=sc)
        cases.append(_case(
            "warp", f"{tuple(x.shape)} u8 → {hw[0]}×{hw[1]}×{x.shape[-1]}"
            + ("" if ln is None else ", lens"), path,
            lambda x=x, H=H, hw=hw, sc=sc, e=extra:
                warp_kernel.warp_homography(x, H, hw, sc, *e),
            lambda x=x, H=H, hw=hw, sc=sc, e=extra:
                warp_kernel.warp_homography_ref(x, H, hw, sc, *e),
            err, bound_warp(x, hw, lens=ln is not None),
            library=lambda x=x, H=H, hw=hw, sc=sc, ln=ln: grid_sample_case(
                x, H, hw, sc, ln)))

    small = resize_bilinear(rgb_to_gray_u8(sample).float() / 255.0,
                            (256, 256))
    chroma = resize_bilinear((sample[..., 0].float() - sample[..., 2].float())
                             / 255.0, (256, 256))
    cases += _edge_cases(torch.cat([small, chroma]).contiguous(), "runtime",
                         " at N = 8 (runtime)")
    pts, wts = topk_edge_points(edge_map_batch(small))
    pts, wts = pts.contiguous(), wts.contiguous()
    rho_max = float(np.hypot(256, 256))
    cases.append(_case(
        "hough", f"B = {pts.shape[0]}, K = {pts.shape[1]} → 128 × 256",
        "runtime",
        lambda: hough_kernel.hough_accumulate(pts, wts, rho_max, 128, 256),
        lambda: hough_kernel.hough_accumulate_ref(pts, wts, rho_max, 128,
                                                  256),
        _check_hough(pts, wts, rho_max, " at B = 4 (runtime)"),
        bound_hough(pts, wts)))
    return cases


def phase_runtime_times(handheld: dict, lens_run: dict, dev,
                        card: str) -> dict:
    """The runtime's device ops and host waits per batch (steady tracked
    batches after the first anchor, and a periodic re-anchor), counted by
    ``tools/profile_torch.py`` (which also profiles the first anchor), and
    its frames/s: the handheld and lens games through
    ``filecheck.run_runtime`` and the threaded manager over the handheld
    game."""
    from camkifu_tpu_torch import filecheck
    from camkifu_tpu_torch.config import cvconf
    from tools.profile_torch import ops_and_waits

    t0 = time.perf_counter()
    frames = list(handheld["frames"])
    _, vm, _ = _runtime_vm(frames, dev)

    def batch():
        vm.run(max_batches=1)

    batch()                                   # the first anchor
    per = {"steady": [ops_and_waits(batch)
                      for _ in range(RUNTIME_STEADY_PROFILED)]}
    vm.board_finder._since_detect = cvconf.bf_period - 1
    per["re-anchor"] = [ops_and_waits(batch)]
    print(f"runtime host waits and device ops a batch of {RUNTIME_BATCH} x "
          f"{HANDHELD_HW[0]}p on {card}: " + "; ".join(
              f"{k} " + ", ".join(f"{w} waits / {o} ops" for o, w in v)
              for k, v in per.items())
          + f" ({time.perf_counter() - t0:.1f} s)", flush=True)

    t0 = time.perf_counter()
    lens_frames = list(lens_run["frames"])
    runs = {"runtime": [], "lens runtime": [], "threaded": []}
    for _ in range(RUNTIME_REPS):
        runs["runtime"].append(
            filecheck.run_runtime(frames, device=dev)[1]["fps"])
        runs["lens runtime"].append(
            filecheck.run_runtime(lens_frames, device=dev)[1]["fps"])
        runs["threaded"].append(
            len(frames) / _threaded_session(frames, dev)[3])
    runs = {k: sorted(v) for k, v in runs.items()}
    fps = {k: _median(v) for k, v in runs.items()}
    print(f"runtime times on {card}, frames/s median [min, max] of "
          f"{RUNTIME_REPS} calls, host clock, lens calibration at the first "
          f"anchor included: " + ", ".join(
              f"{k} {fps[k]:.1f} [{v[0]:.1f}, {v[-1]:.1f}]"
              for k, v in runs.items())
          + f" ({time.perf_counter() - t0:.1f} s)", flush=True)
    return {"fps": fps, "waits": {k: [w for _, w in v]
                                  for k, v in per.items()}}


def _require_warp_launched(counts: dict, path: str) -> None:
    _require(counts["warp"][0] > 0,
             f"the warp kernel did not run on the {path} path")


def _scored(labels, moves) -> dict:
    """The moves that per-frame ``labels`` diff into, scored against
    ``moves``."""
    from camkifu_tpu_torch.core.gamesync import MoveExtractor, score_moves

    ex = MoveExtractor()
    for lab in labels:
        ex.advance(lab)
    return score_moves(ex.moves, moves)


def _max_rel_param_diff(a, b) -> float:
    """The largest over leaves of max|a − b| / max|b|."""
    return max(float((p.detach().cpu() - q.detach().cpu()).abs().max()
                     / q.detach().cpu().abs().max())
               for p, q in zip(a.parameters(), b.parameters()))


def phase_train(dev, card: str) -> dict:
    """The trainer at ``cktrain``'s defaults on the card: the harvest of 48
    720p boards rendered by ``synth`` on the card (one warp launch a board,
    and one a chunk of 16 to rectify them), 72 AdamW steps of 1,444
    patches, the accuracy gated on the last batch and on 8 boards of
    another seed; the steps timed by CUDA events, the peak device memory,
    and one step on the card against the same step on the CPU."""
    import numpy as np
    import torch

    from camkifu_tpu_torch.core.feeder import to_device
    from camkifu_tpu_torch.models import neural

    t0 = time.perf_counter()
    _reset_counts()
    patches, labels = neural.harvest_patches(
        n_boards=TRAIN_BOARDS, frame_hw=TRAIN_HW, seed=0, device=dev)
    torch.cuda.synchronize()
    t_harvest = time.perf_counter() - t0
    batch = int(np.clip(len(patches) // 12, 256, 2048))
    torch.cuda.reset_peak_memory_stats()
    held_before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    model, acc = neural.train(patches, labels, epochs=TRAIN_EPOCHS,
                              batch=batch)
    t_train = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 20
    own = peak - held_before / 2 ** 20
    counts = _read_counts()
    held_p, held_l = neural.harvest_patches(
        n_boards=TRAIN_HELD_OUT, frame_hw=TRAIN_HW, seed=1, device=dev)
    with torch.no_grad():
        held = float((model(held_p).argmax(-1) == held_l).float().mean())
    steps = TRAIN_EPOCHS * (len(patches) // batch)
    print(f"train: {TRAIN_BOARDS} boards {TRAIN_HW[0]}p → {len(patches)} "
          f"patches in {t_harvest:.2f} s (host clock, render and warp), "
          f"{steps} steps of {batch} in {t_train:.2f} s, accuracy {acc:.4f} "
          f"(last batch), {held:.4f} on {TRAIN_HELD_OUT} boards of another "
          f"seed (bar {TRAIN_ACC}), peak device memory {peak:.1f} MiB "
          f"({own:.1f} MiB above what the run held before), "
          f"launches {counts}", flush=True)
    _require(acc > TRAIN_ACC, "train: accuracy at or below the bar")
    _require(held > TRAIN_ACC, "train: held-out accuracy at or below the bar")
    _require_warp_launched(counts, "train")

    # The same schedule again, each step between CUDA events.
    m = neural.init_params(torch.Generator().manual_seed(0), device=dev)
    opt = neural.make_optimizer(m)
    rng = np.random.default_rng(0)
    events = []
    for _ in range(TRAIN_EPOCHS):
        order = to_device(rng.permutation(len(patches)), dev)
        for i in range(0, len(patches) - batch + 1, batch):
            sel = order[i:i + batch]
            px, ly = patches[sel], labels[sel]
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            ev[0].record()
            neural.train_step(m, opt, px, ly)
            ev[1].record()
            events.append(ev)
    torch.cuda.synchronize()
    ms = sorted(a.elapsed_time(b) for a, b in events[TRAIN_TIMED_FROM:])
    step_ms = _median(ms)

    # One step from the same parameters and batch, card and CPU.
    x, y = patches[:batch], labels[:batch]
    on = {}
    for d in (dev, "cpu"):
        m = neural.init_params(torch.Generator().manual_seed(0), device=d)
        loss, _ = neural.train_step(m, neural.make_optimizer(m), x.to(d),
                                    y.to(d))
        on[str(d)] = (float(loss), m)
    (loss_d, m_d), (loss_c, m_c) = on[str(dev)], on["cpu"]
    print(f"train times on {card}: a step of {batch} {step_ms:.3f} ms "
          f"[{ms[0]:.3f}, {ms[-1]:.3f}] (median [min, max] of the last "
          f"{len(ms)} of {len(events)}, CUDA events) = "
          f"{batch / step_ms * 1e3:.0f} patches/s; one step card against "
          f"CPU: loss {loss_d:.6f} / {loss_c:.6f} (difference "
          f"{abs(loss_d - loss_c):.3g}), largest relative parameter "
          f"difference after it {_max_rel_param_diff(m_d, m_c):.3g}",
          flush=True)
    return {"model": model, "launches": counts, "harvest_s": t_harvest,
            "step_ms": step_ms, "patches_s": batch / step_ms * 1e3,
            "peak_mib": peak, "own_mib": own, "accuracy": acc,
            "held_out": held}


def _margin_clear(model, canon, margin: float):
    """Where the net's top-2 softmax margin on canonical images exceeds
    ``margin`` (..., g, g)."""
    import torch

    from camkifu_tpu_torch.stone.sf_neural import zone_probs

    top2 = torch.sort(zone_probs(model, canon), dim=-1).values[..., -2:]
    return (top2[..., 1] - top2[..., 0]) > margin


def phase_neural(model, handheld: dict, dev, card: str) -> dict:
    """``classify_batch_neural`` with the trained net: 128 1080p copies of
    a board of its own seed through fixed corners, and 16 720p frames of it
    from a slowly drifting camera, each through its own corners
    (``warp_batch_chunked``); every board's agreement gated, the card
    against the CPU, then frames/s at c2's shape. The handheld game's
    frames through their own corners are read and printed, not gated."""
    import numpy as np
    import torch

    from camkifu_tpu_torch.config import cvconf
    from camkifu_tpu_torch.models import neural
    from camkifu_tpu_torch.ops.warp import warp_batch_chunked, \
        warp_batch_fixed
    from camkifu_tpu_torch.stone.sf_neural import classify_batch_neural
    from camkifu_tpu_torch.utils.still import (game_states,
                                                handheld_corners,
                                                render_still)

    board = np.zeros((19, 19), np.int8)
    idx = np.random.default_rng(21).choice(361, 100, replace=False)
    board.flat[idx[:50]], board.flat[idx[50:]] = 1, 2
    frame, corners = render_still(board, frame_hw=FRAME_HW, seed=21)
    frames = torch.from_numpy(frame).to(dev)[None].expand(
        BATCH, *frame.shape).contiguous()
    cs = torch.from_numpy(corners).to(dev)
    slow = handheld_corners(16, HANDHELD_HW, drift=NEURAL_DRIFT)
    hh = torch.from_numpy(np.stack(_render_frames(
        [(board, c, 200 + t) for t, c in enumerate(slow)]))).to(dev)
    hcs = torch.from_numpy(slow).to(dev)
    torch.cuda.synchronize()
    _reset_counts()
    lab, conf = classify_batch_neural(model, frames, cs)
    hlab, hconf = classify_batch_neural(model, hh, hcs)
    torch.cuda.synchronize()
    counts = _read_counts()
    agree = (lab.cpu().numpy() == board).mean(axis=(1, 2))
    hagree = (hlab.cpu().numpy() == board).mean(axis=(1, 2))

    # The handheld game: up to 5.9 px of drift off a chunk's median.
    lo = NEURAL_HANDHELD_FROM
    fpm = cvconf.vote_window + 3
    states = [np.zeros((19, 19), np.int8)] + list(
        game_states(handheld["moves"]))
    gtruth = np.stack([states[max(0, (i - 6) // fpm + 1)]
                       for i in range(lo, lo + 16)])
    glab, _ = classify_batch_neural(
        model, torch.from_numpy(handheld["frames"][lo:lo + 16]).to(dev),
        torch.from_numpy(handheld["truth"][lo:lo + 16]).to(dev))
    gagree = (glab.cpu().numpy() == gtruth).mean(axis=(1, 2))
    print(f"neural, the handheld game's frames {lo}–{lo + 15} through "
          f"their own corners (not gated): agreement per frame "
          f"{np.round(gagree, 4).tolist()}; warp_batch_chunked fades a "
          f"frame more than a pixel off its chunk's median, as the "
          f"reference's does", flush=True)
    # The CPU: two of the copies, and the handheld frames.
    cpu = neural.params_from_jax(neural.params_to_jax(model), "cpu")
    lab_c, conf_c = classify_batch_neural(cpu, frames[:2].cpu(), cs.cpu())
    hlab_c, hconf_c = classify_batch_neural(cpu, hh.cpu(), hcs.cpu())
    clear = _margin_clear(cpu, warp_batch_fixed(
        frames[:2].cpu(), cs.cpu(), scale=1 / 255), NEURAL_MARGIN)
    hclear = _margin_clear(cpu, warp_batch_chunked(
        hh.cpu(), hcs.cpu(), scale=1 / 255), NEURAL_MARGIN)
    same = torch.equal(lab[:2].cpu()[clear], lab_c[clear]) and bool(
        (lab == lab[:1]).all())
    hsame = torch.equal(hlab.cpu()[hclear], hlab_c[hclear])
    d_conf = max(float((conf[:2].cpu() - conf_c).abs().max()),
                 float((hconf.cpu() - hconf_c).abs().max()))
    runs = _cuda_ms_runs(lambda: classify_batch_neural(model, frames, cs),
                         reps=20)
    ms = _median(runs)
    print(f"neural: classify_batch_neural on {BATCH} x {FRAME_HW[0]}p, "
          f"agreement min {agree.min():.4f} (gate {NEURAL_AGREE}); 16 "
          f"{HANDHELD_HW[0]}p frames of a camera drifting {NEURAL_DRIFT} px "
          f"through their own corners, agreement min {hagree.min():.4f}; "
          f"card against CPU labels "
          f"{'equal' if same and hsame else 'DIFFER'} where the margin "
          f"exceeds {NEURAL_MARGIN} ({int(clear.sum()) + int(hclear.sum())}"
          f" of {clear.numel() + hclear.numel()}), confidences within "
          f"{d_conf:.3g}; launches {counts}; times on {card}: {ms:.3f} ms "
          f"[{runs[0]:.3f}, {runs[-1]:.3f}] = {BATCH / ms * 1e3:.1f} "
          f"frames/s (median [min, max] of 20, CUDA events)", flush=True)
    _require(agree.min() >= NEURAL_AGREE and hagree.min() >= NEURAL_AGREE,
             "neural: a board read below the agreement gate")
    _require(same and hsame, "neural: card and CPU labels disagree")
    _require_warp_launched(counts, "neural")
    return {"launches": counts, "fps": BATCH / ms * 1e3}


def _read_game(read, state, frames, corners, dev, batch: int):
    """``read(state, frames, corners, valid_count)`` over a game batch by
    batch, the last padded, every synchronizing call an error from the
    second batch on → (state, the real frames' labels)."""
    import numpy as np
    import torch

    labels = []
    try:
        for i, lo in enumerate(range(0, len(frames), batch)):
            fb = frames[lo:lo + batch]
            n = len(fb)
            vc = None if n == batch else n
            if vc:
                fb = np.concatenate([fb, np.repeat(fb[-1:], batch - n, 0)])
            fb = torch.from_numpy(fb).to(dev)
            torch.cuda.synchronize()
            if i:
                torch.cuda.set_sync_debug_mode("error")
            state, lab, _, _ = read(state, fb, corners, vc)
            torch.cuda.set_sync_debug_mode("default")
            labels.extend(lab.cpu().numpy()[:vc])
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return state, labels


def phase_meta_voter(model, film: dict, dev, card: str) -> dict:
    """SfMeta with the trained net as its third voter over the film game,
    then c3's shape with and without the voter, in turns."""
    import torch

    from camkifu_tpu_torch.stone import sf_meta

    corners = torch.from_numpy(film["corners"]).to(dev)
    _reset_counts()
    _, labels = _read_game(
        lambda st, fb, cs, vc: sf_meta.read_batch(
            st, fb, cs, neural_params=model, valid_count=vc),
        sf_meta.init_state(device=dev), film["frames"], corners, dev,
        FILM_BATCH)
    counts = _read_counts()
    report = _scored(labels, film["moves"])
    c3 = torch.from_numpy(film["frames"])[
        torch.arange(C3_BATCH) % len(film["frames"])].to(dev)
    state0 = sf_meta.init_state(device=dev)
    calls = {"without": lambda: sf_meta.read_batch(state0, c3, corners),
             "with": lambda: sf_meta.read_batch(state0, c3, corners,
                                                neural_params=model)}
    runs = {k: [] for k in calls}
    for k in ("without", "with", "with", "without"):
        runs[k] += _cuda_ms_runs(calls[k], reps=10)
    ms = {k: _median(sorted(v)) for k, v in runs.items()}
    print(f"neural voter: sf_meta.read_batch(neural_params=net) over the "
          f"film game ({len(film['frames'])} x {FILM_HW[0]}p, batches of "
          f"{FILM_BATCH}), {report['good']}/{report['ref_moves']} moves "
          f"right, agreement {report['agreement']}, no host wait from the "
          f"second batch on, launches {counts}; c3 ({C3_BATCH} x "
          f"{FILM_HW[0]}p) on {card}, median of 20 calls in turns: "
          + ", ".join(f"{k} the voter {ms[k]:.3f} ms = "
                      f"{C3_BATCH / ms[k] * 1e3:.1f} frames/s" for k in ms),
          flush=True)
    _require(report["agreement"] == 1.0,
             "neural voter: the film game was misread")
    _require_warp_launched(counts, "neural voter")
    return {"launches": counts,
            "fps": {k: C3_BATCH / v * 1e3 for k, v in ms.items()}}


def phase_bgsub(film: dict, dev, card: str) -> dict:
    """``sf_bgsub.read_batch`` over the film game, the capture-and-removal
    scenario of tests/test_sf_bgsub.py on rendered boards, then frames/s,
    device ops and host waits at c3's shape."""
    import numpy as np
    import torch

    from camkifu_tpu_torch.stone import sf_bgsub
    from camkifu_tpu_torch.utils.still import default_corners, render_still
    from tools.profile_torch import ops_and_waits

    corners = torch.from_numpy(film["corners"]).to(dev)
    _reset_counts()
    _, labels = _read_game(
        lambda st, fb, cs, vc: sf_bgsub.read_batch(st, fb, cs,
                                                   valid_count=vc),
        sf_bgsub.init_state(device=dev), film["frames"], corners, dev,
        FILM_BATCH)
    report = _scored(labels, film["moves"])

    # A white stone placed, captured and taken off the board.
    a = np.zeros((19, 19), np.int8)
    b = a.copy()
    b[9, 9] = 2
    hw = BGSUB_CAPTURE_HW
    frames = np.stack(
        [render_still(a, hw, seed=i)[0] for i in range(6)]
        + [render_still(b, hw, seed=10 + i)[0] for i in range(10)]
        + [render_still(a, hw, seed=30 + i)[0] for i in range(10)])
    cap = torch.from_numpy(default_corners(hw)).to(dev)
    _, outs = _read_game(
        lambda st, fb, cs, vc: sf_bgsub.read_batch(st, fb, cs,
                                                   valid_count=vc),
        sf_bgsub.init_state(device=dev), frames, cap, dev,
        BGSUB_CAPTURE_BATCH)
    counts = _read_counts()
    committed, removed = int(outs[14][9, 9]) == 2, \
        int(outs[-1][9, 9]) == 0 and int(outs[-1].sum()) == 0

    c3 = torch.from_numpy(film["frames"])[
        torch.arange(C3_BATCH) % len(film["frames"])].to(dev)
    state0 = sf_bgsub.init_state(device=dev)

    def call():
        return sf_bgsub.read_batch(state0, c3, corners)

    runs = _cuda_ms_runs(call, reps=20)
    ms = _median(runs)
    ops, waits = ops_and_waits(call)
    print(f"bgsub: sf_bgsub.read_batch over the film game, "
          f"{report['good']}/{report['ref_moves']} moves right, agreement "
          f"{report['agreement']}, no host wait from the second batch on; "
          f"capture scenario at {hw[0]}p: stone "
          f"{'committed' if committed else 'NOT COMMITTED'}, zone "
          f"{'empty' if removed else 'NOT EMPTY'} after removal; launches "
          f"{counts}; c3 ({C3_BATCH} x {FILM_HW[0]}p) on {card}: {ms:.3f} "
          f"ms [{runs[0]:.3f}, {runs[-1]:.3f}] = {C3_BATCH / ms * 1e3:.1f} "
          f"frames/s, {ops} device ops ({ops / C3_BATCH:.1f} a frame), "
          f"{waits} host waits a call", flush=True)
    _require(report["agreement"] == 1.0, "bgsub: the film game was misread")
    _require(committed and removed,
             "bgsub: the captured stone was not committed and removed")
    _require_warp_launched(counts, "bgsub")
    return {"launches": counts, "fps": C3_BATCH / ms * 1e3,
            "ops_a_frame": ops / C3_BATCH, "waits": waits}


def _finder_session(frames, dev, label: str):
    """``filecheck.run_runtime``'s stack with the stones finder chosen by
    ``label`` through the registry → (controller, manager, seconds)."""
    import torch

    from camkifu_tpu_torch.board.bf_auto import BoardFinderAuto
    from camkifu_tpu_torch.core.capture import ArrayCapture
    from camkifu_tpu_torch.core.controllerv import ControllerVSeq
    from camkifu_tpu_torch.core.vmanager import VManagerSeq

    controller = ControllerVSeq()
    vm = VManagerSeq(controller, video=None, bf_class=BoardFinderAuto,
                     batch=RUNTIME_BATCH, device=dev)
    vm.capture = ArrayCapture(list(frames))
    vm.select_sf(label)
    t0 = time.perf_counter()
    vm.run()
    torch.cuda.synchronize()
    return controller, vm, time.perf_counter() - t0


def phase_runtime_finders(model, film: dict, handheld: dict, dev) -> dict:
    """The runtime with this slice's finders: SfBgSub chosen by its label
    over the film game; SfNeural over it with the trained net saved as the
    port's checkpoint in a temporary home directory; SfMeta picking that
    checkpoint up as its third voter over the handheld game."""
    import os
    import tempfile

    from camkifu_tpu_torch.core.gamesync import score_moves
    from camkifu_tpu_torch.models import neural

    t0 = time.perf_counter()
    _reset_counts()
    ctrl, vm, dt = _finder_session(film["frames"], dev, "bgsub")
    bgsub_ok = _moves_of(ctrl.kifu.moves()) == _moves_of(film["moves"])
    kind = type(vm.stones_finder).__name__
    print(f"runtime, select_sf(\"bgsub\") → {kind}: film game "
          f"{'read exactly' if bgsub_ok else 'MISREAD'} "
          f"({len(ctrl.kifu)}/{len(film['moves'])} moves, {dt:.2f} s)",
          flush=True)
    _require(kind == "SfBgSub", "runtime: \"bgsub\" did not resolve")
    _require(bgsub_ok, "runtime: SfBgSub misread the film game")

    home = os.environ.get("HOME")
    with tempfile.TemporaryDirectory() as tmp:
        os.environ["HOME"] = tmp
        try:
            neural.save_params(model, neural.DEFAULT_CKPT)
            ctrl, vm, dt = _finder_session(film["frames"], dev, "neural")
            trained = "train" in vm.stones_finder.metadata
            report = score_moves(ctrl.kifu.moves(), film["moves"])
            print(f"runtime, select_sf(\"neural\") → "
                  f"{type(vm.stones_finder).__name__} with the checkpoint "
                  f"{'NOT LOADED (trained anew)' if trained else 'loaded'}:"
                  f" film game agreement {report['agreement']} "
                  f"({report['good']}/{report['ref_moves']}; not gated: the"
                  f" reference gives SfNeural no vote) ({dt:.2f} s)",
                  flush=True)
            _require(not trained, "runtime: SfNeural did not load the "
                     "checkpoint")
            ctrl, vm, _, dt = _runtime_session(list(handheld["frames"]), dev)
            voter = vm.stones_finder.neural_params is not None
            meta_ok = _moves_of(ctrl.kifu.moves()) == _moves_of(
                handheld["moves"])
        finally:
            if home is None:
                del os.environ["HOME"]
            else:
                os.environ["HOME"] = home
    counts = _read_counts()
    print(f"runtime, SfMeta over the handheld game with the checkpoint: "
          f"voter {'on' if voter else 'OFF'}, "
          f"{'read exactly' if meta_ok else 'MISREAD'}, launches of the "
          f"three sessions {counts} ({dt:.2f} s; phase "
          f"{time.perf_counter() - t0:.1f} s)", flush=True)
    _require(voter, "runtime: SfMeta did not pick up the checkpoint")
    _require(meta_ok, "runtime: SfMeta with the voter misread the handheld "
             "game")
    _require_launched(counts, "finders runtime")
    return {"launches": counts}


def phase_train_kernels(dev) -> list[dict]:
    """The warp at the harvest's shape: a chunk of 16 720p boards, each
    through its own homography (the harvest's perturbed corners)."""
    import numpy as np
    import torch

    from camkifu_tpu_torch.models import neural
    from camkifu_tpu_torch.ops.cuda import warp_kernel
    from camkifu_tpu_torch.ops.warp import canonical_corners, homography_dlt
    from camkifu_tpu_torch.utils import synth

    specs = neural._harvest_specs(neural.HARVEST_CHUNK, TRAIN_HW, 0)
    frames = torch.stack([synth.render_frame(s[0], s[1], TRAIN_HW,
                                             device=dev, **s[2])[0]
                          for s in specs])
    wc = torch.from_numpy(np.stack([s[3] for s in specs])).to(dev)
    H = homography_dlt(canonical_corners(device=dev), wc).contiguous()
    out_hw, scale = (304, 304), 1.0 / 255.0
    err = _check_warp(frames, H, out_hw, " (harvest)")
    return [_case(
        "warp", f"{tuple(frames.shape)} u8, {len(specs)} homographies → "
        f"304²×3", "train harvest",
        lambda: warp_kernel.warp_homography(frames, H, out_hw, scale),
        lambda: warp_kernel.warp_homography_ref(frames, H, out_hw, scale),
        err, bound_warp(frames, out_hw),
        library=lambda: grid_sample_case(frames, H, out_hw, scale))]


def phase_synth(dev, card: str) -> dict:
    """``synth.render_frame`` on the card against the CPU at 720p and
    1080p, each group of options, noise off (corners bitwise, frames within
    SYNTH_TOL_*); the render path's warp launches; ``render_game``'s 720p
    frames/s (host clock, synchronized at the end) with no options, the
    'hard' ones and the t3 ones; a 720p frame's device ops and host
    waits."""
    import numpy as np
    import torch

    from camkifu_tpu_torch.utils import synth
    from tools.profile_torch import ops_and_waits

    t0 = time.perf_counter()
    labels = _labels()
    _reset_counts()
    worst = (0.0, 0.0)
    for hw in SYNTH_HWS:
        for name, kw in SYNTH_GROUPS.items():
            ours, corners = synth.render_frame(labels, frame_hw=hw, noise=0,
                                               seed=2, device=dev, **kw)
            ref, ref_corners = synth.render_frame(labels, frame_hw=hw,
                                                  noise=0, seed=2,
                                                  device="cpu", **kw)
            d = (ours.cpu().to(torch.int64) - ref.to(torch.int64)).abs()
            mean, frac = float(d.float().mean()), float((d > 2).float()
                                                        .mean())
            worst = (max(worst[0], mean), max(worst[1], frac))
            _require(np.array_equal(corners, ref_corners),
                     f"synth: corners of '{name}' at {hw} differ between "
                     f"the card and the CPU")
            _require(ours.shape == (*hw, 3) and ours.dtype == torch.uint8
                     and mean < SYNTH_TOL_MEAN and frac <= SYNTH_TOL_FRAC,
                     f"synth: '{name}' at {hw}: card against CPU mean "
                     f"{mean:.4f} DN, {frac:.2e} of values > 2 DN apart")
    counts = _read_counts()
    _require(counts["warp"][0] == len(SYNTH_HWS) * len(SYNTH_GROUPS),
             f"synth: {counts['warp'][0]} warp launches for "
             f"{len(SYNTH_HWS) * len(SYNTH_GROUPS)} renders on the card")
    print(f"synth: {len(SYNTH_GROUPS)} option groups at "
          f"{', '.join(f'{h}p' for h, _ in SYNTH_HWS)} on the card against "
          f"the CPU: corners bitwise, worst mean {worst[0]:.4f} DN, worst "
          f"share > 2 DN {worst[1]:.2e}; launches {counts}", flush=True)
    moves = synth.sample_moves(SYNTH_GAME_MOVES, seed=7)
    fps = {}
    for name, kw in (("none", {}), ("hard", SYNTH_HARD),
                     ("t3", dict(SYNTH_HARD, glare=0.5, shot_noise=0.4))):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        n = sum(1 for _ in synth.render_game(
            moves, frames_per_move=10, frame_hw=(720, 1280), seed=7,
            empty_leadin=6, device=dev, **kw))
        torch.cuda.synchronize()
        fps[name] = n / (time.perf_counter() - t1)
    def hard_frame(seed):
        return synth.render_frame(labels, frame_hw=(720, 1280), seed=seed,
                                  jitter_seed=7, device=dev, **SYNTH_HARD)

    hard_frame(3)                       # the board's paint, then cached
    ops, waits = ops_and_waits(lambda: hard_frame(4))
    print(f"synth times on {card}: render_game 720p, {n} frames: "
          + ", ".join(f"{k} {v:.1f} frames/s" for k, v in fps.items())
          + f" (host clock); a 'hard' 720p frame of a painted board {ops} "
          f"device ops, {waits} host waits (phase "
          f"{time.perf_counter() - t0:.1f} s)",
          flush=True)
    return {"launches": counts, "fps": fps, "ops": ops, "waits": waits}


def phase_synth_kernels(dev) -> list[dict]:
    """The warp at the render path's shapes: the canonical board padded
    to 458² × 3 u8, through the inverse homography of the default view,
    onto a 720p and a 1080p frame (scale 1: ``synth`` rounds it to u8)."""
    import numpy as np
    import torch

    from camkifu_tpu_torch.ops.cuda import warp_kernel
    from camkifu_tpu_torch.utils import synth

    canon = synth.render_canonical(_labels(), device=dev)
    padded = torch.nn.functional.pad(canon, (0, 0, 1, 1, 1, 1))[None] \
        .contiguous()
    size = canon.shape[0]
    src = np.array([[12, 12], [size - 12, 12], [size - 12, size - 12],
                    [12, size - 12]], np.float32)
    cases = []
    for hw in SYNTH_HWS:
        m = synth._perspective(src, synth.default_corners(hw))
        shift = np.array([[1.0, 0, 1], [0, 1, 1], [0, 0, 1]])
        H = torch.from_numpy((shift @ np.linalg.inv(m)).astype(np.float32)
                             ).to(dev)
        err = _check_warp(padded, H, hw, f" (render {hw[0]}p)", scale=1.0)
        cases.append(_case(
            "warp", f"{tuple(padded.shape)} u8 → {hw[1]}×{hw[0]}×3, scale 1",
            f"synth render {hw[0]}p",
            lambda hw=hw, H=H: warp_kernel.warp_homography(padded, H, hw),
            lambda hw=hw, H=H: warp_kernel.warp_homography_ref(padded, H,
                                                               hw),
            err, bound_warp(padded, hw),
            library=lambda hw=hw, H=H: grid_sample_case(padded, H, hw, 1.0)))
    return cases


def phase_check(dev, card: str) -> dict:
    """``filecheck.check`` on each of CHECK_SPECS on the card, each at the
    reference's PASS bar; frames/s is the harness's own (render, copy,
    read and move extraction)."""
    from camkifu_tpu_torch import filecheck

    t0 = time.perf_counter()
    _reset_counts()
    out = {}
    for spec, sgf in CHECK_SPECS:
        rep = filecheck.check(spec, sgf, device=dev)
        out[spec] = rep
        print(f"check {spec}{' auto' if sgf == 'auto' else ''}: agreement "
              f"{rep['agreement']:.4f}, good {rep['good']}, wrong "
              f"{rep['wrong']}, missing {rep['missing']}, extra "
              f"{rep['extra']} of {rep['ref_moves']}; {rep['frames']} "
              f"frames at {rep['fps']:.1f} frames/s on {card}; diff "
              f"{rep['diff'][:3]}", flush=True)
        _require(rep["agreement"] >= CHECK_BAR,
                 f"check {spec}: agreement {rep['agreement']:.4f} under the "
                 f"reference's PASS bar {CHECK_BAR}")
    counts = _read_counts()
    print(f"check: launches {counts} (phase {time.perf_counter() - t0:.1f} "
          f"s)", flush=True)
    _require_launched(counts, "check")
    return {"launches": counts, "reports": out}


def phase_gauntlet(dev) -> dict:
    """``synth.gauntlet_scenario``'s game and camera without its mp4 round
    trip, rendered on the card, through ``run_runtime(batch=16)``: the
    kifu the reference's runtime reads on the same codec-free scenario
    (GAUNTLET_REFERENCE_SWAP), every move of it, its agreement with the
    truth and its first differing move printed."""
    from itertools import zip_longest

    from camkifu_tpu_torch import filecheck
    from camkifu_tpu_torch.core.gamesync import score_moves
    from camkifu_tpu_torch.utils import synth

    t0 = time.perf_counter()
    _reset_counts()
    moves, factory = synth.gauntlet_scenario(19, seed=11, device=dev)
    frames = [f.cpu().numpy() for f in factory()]
    t_render = time.perf_counter() - t0
    detected, stats = filecheck.run_runtime(frames, batch=16, device=dev)
    counts = _read_counts()
    rep = score_moves(detected, moves)
    first = next(((k, w, g) for k, (w, g) in enumerate(zip_longest(
        _moves_of(moves), _moves_of(detected))) if w != g), None)
    reference = _moves_of(moves)
    i, j = GAUNTLET_REFERENCE_SWAP
    reference[i], reference[j] = reference[j], reference[i]
    print(f"gauntlet (no mp4 round trip): {len(frames)} 720p frames "
          f"rendered in {t_render:.2f} s, runtime {stats['fps']:.1f} "
          f"frames/s; agreement {rep['agreement']:.4f} ({rep['good']}/"
          f"{rep['ref_moves']}, {rep['wrong']} wrong, {rep['missing']} "
          f"missing, {rep['extra']} extra); first differing move "
          f"{first}; the reference's codec-free reading (moves {i + 1} and "
          f"{j + 1} swapped) {'matched' if _moves_of(detected) == reference else 'NOT MATCHED'}"
          f"; launches {counts}", flush=True)
    _require(_moves_of(detected) == reference,
             "gauntlet: the kifu is not the reference's codec-free reading")
    _require_launched(counts, "gauntlet")
    return {"launches": counts, "fps": stats["fps"], "render_s": t_render,
            "frames": len(frames)}


def phase_live(dev, card: str) -> dict:
    """``utils.latency.measure_live_latency`` on the card: a paced camera
    at LIVE_FPS into ``LiveCapture`` and the threaded ``VManager``, gated
    as ``tests/test_live_latency.py``: every move detected, every latency
    past 0.8 × the vote-commit floor."""
    from camkifu_tpu_torch.utils.latency import measure_live_latency

    t0 = time.perf_counter()
    _reset_counts()
    rep = measure_live_latency(n_moves=LIVE_MOVES, fps=LIVE_FPS,
                               frame_hw=LIVE_HW, batch=LIVE_BATCH, seed=3,
                               timeout_s=180.0, device=dev)
    counts = _read_counts()
    print(f"live on {card}: {LIVE_HW[0]}p at {LIVE_FPS} frames/s, batch "
          f"{LIVE_BATCH}: detected {rep['detected']}/{rep['expected']}, "
          f"frame→SGF p50 {rep.get('p50_s')} s, p99 {rep.get('p99_s')} s "
          f"(of {len(rep['latencies_s'])} moves: about the largest) "
          f"(floors: batch fill {rep['floor_batch_fill_s']} s, vote commit "
          f"{rep['floor_vote_commit_s']} s), latencies {rep['latencies_s']}"
          f", warm-up {rep['warmup_s']} s; launches {counts} (phase "
          f"{time.perf_counter() - t0:.1f} s)", flush=True)
    _require(rep["detected"] == rep["expected"],
             "live: not every move was detected")
    floor = rep["floor_vote_commit_s"]
    _require(all(v > floor * 0.8 for v in rep["latencies_s"]),
             "live: a latency under 0.8 × the vote-commit floor")
    _require_launched(counts, "live")
    return {"launches": counts, "report": rep}


SOURCES = {
    "warp": ("camkifu_tpu_torch/csrc/warp.cu",
             "camkifu_tpu/ops/pallas/warp_kernel.py:122"),
    "edge": ("camkifu_tpu_torch/csrc/edge.cu",
             "camkifu_tpu/ops/pallas/edge_kernel.py:111 and :125"),
    "hough": ("camkifu_tpu_torch/csrc/hough.cu",
              "camkifu_tpu/ops/pallas/hough_kernel.py:67"),
    "hysteresis": ("camkifu_tpu_torch/csrc/hysteresis.cu",
                   "camkifu_tpu/ops/edges.py:50 hysteresis (XLA ops, no "
                   "Pallas kernel)"),
}


NUMBERS = ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by", "share",
           "err", "paced_ms")


def _numbers_only(case: dict) -> dict:
    """A timed case without its calls (which hold device tensors)."""
    return {k: v for k, v in case.items()
            if k in NUMBERS + ("name", "shape", "path", "main")}


def _kernel_entry(name: str, source: str, replaces: str, cases: list[dict],
                  paths: dict) -> dict:
    """A kernel's entry in the kernels line: the contract's keys from the
    still path's shape, then every path shape's numbers under
    ``shapes``."""
    mine = [c for c in cases if c["name"] == name]
    main = next(c for c in mine if c["main"])
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": sum(paths[p][name][0] for p in paths),
            "launches_per_path": {p: paths[p][name][0] for p in paths},
            "max_abs_err": max(c["err"] for c in mine),
            **{k: main[k] for k in ("ms", "plain_ms", "bound_ms",
                                    "bound_by", "share", "library_ms")},
            "shapes": [{k: c[k] for k in ("shape", "path") + NUMBERS
                        if k in c} for c in mine]}


def run_phases(dev, card: str) -> dict:
    """Every phase on ``dev`` after the build; raises SmokeFailure."""
    import torch

    from camkifu_tpu_torch.utils.still import render_still

    labels = _labels()
    frame, corners_true = render_still(labels, frame_hw=FRAME_HW, seed=0)
    frames = torch.from_numpy(frame).to(dev)[None].expand(
        BATCH, *frame.shape).contiguous()
    torch.cuda.synchronize()
    print(f"input: {tuple(frames.shape)} uint8 on {dev}", flush=True)
    corners_dev = torch.from_numpy(corners_true).to(dev)
    cases = phase_kernels(frames, corners_dev)
    run = phase_main_path(frames, corners_true, labels)
    t = phase_times(frames, run["corners"], card)
    t0 = time.perf_counter()
    phase_kernel_times(cases, card)
    print(f"still kernel times {time.perf_counter() - t0:.1f} s", flush=True)
    cases = [_numbers_only(c) for c in cases]
    del frames
    t0 = time.perf_counter()
    film = phase_film(dev)
    print(f"film phase {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    redetect = phase_redetect(dev)
    batch_cases = phase_batch_kernels(redetect, film, dev)
    print(f"redetect phase {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    handheld = phase_handheld(dev)
    batch_cases += phase_handheld_kernels(redetect)
    print(f"handheld phase {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    phase_kernel_times(batch_cases, card)
    print(f"batch kernel times {time.perf_counter() - t0:.1f} s", flush=True)
    cases += [_numbers_only(c) for c in batch_cases]
    del batch_cases
    t0 = time.perf_counter()
    tf = phase_film_times(film, redetect, dev, card)
    print(f"film and redetect times {time.perf_counter() - t0:.1f} s",
          flush=True)
    t0 = time.perf_counter()
    th = phase_handheld_times(redetect, card)
    print(f"handheld times {time.perf_counter() - t0:.1f} s", flush=True)
    paths = {"still": run["launches"], "film": film["launches"],
             "redetect": redetect["launches"],
             "handheld": handheld["launches"]}
    del redetect
    t0 = time.perf_counter()
    sizes = phase_sizes(dev, card)
    print(f"sizes phase {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    paths["multi-stream"] = phase_multistream(film, handheld, dev)["launches"]
    game = {k: handheld[k] for k in ("frames", "moves", "truth")}
    film_game = {k: film[k] for k in ("frames", "corners", "moves")}
    del film, handheld
    print(f"multi-stream phase {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    c5 = phase_c5(dev, card)
    tm = phase_multistream_times(c5, th["ms"]["track_read"], card)
    print(f"c5 phase {time.perf_counter() - t0:.1f} s", flush=True)
    paths["sizes"], paths["c5"] = sizes["launches"], c5["launches"]
    new_cases = sizes["cases"] + c5["cases"] + tm["cases"]
    c5_fps = c5["fps"]
    del c5
    t0 = time.perf_counter()
    phase_kernel_times(new_cases, card)
    print(f"new warp shapes' times {time.perf_counter() - t0:.1f} s",
          flush=True)
    cases += [_numbers_only(c) for c in new_cases]
    del new_cases
    t0 = time.perf_counter()
    lens_run = phase_lens(dev)
    lens_ms = phase_lens_multistream(lens_run, dev)
    lens_cases = phase_lens_kernels(lens_run, dev)
    tl = phase_lens_times(lens_run, card)
    paths["lens"], paths["lens multi-stream"] = (lens_run["launches"],
                                                 lens_ms["launches"])
    lens_warps = {"lens": lens_run["lens_launches"],
                  "lens multi-stream": lens_ms["lens_launches"]}
    lens_game = {k: lens_run[k] for k in ("frames", "moves", "truth")}
    del lens_run
    phase_kernel_times(lens_cases, card)
    cases += [_numbers_only(c) for c in lens_cases]
    del lens_cases
    print(f"lens phase {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    runtime = phase_runtime(game, lens_game, dev)
    runtime_cases = phase_runtime_kernels(game, lens_game, dev)
    phase_kernel_times(runtime_cases, card)
    cases += [_numbers_only(c) for c in runtime_cases]
    del runtime_cases
    tr = phase_runtime_times(game, lens_game, dev, card)
    paths["runtime"] = runtime["launches"]
    lens_warps["runtime"] = runtime["lens_launches"]
    print(f"runtime phase {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    trn = phase_train(dev, card)
    net = trn.pop("model")
    tn = phase_neural(net, game, dev, card)
    tv = phase_meta_voter(net, film_game, dev, card)
    tb = phase_bgsub(film_game, dev, card)
    paths.update({"train": trn["launches"], "neural": tn["launches"],
                  "neural voter": tv["launches"], "bgsub": tb["launches"],
                  "finders runtime": phase_runtime_finders(
                      net, film_game, game, dev)["launches"]})
    train_cases = phase_train_kernels(dev)
    phase_kernel_times(train_cases, card)
    warp_s = train_cases[0]["ms"] * trn["launches"]["warp"][0] / 1e3
    print(f"train harvest: the rectifying warp's share of its "
          f"{trn['harvest_s']:.2f} host seconds "
          f"{warp_s / trn['harvest_s']:.2e} (at most "
          f"{trn['launches']['warp'][0]} launches of "
          f"{train_cases[0]['ms']:.4f} ms, the renders' own included)",
          flush=True)
    cases += [_numbers_only(c) for c in train_cases]
    del train_cases, net
    print(f"finders and trainer phases {time.perf_counter() - t0:.1f} s",
          flush=True)
    t0 = time.perf_counter()
    ts = phase_synth(dev, card)
    synth_cases = phase_synth_kernels(dev)
    phase_kernel_times(synth_cases, card)
    cases += [_numbers_only(c) for c in synth_cases]
    del synth_cases
    tc = phase_check(dev, card)
    tg = phase_gauntlet(dev)
    tlv = phase_live(dev, card)
    paths.update({"synth": ts["launches"], "check": tc["launches"],
                  "gauntlet": tg["launches"], "live": tlv["launches"]})
    print(f"synth, check, gauntlet and live phases "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    kernels = [_kernel_entry(name, source, replaces, cases, paths)
               for name, (source, replaces) in SOURCES.items()]
    kernels[0]["lens_launches_per_path"] = lens_warps
    return {"kernels": kernels,
            "summary": {"c1_ms": t["c1_ms"],
                        "c2_fps": BATCH / t["c2_ms"] * 1e3,
                        "c3_fps": tf["fps"]["c3"],
                        "redetect_fps": tf["fps"]["redetect"],
                        "film_fps": tf["fps"]["film"],
                        "c4_fps": th["fps"]["c4"],
                        "c4_track_read_fps": th["fps"]["track_read"],
                        "c4_unfused_fps": th["fps"]["unfused"],
                        **{f"c1_ms_at_{g}": sizes["ms"][f"c1 at {g}"]
                           for g in SIZES},
                        **{f"c2_fps_at_{g}":
                           BATCH / sizes["ms"][f"c2 at {g}"] * 1e3
                           for g in SIZES},
                        "infer_gsize_ms": sizes["ms"]["infer_gsize"],
                        "c5_fps": c5_fps,
                        "multistream_track_fps": tm["fps"],
                        "c4_track_read_lens_ms": tl["ms"]["track_read lens"],
                        "c4_track_read_no_lens_ms":
                            tl["ms"]["track_read no lens"],
                        "estimate_lens_k1_ms": tl["ms"]["estimate_lens_k1"],
                        "estimate_lens_k1_corners_ms":
                            tl["ms"]["estimate_lens_k1_corners"],
                        "runtime_fps": tr["fps"]["runtime"],
                        "runtime_lens_fps": tr["fps"]["lens runtime"],
                        "runtime_threaded_fps": tr["fps"]["threaded"],
                        "runtime_host_waits": tr["waits"],
                        "train_harvest_s": trn["harvest_s"],
                        "train_step_ms": trn["step_ms"],
                        "train_patches_s": trn["patches_s"],
                        "train_peak_mib": trn["peak_mib"],
                        "train_own_mib": trn["own_mib"],
                        "train_accuracy": trn["accuracy"],
                        "train_held_out_accuracy": trn["held_out"],
                        "neural_c2_fps": tn["fps"],
                        "c3_fps_without_voter": tv["fps"]["without"],
                        "c3_fps_with_voter": tv["fps"]["with"],
                        "bgsub_c3_fps": tb["fps"],
                        "bgsub_ops_a_frame": tb["ops_a_frame"],
                        "bgsub_host_waits": tb["waits"],
                        "synth_game_fps_720p": ts["fps"],
                        "synth_ops_a_frame": ts["ops"],
                        "check_fps": {k: v["fps"]
                                      for k, v in tc["reports"].items()},
                        "gauntlet_runtime_fps": tg["fps"],
                        "live_p50_s": tlv["report"].get("p50_s"),
                        "live_p99_s": tlv["report"].get("p99_s"),
                        "live_floor_batch_fill_s":
                            tlv["report"]["floor_batch_fill_s"],
                        "live_floor_vote_commit_s":
                            tlv["report"]["floor_vote_commit_s"]}}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this run "
              "needs a CUDA device", file=sys.stderr)
        return 1

    from camkifu_tpu_torch.ops.cuda import _build

    card = _card_line()
    print(card, flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}, "
          f"tf32 matmul {torch.backends.cuda.matmul.allow_tf32}, "
          f"tf32 cudnn {torch.backends.cudnn.allow_tf32}", flush=True)
    try:
        phase_build(_build)
        result = run_phases(torch.device("cuda", 0), card)
    except SmokeFailure as exc:
        print(f"FAIL: {exc}", flush=True)
        return 1
    print(f"peak device memory {torch.cuda.max_memory_allocated() / 2**20:.1f}"
          f" MiB", flush=True)
    print(json.dumps(result["summary"]), flush=True)
    print(card, flush=True)
    print(json.dumps({"kernels": result["kernels"]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
