#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``camkifu_tpu_torch/csrc`` (nvcc,
sm_90a, one process per source), holds each kernel against its plain
PyTorch version at the shapes the paths give it, then drives three paths
once each, counting kernel launches per path:

- the still path: one board detection on a 1080p still
  (``board.bf_auto.detect_corners``) and stone classification of 128
  copies of it (``pipeline.read_board_batch``);
- the recorded-video path: a seeded 10-move game from a fixed camera at
  720p through ``filecheck.run_pipeline`` with automatic board detection
  (``detect_batch_stable``, then the ``sf_meta`` vote scan) to its moves;
- the full redetect: ``detect_batch`` on 64 drifting 1080p frames.

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
EDGE_ATOL = 1e-4           # where both versions fire
EDGE_SUPPORT = 0.995       # intersection over union of the NMS supports
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
#: two weighted taps 2, two adds 2).
WARP_OPS_PX = 16
WARP_OPS_VALUE = 11
EDGE_OPS_PX = 55
HOUGH_OPS_PAIR = 12
#: Calls per kernel time: the kernel, its plain version, the library call.
KERNEL_REPS = 20
PLAIN_REPS = 3
LIBRARY_REPS = 5
#: Split counts the Hough kernel is also timed at, beside the one its
#: wrapper picks (``hough_kernel.auto_splits``).
HOUGH_SPLITS = (1, 2, 4, 8, 16, 32)

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


def bound_warp(frames, out_hw: tuple[int, int]) -> tuple[float, str]:
    """float32 output written once, and four C-byte taps an output pixel
    (no more than the frames hold)."""
    b, _, _, c = frames.shape
    px = b * out_hw[0] * out_hw[1]
    taps = min(4 * c * px, frames.numel() * frames.element_size())
    return _bound(4 * c * px + taps, px * (WARP_OPS_PX + c * WARP_OPS_VALUE))


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


def grid_sample_case(frames, H, out_hw: tuple[int, int], scale: float):
    """The library yardstick of the warp: ``F.grid_sample`` (bilinear,
    border padding, align_corners) on the frames as float32 NCHW, through
    a normalised grid built from ``H`` beforehand; returns the call. The
    float copy and the grid are made here, outside any timed window."""
    import torch
    import torch.nn.functional as F

    b, h, w, _ = frames.shape
    oh, ow = out_hw
    dev = frames.device
    v = torch.arange(oh, dtype=torch.float32, device=dev)[:, None]
    u = torch.arange(ow, dtype=torch.float32, device=dev)[None, :]
    den = H[2, 0] * u + H[2, 1] * v + H[2, 2]
    x = (H[0, 0] * u + H[0, 1] * v + H[0, 2]) / den
    y = (H[1, 0] * u + H[1, 1] * v + H[1, 2]) / den
    grid = torch.stack([x / (w - 1) * 2 - 1, y / (h - 1) * 2 - 1], dim=-1)
    grid = grid[None].expand(b, oh, ow, 2).contiguous()
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
        warp_kernel

    return {"warp": warp_kernel, "edge": edge_kernel, "hough": hough_kernel}


def _reset_counts() -> None:
    for m in _kernel_modules().values():
        m.launches = 0
        if hasattr(m, "sizes"):
            m.sizes.clear()


def _read_counts() -> dict:
    """{kernel: (launches, {batch size: launches})} since the reset."""
    return {k: (m.launches, dict(getattr(m, "sizes", {})))
            for k, m in _kernel_modules().items()}


def _require_launched(counts: dict, path: str) -> None:
    for name, (n, _) in counts.items():
        _require(n > 0, f"the {name} kernel did not run on the {path} path")


def phase_build(_build) -> None:
    t0 = time.perf_counter()
    path, compile_s, log = _build.build()
    _build.lib()
    print(f"build: {path.name} compiled in {compile_s:.2f} s "
          f"(ready in {time.perf_counter() - t0:.2f} s)", flush=True)
    for line in log.splitlines():
        if any(key in line for key in ("registers", "spill", "Compiling")):
            print(f"  ptxas: {line.strip()}", flush=True)


def _check_warp(frames, H, out_hw: tuple[int, int], label: str) -> float:
    """The warp kernel against its plain version on u8 ``frames``
    (B, H, W, C) through one homography, in [0, 1] scale: bitwise equal.
    Returns the largest difference."""
    import torch

    from camkifu_tpu_torch.ops.cuda import warp_kernel

    H = H.contiguous()
    a = warp_kernel.warp_homography(frames, H, out_hw, 1.0 / 255.0)
    b = warp_kernel.warp_homography_ref(frames, H, out_hw, 1.0 / 255.0)
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
    equal where both fire, the same NMS support, a zero border band.
    Returns the largest difference."""
    import torch

    from camkifu_tpu_torch.ops.cuda import edge_kernel
    from camkifu_tpu_torch.ops.cuda.edge_kernel import BORDER

    a = edge_kernel.edge_magnitude(x)
    b = edge_kernel.edge_magnitude_ref(x)
    torch.cuda.synchronize()
    inner = (slice(None), slice(BORDER, -BORDER), slice(BORDER, -BORDER))
    sa, sb = a[inner] > 0, b[inner] > 0
    both = sa & sb
    iou = float(both.sum()) / max(float((sa | sb).sum()), 1.0)
    err = float((a[inner] - b[inner])[both].abs().max())
    band = a.clone()
    band[inner] = 0
    print(f"kernel edge{label}: max|kernel - plain| = {err:.3g} where both "
          f"fire (atol {EDGE_ATOL}), support IoU {iou:.5f}, band max "
          f"{float(band.abs().max())}", flush=True)
    _require(err <= EDGE_ATOL, f"edge kernel{label} disagrees")
    _require(iou >= EDGE_SUPPORT, f"edge kernel{label} NMS support disagrees")
    _require(float(band.abs().max()) == 0.0,
             f"edge kernel{label} band is not 0")
    return err


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
    from camkifu_tpu_torch.ops.cuda import edge_kernel, hough_kernel, \
        warp_kernel
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
    cases.append(_case(
        "edge", f"N = {x.shape[0]}, 256²", "still",
        lambda: edge_kernel.edge_magnitude(x),
        lambda: edge_kernel.edge_magnitude_ref(x),
        _check_edge(x, ""), bound_edge(x), main=True))

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
    return {"frames": frames, "corners": corners, "launches": counts}


def _drift_frames(dev):
    """``REDETECT_RENDERS`` 1080p stills whose corners drift ±3 px (as
    tests/test_detect_shared.py makes them), tiled to ``REDETECT_BATCH``
    frames on the card, and each frame's true corners."""
    import numpy as np
    import torch

    from camkifu_tpu_torch.utils.still import default_corners, render_still

    labels = np.zeros((19, 19), np.int8)
    idx = np.random.default_rng(1).choice(361, 40, replace=False)
    labels.flat[idx[::2]] = 1
    labels.flat[idx[1::2]] = 2
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
    return {"frames": frames, "launches": counts, "grays": grays,
            "quads": quads}


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
    from camkifu_tpu_torch.ops.cuda import edge_kernel, hough_kernel, \
        warp_kernel
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
        x = x.contiguous()
        cases.append(_case(
            "edge", f"N = {x.shape[0]}, 256²", path,
            lambda x=x: edge_kernel.edge_magnitude(x),
            lambda x=x: edge_kernel.edge_magnitude_ref(x),
            _check_edge(x, f" at N = {x.shape[0]}"), bound_edge(x)))

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


SOURCES = {
    "warp": ("camkifu_tpu_torch/csrc/warp.cu",
             "camkifu_tpu/ops/pallas/warp_kernel.py:122"),
    "edge": ("camkifu_tpu_torch/csrc/edge.cu",
             "camkifu_tpu/ops/pallas/edge_kernel.py:111 and :125"),
    "hough": ("camkifu_tpu_torch/csrc/hough.cu",
              "camkifu_tpu/ops/pallas/hough_kernel.py:67"),
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
    phase_kernel_times(batch_cases, card)
    print(f"batch kernel times {time.perf_counter() - t0:.1f} s", flush=True)
    cases += [_numbers_only(c) for c in batch_cases]
    del batch_cases
    t0 = time.perf_counter()
    tf = phase_film_times(film, redetect, dev, card)
    print(f"film and redetect times {time.perf_counter() - t0:.1f} s",
          flush=True)
    paths = {"still": run["launches"], "film": film["launches"],
             "redetect": redetect["launches"]}
    return {"kernels": [_kernel_entry(name, source, replaces, cases, paths)
                        for name, (source, replaces) in SOURCES.items()],
            "summary": {"c1_ms": t["c1_ms"],
                        "c2_fps": BATCH / t["c2_ms"] * 1e3,
                        "c3_fps": tf["fps"]["c3"],
                        "redetect_fps": tf["fps"]["redetect"],
                        "film_fps": tf["fps"]["film"]}}


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
